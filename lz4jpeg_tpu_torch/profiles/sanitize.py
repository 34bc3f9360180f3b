"""``compute-sanitizer`` on the matcher sort and the membership decode.

    python -m lz4jpeg_tpu_torch.profiles.sanitize [--output F.json]

Each kernel source is compiled together with a small checker (a ``main``
appended to ``#include`` of the source, no PyTorch) that fills device
buffers from a fixed seed, launches through the source's own C entry point
and checks the result on the host: the sort (``csrc/bitonic_sort_kernel.cu``,
both variants) on 1 and 3 blocks, keys ascending and, with the replay, the
payload back at its input; the membership decode
(``csrc/rle_membership_kernel.cu``, L 64 and 32) on 37 rows against a host
decode.  Every case then runs under ``compute-sanitizer --tool racecheck``
and ``--tool synccheck`` (shared-memory hazards; barriers and warp
synchronisation misused).  Needs the CUDA toolkit and a card; prints one
line a case and tool and returns nonzero if a tool reports an error or a
checker's check fails.  Where the tool cannot run a program at all (it
says the device is not supported, or under it the checker's device
set-up, its first allocations and copies, fails, while it passes alone),
the case reads "unavailable", not as a failure; a launch that fails only
under a tool is a hazard.  Each record keeps the
checker's own lines and the tool's first error lines.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
TOOLS = ("racecheck", "synccheck")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")

_COMMON = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>

static uint32_t next_random(uint32_t& x) {
  x = x * 1664525u + 1013904223u;
  return x >> 8;
}

#define CHECK(stage, call)                                            \
  do {                                                                \
    cudaError_t e_ = (call);                                          \
    if (e_ != cudaSuccess) {                                          \
      std::printf("%s failed: %s at %d\n", stage,                     \
                  cudaGetErrorString(e_), __LINE__);                  \
      return 2;                                                       \
    }                                                                 \
  } while (0)
"""

SORT_CHECKER = _COMMON + r"""
// argv: blocks, record.  Keys with duplicates (mod 4099) and a payload of
// slot numbers; checks each block's keys ascending, the payload a
// permutation that keeps (key, payload) pairs (sort) or the input (replay).
int main(int argc, char** argv) {
  const int blocks = std::atoi(argv[1]);
  const int record = std::atoi(argv[2]);
  const size_t n = static_cast<size_t>(blocks) * kSlots;
  std::vector<int32_t> k(n), p(n), ok(n), op(n);
  uint32_t x = 20u;
  for (size_t i = 0; i < n; ++i) {
    k[i] = static_cast<int32_t>(next_random(x) % 4099u) - 2000;
    p[i] = static_cast<int32_t>(i);
  }
  int32_t *dk, *dp, *dok, *dop;
  CHECK("setup", cudaMalloc(&dk, n * 4));
  CHECK("setup", cudaMalloc(&dp, n * 4));
  CHECK("setup", cudaMalloc(&dok, n * 4));
  CHECK("setup", cudaMalloc(&dop, n * 4));
  CHECK("setup", cudaMemcpy(dk, k.data(), n * 4, cudaMemcpyHostToDevice));
  CHECK("setup", cudaMemcpy(dp, p.data(), n * 4, cudaMemcpyHostToDevice));
  CHECK("launch", static_cast<cudaError_t>(
      bitonic_sort_launch(dk, dp, dok, dop, blocks, record, nullptr)));
  CHECK("launch", cudaDeviceSynchronize());
  CHECK("launch", cudaMemcpy(ok.data(), dok, n * 4, cudaMemcpyDeviceToHost));
  CHECK("launch", cudaMemcpy(op.data(), dop, n * 4, cudaMemcpyDeviceToHost));
  for (size_t i = 0; i < n; ++i) {
    const bool first = i % kSlots == 0;
    if (!first && ok[i - 1] > ok[i]) { std::printf("unsorted at %zu\n", i); return 1; }
    if (record ? op[i] != p[i] : ok[i] != k[op[i]]) {
      std::printf("payload wrong at %zu\n", i);
      return 1;
    }
  }
  std::printf("sort blocks %d record %d: checked\n", blocks, record);
  return 0;
}
"""

MEMBERSHIP_CHECKER = _COMMON + r"""
// argv: L, rows.  Random words and lengths in [-2, 2L + 2]; checks every
// output against a host decode.
int main(int argc, char** argv) {
  const int seg = std::atoi(argv[1]);
  const long long rows = std::atoll(argv[2]);
  std::vector<uint16_t> w(rows * seg);
  std::vector<int32_t> len(rows), out(rows * seg);
  uint32_t x = 24u;
  for (auto& v : w) v = static_cast<uint16_t>(next_random(x));
  for (auto& v : len) v = static_cast<int32_t>(next_random(x) % (2 * seg + 5)) - 2;
  uint16_t* dw;
  int32_t *dl, *dout;
  CHECK("setup", cudaMalloc(&dw, w.size() * 2));
  CHECK("setup", cudaMalloc(&dl, len.size() * 4));
  CHECK("setup", cudaMalloc(&dout, out.size() * 4));
  CHECK("setup", cudaMemcpy(dw, w.data(), w.size() * 2, cudaMemcpyHostToDevice));
  CHECK("setup", cudaMemcpy(dl, len.data(), len.size() * 4, cudaMemcpyHostToDevice));
  CHECK("launch", static_cast<cudaError_t>(
      rle_membership_launch(dw, dl, dout, rows, seg, seg, nullptr)));
  CHECK("launch", cudaDeviceSynchronize());
  CHECK("launch", cudaMemcpy(out.data(), dout, out.size() * 4, cudaMemcpyDeviceToHost));
  for (long long r = 0; r < rows; ++r) {
    std::vector<int32_t> want(seg, 0);
    const long long pairs = len[r] >> 1;
    int at = 0;
    for (int s = 0; s < seg && s < pairs; ++s) {
      const int word = w[r * seg + s];
      for (int c = 0; c <= (word >> 10) && at < seg; ++c)
        want[at++] = (word & 0x3ff) - 512;
    }
    for (int q = 0; q < seg; ++q)
      if (out[r * seg + q] != want[q]) {
        std::printf("row %lld position %d: %d, want %d\n", r, q,
                    out[r * seg + q], want[q]);
        return 1;
      }
  }
  std::printf("membership L %d rows %lld: checked\n", seg, rows);
  return 0;
}
"""

CASES = {
    "bitonic_sort_kernel": (SORT_CHECKER, [["1", "0"], ["3", "0"], ["1", "1"],
                                          ["3", "1"]]),
    "rle_membership_kernel": (MEMBERSHIP_CHECKER, [["64", "37"], ["32", "37"]]),
}


def tool(name: str) -> str:
    return shutil.which(name) or f"/usr/local/cuda/bin/{name}"


def build_checker(source: str, checker: str, work: Path) -> Path:
    """``csrc/{source}.cu`` with ``checker`` appended, compiled to an
    executable in ``work``."""
    src = work / f"{source}_checker.cu"
    src.write_text(f'#include "{CSRC / source}.cu"\n' + checker)
    exe = work / f"{source}_checker"
    subprocess.run([tool("nvcc"), *FLAGS, "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True)
    return exe


# The tool's own line where it cannot run a program on the card at all.
UNSUPPORTED = "Error: Device not supported"


def verdict(tool_name: Optional[str], out: str, rc: int) -> str:
    """"clean": the checker's check passed and the tool (if any) counted no
    error; "unavailable": under a tool the checker's set-up failed (its
    "setup failed" line) or the tool said it does not support the device,
    and the checker neither launched and failed nor passed its check;
    "hazard": anything else, a launch that failed under the tool
    included."""
    if (tool_name is not None
            and ("setup failed" in out or UNSUPPORTED in out)
            and "launch failed" not in out and "checked" not in out):
        return "unavailable"
    return "clean" if rc == 0 and "checked" in out else "hazard"


def evidence(out: str, tool_lines: int = 4) -> List[str]:
    """The checker's own lines (its failure or its "checked" line) and the
    tool's first ``tool_lines`` lines, which name the error it caught."""
    lines = [line.rstrip() for line in out.splitlines() if line.strip()]
    own = [line for line in lines if not line.startswith("=========")]
    return own[-3:] + [line for line in lines
                       if line.startswith("=========")][:tool_lines]


def sanitize(timeout: float = 600.0) -> Dict[str, List[Dict]]:
    """Every case run plain and under each tool; {source: [{args, tool, rc,
    verdict, tail}]} (see ``verdict``)."""
    found: Dict[str, List[Dict]] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for source, (checker, cases) in CASES.items():
            exe = build_checker(source, checker, Path(tmp))
            for args in cases:
                for name in (None, *TOOLS):
                    argv = ([] if name is None else
                            [tool("compute-sanitizer"), "--tool", name,
                             "--error-exitcode", "3"]) + [str(exe), *args]
                    proc = subprocess.run(argv, capture_output=True,
                                          text=True, timeout=timeout)
                    out = proc.stdout + proc.stderr
                    found.setdefault(source, []).append({
                        "args": args, "tool": name or "plain",
                        "rc": proc.returncode,
                        "verdict": verdict(name, out, proc.returncode),
                        "tail": evidence(out),
                    })
                    print(f"{source} {' '.join(args)} {name or 'plain'}: "
                          f"{found[source][-1]['verdict']} (rc "
                          f"{proc.returncode}); "
                          + " | ".join(found[source][-1]["tail"]), flush=True)
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--output", help="write the results as JSON here")
    args = ap.parse_args(argv)
    found = sanitize()
    if args.output:
        Path(args.output).write_text(json.dumps(found, indent=1))
    bad = [r for rs in found.values() for r in rs if r["verdict"] == "hazard"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
