"""The LZ4T one-hot gathers on the card: the run of the four TPU probes
``profiles/probe_lz4t_mxu_gather{,2,3,4}.py``.

The probes encode 4 MiB of text with the fast codec's native engine (64
KiB blocks), build the fully rooted copy program
(``build_copy_program_fast(frame, depth_cap=1)``; roots are the sources,
literals rooted at themselves), and resolve it as a one-hot product on the
matrix unit.  Their corpus (the reference's ``Metamorphosis.txt``) is
absent, so this run takes ``corpus`` bytes, by default
``utils/inputs.py::generate_text(text_bytes)`` from ``seed``: 64 blocks of
65,536 (C = 512) at the default size.  A caller may pass ``frame``, the
corpus already encoded (the tests give it 16 KiB blocks to stay small).

Every one of the ten rows of ``profiles/onehot_gather.py::ROWS`` (g1; g2
full, nomask, hbuild; g3 T = 512, 1024, 2048; g4 (32, bf16), (32, i8),
(16, i8)) is held to its plain version (the dense product in float64), and
every full row to ``torch.gather`` of the literals at the roots and, with
the rows trimmed to the blocks' sizes, to the input text.  Then each row is
timed as the probe timed it (its torch code around the kernel included:
the literal operand's cast or transpose, g2's transposes, the uint8 cast),
beside the kernel alone (``kernel_ms``: on the operand and the roots
prepared before, ``onehot_gather_prepared``; on the card only) and its
plain version, and, as the probe's own comparisons (:133-144),
the rooted-resolve kernel K3 (``ops/lz4t_decode.py::resolve_rooted``),
``torch.gather`` on int64 roots (the library call) and the pointer doubling
``resolve_blocks`` of the program at ``depth_cap=4``.  Times:
``profiles/timing.py`` (the plain version one call a run); bounds:
``onehot_gather.row_bound``.  Run on the card from the repository root (on
the CPU add ``--device cpu --text-bytes 20000``: one 64 KiB block)::

    python -m lz4jpeg_tpu_torch.profiles.lz4t_mxu_gather --output g.json
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record
from lz4jpeg_tpu_torch.config import LZ4Config
from lz4jpeg_tpu_torch.models.lz4 import LZ4Codec
from lz4jpeg_tpu_torch.ops.lz4t_decode import (
    _trim_rows,
    build_copy_program_fast,
    depth_to_steps,
    resolve_blocks,
    resolve_rooted,
)
from lz4jpeg_tpu_torch.profiles import timing
from lz4jpeg_tpu_torch.profiles.onehot_gather import (
    BY_NAME,
    FULL,
    LANES,
    ROWS,
    attributes,
    literal_operand,
    onehot_gather,
    onehot_gather_prepared,
    onehot_gather_ref,
    row_bound,
    row_bytes,
    row_output,
    row_roots,
)
from lz4jpeg_tpu_torch.utils.inputs import generate_text


def rooted_program(frame: bytes):
    """``(lit (B, P) uint8, root (B, P) int32, raw_sizes, P, max_depth)``
    of the fully rooted copy program, as the probes build it."""
    lit, src, sizes, p, depth = build_copy_program_fast(frame, depth_cap=1)
    idx = np.arange(p, dtype=np.int32)[None, :]
    root = np.where(src < 0, idx, src).astype(np.int32)
    return lit, root, sizes, p, depth


def run_lz4t_mxu_gather(device="cuda", corpus: Optional[bytes] = None,
                        text_bytes: int = 4 << 20,
                        frame: Optional[bytes] = None, runs: int = 4,
                        reps: int = 8, output: Optional[str] = None,
                        seed: int = 0) -> Dict:
    """The ten rows checked and timed with the probes' comparisons;
    returns the result and writes it to ``output`` if given.  ``frame`` is
    ``corpus`` encoded, by default with the native engine as the probes
    encode it."""
    dev = bench_device(device)
    cuda = dev.type == "cuda"
    key = timing.timer_key(dev)
    if frame is not None and corpus is None:
        raise ValueError("a frame needs the corpus it encodes")
    data = (corpus if corpus is not None
            else generate_text(text_bytes, np.random.default_rng(seed)))
    if frame is None:
        frame = LZ4Codec(LZ4Config(mode="fast"), device=dev).encode(
            data, engine="native")
    lit_np, root_np, sizes, p, depth = rooted_program(frame)
    lit = torch.from_numpy(lit_np).to(dev)
    root = torch.from_numpy(root_np).to(dev)
    b = lit.shape[0]
    outputs, chunks = b * p, p // LANES
    print(f"{b} blocks of {p} (C = {chunks}); max_depth={depth}", flush=True)
    root64 = root.long()
    want = torch.gather(lit, 1, root64)
    if _trim_rows(want.cpu().numpy(), sizes) != data:
        raise AssertionError("torch.gather of the rooted program is not the "
                             "input")

    rows = []
    for row in ROWS:
        spec = BY_NAME[row.kernel]
        before = onehot_gather.launches
        got = row_output(row, root, lit)
        plain = row_output(row, root, lit, onehot_gather_ref)
        if not torch.equal(got, plain):
            raise AssertionError(f"{row.name}: the kernel differs from its "
                                 "plain version")
        if spec.cut == FULL:
            got = got.to(torch.uint8)
            if not torch.equal(got, want):
                raise AssertionError(f"{row.name}: differs from torch.gather")
            if _trim_rows(got.cpu().numpy(), sizes) != data:
                raise AssertionError(f"{row.name}: is not the input text")
        del got, plain
        checked = onehot_gather.launches - before
        ms = timing.time_ms(lambda r, row=row: row_bytes(row, r, lit), root,
                            dev, reps=reps, runs=runs,
                            kernel=onehot_gather if cuda else None)
        kernel_ms = None
        if cuda:
            op = literal_operand(lit, spec)
            kernel_ms = timing.time_ms(
                lambda r, row=row, op=op: onehot_gather_prepared(
                    r, op, row.kernel), row_roots(row, root).contiguous(),
                dev, reps=reps, runs=runs, kernel=onehot_gather)
            del op
        plain_ms = timing.time_ms(
            lambda r, row=row: row_output(row, r, lit, onehot_gather_ref)
            .to(torch.uint8), root, dev, reps=1, runs=runs)
        bound = row_bound(row, outputs, chunks, dev if cuda else None)
        rows.append({"row": row.name, "site": row.site, "kernel": row.kernel,
                     "checked": "identical to plain" + (
                         ", torch.gather and the text" if spec.cut == FULL
                         else ""),
                     key: ms, "kernel_ms": kernel_ms, f"plain_{key}": plain_ms,
                     "launches": onehot_gather.launches - before - checked,
                     "check_launches": checked, **bound,
                     "share": bound["bound_ms"] / ms if cuda else None,
                     "kernel_share": (bound["bound_ms"] / kernel_ms
                                      if cuda else None),
                     "mb_per_s": outputs / ms / 1e3,
                     **attributes(row.kernel, dev)})
        r = rows[-1]
        print(f"{row.name:14s} {ms:9.4f} ms  {r['mb_per_s']:9.1f} MB/s  plain "
              f"{plain_ms:9.4f}"
              + ("" if r["share"] is None else
                 f"  kernel alone {kernel_ms:.4f}"
                 f"  {r['share']:.1%} of {r['bound_ms']:.4f} "
                 f"({r['bound_by']})  regs {r['registers']}  smem "
                 f"{r['shared_bytes']}  ctas/SM {r['ctas_per_sm']}"),
              flush=True)

    if not torch.equal(resolve_rooted(lit, root), want):
        raise AssertionError("K3 differs from torch.gather")
    k3_ms = timing.time_ms(lambda r: resolve_rooted(lit, r), root, dev,
                           reps=reps, runs=runs,
                           kernel=resolve_rooted if cuda else None)
    gather_ms = timing.time_ms(lambda r: torch.gather(lit, 1, r), root64, dev,
                               reps=reps, runs=runs)
    lit4, src4, _, _, d4 = build_copy_program_fast(frame, depth_cap=4)
    steps = depth_to_steps(d4)
    lit4, src4 = torch.from_numpy(lit4).to(dev), torch.from_numpy(src4).to(dev)
    if not torch.equal(resolve_blocks(lit4, src4, steps), want):
        raise AssertionError("the pointer doubling differs from torch.gather")
    doubling_ms = timing.time_ms(lambda s: resolve_blocks(lit4, s, steps),
                                 src4, dev, reps=reps, runs=runs)
    comparisons = {f"k3_{key}": k3_ms, f"gather_{key}": gather_ms,
                   f"doubling_{key}": doubling_ms, "doubling_steps": steps,
                   "k3_bytes_bound_ms": timing.bytes_bound_ms(outputs * 6)}
    print(f"K3 resolve_rooted {k3_ms:9.4f} ms  torch.gather {gather_ms:9.4f}"
          f"  pointer doubling cap=4 ({steps} steps) {doubling_ms:9.4f}",
          flush=True)

    where = device_record(dev)
    full = [r for r in rows if BY_NAME[r["kernel"]].cut == FULL]
    fastest = min(full, key=lambda r: r[key])
    verdict = (f"on {where.get('card', dev)}: every full row equals "
               f"torch.gather and the text; the fastest one-hot row "
               f"({fastest['row']}, {fastest[key]:.4f} ms) takes "
               f"{fastest[key] / gather_ms:.1f}x torch.gather and "
               f"{fastest[key] / k3_ms:.1f}x K3")
    print(f"verdict: {verdict}")
    result = {"text_bytes": len(data), "blocks": b, "p": p,
              "max_depth": depth, "runs": runs, "reps": reps, "seed": seed,
              "backend": dev.type,
              "timer": "cuda events" if cuda else "host clock", **where,
              "rows": rows, "comparisons": comparisons, "verdict": verdict}
    return timing.write_result(result, output)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4jpeg_tpu_torch.profiles.lz4t_mxu_gather",
        description="The four LZ4T one-hot gather probes' rows, checked and "
                    "timed against K3, torch.gather and pointer doubling.")
    ap.add_argument("--text-bytes", type=int, default=4 << 20)
    timing.add_arguments(ap)
    args = ap.parse_args(argv)
    run_lz4t_mxu_gather(args.device, text_bytes=args.text_bytes,
                        runs=args.runs, reps=args.reps, output=args.output,
                        seed=args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
