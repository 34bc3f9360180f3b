"""The forward megakernel's KT product variants and its chunk sweep's band
rows counted in their build: warp instructions a tile by warp role, the
issue floor at that count, registers and spill bytes.

    python -m lz4jpeg_tpu_torch.profiles.megakernel_counts [--root DIR]
        [--kt-groups G] [--output F.json]

``DIR`` is the root of a checkout (this one by default).  Its
``csrc/fwd_probe_kernel.cu`` is compiled with the toolkit (``nvcc -cubin``,
``cuobjdump -sass``, ``ptxas -v``; no card), and for each KT product
variant (``megakernel.KT_PRODUCTS``) and each band row of the chunk sweep
(``megakernel.BAND_ROWS``: K1's arithmetic at T = 16, 32 and 128, whose
consumer warps all take one role) it prints the consumer groups of the
build, ptxas's registers and spill bytes, and
``megakernel.band_sass_counts``' warp instructions a band of each warp
role (the basis-A variant's luma and chroma warps; the producer warps) and
a tile, with the issue floor at that count on 32 frames of 2048²
(2,097,152 tiles) at the H100's 132 SMs × 4 schedulers × 1,980 MHz.
``--kt-groups G`` counts a copy of the checkout's sources with every KT
product instantiation of T = 32 or 64 rebuilt at G consumer groups
(``KtProduct<T, Stage[, groups]...>`` in ``csrc/fwd_probe_kernel.cu``): what
that group count costs in registers and spills.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import tempfile
from pathlib import Path
from typing import Dict, Optional

from lz4jpeg_tpu_torch.profiles import megakernel as mk
from lz4jpeg_tpu_torch.profiles import sass_loops

TILES = 32 * 256 * 256  # 32 frames of 2048²
_INSTANCE = re.compile(r"KtProduct<(32|64), (Stage::k\w+)(?:, \d+)?")


def regrouped(root: Path, groups: int, work: Path) -> Path:
    """A checkout root under ``work`` whose ``csrc`` is ``root``'s with the
    KT product instantiations of T = 32 and 64 at ``groups`` groups."""
    csrc = work / "lz4jpeg_tpu_torch" / "csrc"
    shutil.copytree(root / "lz4jpeg_tpu_torch" / "csrc", csrc)
    probe = csrc / "fwd_probe_kernel.cu"
    text, n = _INSTANCE.subn(lambda m: f"KtProduct<{m[1]}, {m[2]}, {groups}",
                             probe.read_text())
    if not n:
        raise ValueError(f"no KT product instantiation in {probe}")
    probe.write_text(text)
    return work


def kt_counts(root: Optional[Path] = None) -> Dict[str, Dict]:
    """{KT product variant or band row: groups, registers, spill bytes, the
    counts of ``band_sass_counts`` and the issue floor at 32 frames of
    2048²}."""
    root = Path(root) if root else sass_loops.REPO
    usage = mk.probe_ptxas(root)
    names = (*mk.KT_PRODUCTS, *mk.BAND_ROWS)
    sass = mk.band_sass_counts(root, names)
    out = {}
    for name in names:
        rec = {**usage[name], **sass[name]}
        rec["issue_floor_ms"] = mk.issue_floor_ms(rec["per_tile"], TILES)
        out[name] = rec
    return out


def report(counts: Dict[str, Dict]) -> None:
    for name, rec in counts.items():
        roles = "; ".join(
            f"{role} {r['count']} x {r['warps']} warps"
            + (f" ({r['segments']} between barriers)" if "segments" in r
               else "")
            for role, r in rec.items() if isinstance(r, dict))
        if name in mk.BAND_ROWS:  # band_path's record: one consumer role
            roles = (f"consumer {rec['consumer']} x {rec['warps']} warps "
                     f"({rec['segments']} between barriers); producer "
                     f"{rec['producer']} x 1 warps")
        print(f"{name}: {rec['groups']} groups, {rec['registers']} registers, "
              f"{rec['spill_stores']} B spill stores, {rec['spill_loads']} B "
              f"spill loads; a band: {roles}; {rec['per_tile']:.2f} warp "
              f"instructions a tile, issue floor {rec['issue_floor_ms']:.4f} "
              f"ms at 32 x 2048^2", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=None,
                    help="checkout to count (default: this one)")
    ap.add_argument("--kt-groups", type=int, default=None,
                    help="rebuild the T = 32, 64 KT products at this many "
                         "groups")
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    root = (args.root or sass_loops.REPO).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        if args.kt_groups:
            root = regrouped(root, args.kt_groups, Path(tmp))
        counts = kt_counts(root)
    report(counts)
    if args.output:
        Path(args.output).write_text(json.dumps(counts, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
