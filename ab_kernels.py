#!/usr/bin/env python3
"""Time this checkout's K1 and K2 in turns with another checkout's, on one
CUDA card.

    python3 ab_kernels.py --other DIR

DIR is the root of another checkout of this repository, for example an
earlier commit unpacked into a git-ignored directory with
``git archive <commit> | tar -x -C DIR``.  Each checkout builds its kernels
from its own sources into its own ``lz4jpeg_tpu_torch/_build/`` and is
called through its own wrappers, ``ops/fwd_megakernel.py::forward_combined``
(K1) and ``ops/fused_match.py::match_candidates`` (K2), whose contracts
every commit of the port keeps.  The two run in turns, other, this, this,
other (``chip_smoke.py::time_versions``), on phase 4's and phase 8's
shapes: K1 on 2048² uniform noise at batch 64 and 256, K2 on 32 MiB of
generated text in 2048 blocks of 16 KiB (stride 1, lcp 4).  K2's outputs
must be identical; K1's may differ by sum-order flips, which
``chip_smoke.py`` phase 2 holds to their limit.  Prints the card's name and
power limit, each block of runs, and one line per kernel with both times,
the ratio, the bound and its share.
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PACKAGE = "lz4jpeg_tpu_torch"


def load_wrappers(root: Path):
    """(forward_combined, match_candidates) of the checkout at ``root``, with
    both kernels built and loaded.  Drops any other checkout's modules from
    ``sys.modules`` first; the wrappers keep their own modules alive."""
    for name in [m for m in sys.modules
                 if m == PACKAGE or m.startswith(PACKAGE + ".")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        fwd = importlib.import_module(PACKAGE + ".ops.fwd_megakernel")
        match = importlib.import_module(PACKAGE + ".ops.fused_match")
    finally:
        sys.path.remove(str(root))
    for mod in (fwd, match):
        if not Path(mod.__file__).resolve().is_relative_to(root):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, "
                               f"not from {root}")
        mod.load_kernel()
    return fwd.forward_combined, match.match_candidates


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True, type=Path,
                        help="root of the checkout to time against this one")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from chip_smoke import K1_FLOP_PER_TILE, MAIN_BYTES, SEED, bound, time_versions

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    other_fwd, other_match = load_wrappers(args.other.resolve())
    this_fwd, this_match = load_wrappers(HERE)
    from lz4jpeg_tpu_torch.ops.lz4_fast import pad_blocks_fast
    from lz4jpeg_tpu_torch.ops.quantize import (
        CHROMINANCE_QUANTIZATION_TABLE as CHR,
        LUMINANCE_QUANTIZATION_TABLE as LUM,
    )
    from lz4jpeg_tpu_torch.utils.inputs import generate_text

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for batch in (64, 256):
        x = torch.randint(0, 256, (batch, 2048, 2048, 3), dtype=torch.uint8,
                          device=dev, generator=gen)
        t = time_versions(f"K1 2048x2048 b{batch}",
                          {"other": lambda x: other_fwd(x, LUM, CHR),
                           "this": lambda x: this_fwd(x, LUM, CHR)},
                          x, identical=False)
        tiles = batch * 256 * 256
        b = bound(x.numel() + tiles * 128 * 2, tiles * K1_FLOP_PER_TILE)
        print(f"K1 2048x2048 b{batch}: this {t['this']:.4f} ms, other "
              f"{t['other']:.4f} ms ({t['other'] / t['this']:.2f}x this); bound "
              f"{b[0]:.4f} ms ({b[1]}), this {b[0] / t['this']:.1%} of it")
        del x

    padded, lengths = pad_blocks_fast(
        generate_text(MAIN_BYTES, np.random.default_rng(SEED)))
    blocks = torch.from_numpy(padded.astype(np.uint8)).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    t = time_versions("K2 2048x16KiB stride 1 lcp 4",
                      {"other": lambda a: other_match(a[0], a[1], 1, 4),
                       "this": lambda a: this_match(a[0], a[1], 1, 4)},
                      (blocks, lens))
    b = bound(blocks.numel() + lens.numel() * 4 + blocks.numel() * 4)
    print(f"K2 2048x16KiB stride 1 lcp 4: this {t['this']:.4f} ms, other "
          f"{t['other']:.4f} ms ({t['other'] / t['this']:.2f}x this); bound "
          f"{b[0]:.4f} ms ({b[1]}), this {b[0] / t['this']:.1%} of it")
    return 0


if __name__ == "__main__":
    sys.exit(main())
