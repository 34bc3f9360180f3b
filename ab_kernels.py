#!/usr/bin/env python3
"""Time this checkout's kernels in turns with another checkout's, on one
CUDA card.

    python3 ab_kernels.py --other DIR

DIR is the root of another checkout of this repository, for example an
earlier commit unpacked into a git-ignored directory with
``git archive <commit> | tar -x -C DIR``.  Each checkout builds its kernels
from its own sources into its own ``lz4jpeg_tpu_torch/_build/`` and is
called through its own wrappers, whose contracts every commit of the port
keeps: ``ops/fwd_megakernel.py::forward_combined`` (K1),
``ops/fused_match.py::match_candidates`` (K2) and, in ``ops/pack16.py``,
``pack16_encode`` (K4), ``pack16_encode_kt`` (K5), ``pack16_decode`` (K6)
and ``pack16_decode_plane`` (K7), and ``ops/stream.py::stream_copy`` (the
copy kernel, P-copy).  The two run in turns, other, this, this, other
(``chip_smoke.py::time_versions``), on phase 4's, phase 8's, phase 12's
and phase 20's shapes: K1 on 2048² uniform noise at batch 64 and 256; K2
on 32 MiB of generated text in 2048 blocks of 16 KiB (stride 1, lcp 4);
K4-K7 on the zigzag values of the luma (K = 64) and Cr chroma (K = 32)
channels of 64 such frames, K4 in int16 and int32; the copy kernel on
512 MiB of u8 as (rows, 2048), with ``Tensor.copy_`` of the same bytes,
the library call, timed in the same turns.  K2's, K4-K7's and the copy's
outputs must be identical; K1's may differ by sum-order flips, which
``chip_smoke.py`` phase 2 holds to their limit.  Prints the card's name and
power limit, each block of runs, and one line per kernel and shape with
both times, the ratio, the bound and its share.
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


def load_checkout(root: Path):
    """The kernel modules (fwd_megakernel, fused_match, pack16, stream) of the
    checkout at ``root``, with every kernel built and loaded.  Drops any
    other checkout's modules from ``sys.modules`` first; the modules stay
    alive through the returned references."""
    for name in [m for m in sys.modules
                 if m == PACKAGE or m.startswith(PACKAGE + ".")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        mods = [importlib.import_module(f"{PACKAGE}.ops.{name}")
                for name in ("fwd_megakernel", "fused_match", "pack16",
                             "stream")]
    finally:
        sys.path.remove(str(root))
    for mod in mods:
        if not Path(mod.__file__).resolve().is_relative_to(root):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, "
                               f"not from {root}")
    fwd, match, pack16, stream = mods
    fwd.load_kernel()
    match.load_kernel()
    pack16.load_pack_kernels()
    pack16.load_expand_kernels()
    stream.load_kernel()
    return fwd, match, pack16, stream


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
    from chip_smoke import (
        COPY_BYTES,
        COPY_COLUMNS,
        K1_FLOP_PER_TILE,
        MAIN_BYTES,
        SEED,
        SIDE,
        TIME_FRAMES,
        bound,
        time_versions,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    other = load_checkout(args.other.resolve())
    this = load_checkout(HERE)
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import CHANNEL_SLICES
    from lz4jpeg_tpu_torch.ops.lz4_fast import pad_blocks_fast
    from lz4jpeg_tpu_torch.ops.quantize import (
        CHROMINANCE_QUANTIZATION_TABLE as CHR,
        LUMINANCE_QUANTIZATION_TABLE as LUM,
    )
    from lz4jpeg_tpu_torch.ops.rle import rle_decode_sparse16
    from lz4jpeg_tpu_torch.utils.inputs import generate_text

    def ab(label, fn, inputs, n_bytes, flops=0.0, identical=True,
           library=None):
        """Times ``fn(modules, inputs)`` of the other checkout and of this
        one in turns, and ``library(inputs)`` with them if given; prints the
        times, their ratio, and the bound with this checkout's share of
        it."""
        fns = {"other": lambda a: fn(other, a), "this": lambda a: fn(this, a)}
        if library is not None:
            fns["library"] = library
        t = time_versions(label, fns, inputs, identical=identical)
        b = bound(n_bytes, flops)
        lib = "" if library is None else f", library {t['library']:.4f} ms"
        print(f"{label}: this {t['this']:.4f} ms, other {t['other']:.4f} ms "
              f"({t['other'] / t['this']:.2f}x this){lib}; bound {b[0]:.4f} "
              f"ms ({b[1]}), this {b[0] / t['this']:.1%} of it")

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for batch in (64, 256):
        x = torch.randint(0, 256, (batch, 2048, 2048, 3), dtype=torch.uint8,
                          device=dev, generator=gen)
        tiles = batch * 256 * 256
        ab(f"K1 2048x2048 b{batch}",
           lambda m, x: m[0].forward_combined(x, LUM, CHR), x,
           x.numel() + tiles * 128 * 2, tiles * K1_FLOP_PER_TILE,
           identical=False)
        if batch == 64:
            comb = this[0].forward_combined(x, LUM, CHR)
        del x

    # K4-K7 on phase 12's values: luma and Cr chroma of the b64 frames.
    bw = SIDE // 8
    for channel, c in (("luma", "lum"), ("chroma", "r")):
        sl = CHANNEL_SLICES[c]
        k = sl.stop - sl.start
        vals = rle_decode_sparse16(comb[:, sl]).to(torch.int16)
        n = vals.shape[0]
        shape = f"{channel} {SIDE}x{SIDE} b{TIME_FRAMES} ({n}x{k})"
        for dtype, size in ((torch.int16, 2), (torch.int32, 4)):
            ab(f"K4 {shape} {str(dtype)[6:]}",
               lambda m, a: m[2].pack16_encode(a), vals.to(dtype),
               n * k * (size + 2) + n * 4)
        words, lens = this[2].pack16_encode(vals)
        if channel == "luma":
            kt = vals.reshape(-1, bw, k).transpose(1, 2).contiguous()
            ab(f"K5 {shape}", lambda m, a: m[2].pack16_encode_kt(a), kt,
               n * k * 4 + n * 4)
            del kt
            ab(f"K6 {shape}", lambda m, a: m[2].pack16_decode(*a, k),
               (words, lens), n * k * 6 + n * 4)
        ab(f"K7 {shape}", lambda m, a: m[2].pack16_decode_plane(*a, bw),
           (words, lens), n * k * 4 + n * 4)
        del vals, words, lens
    del comb

    padded, lengths = pad_blocks_fast(
        generate_text(MAIN_BYTES, np.random.default_rng(SEED)))
    blocks = torch.from_numpy(padded.astype(np.uint8)).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    ab("K2 2048x16KiB stride 1 lcp 4",
       lambda m, a: m[1].match_candidates(a[0], a[1], 1, 4), (blocks, lens),
       blocks.numel() + lens.numel() * 4 + blocks.numel() * 4)
    del padded, blocks, lens

    x = torch.randint(0, 100, (COPY_BYTES // COPY_COLUMNS, COPY_COLUMNS),
                      generator=gen, device=dev, dtype=torch.uint8)
    sink = torch.empty_like(x)
    ab(f"copy {COPY_BYTES >> 20} MiB u8", lambda m, a: m[3].stream_copy(a), x,
       2 * x.numel(), library=lambda a: sink.copy_(a))
    return 0


if __name__ == "__main__":
    sys.exit(main())
