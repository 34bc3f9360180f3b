"""The ladder of bare costs under the forward megakernel (K1).

Port of ``profiles/probe_megakernel_dma.py``, which built the TPU's
megakernel up from a bare copy on 32 frames of 2048² (N = 2,097,152
blocks).  Each rung moves R's 64 positions and the first 32 of G and of B
per tile, in K1's frame (``profiles/megakernel.py``,
``csrc/fwd_probe_kernel.cu``): the same bands, ring and barriers, read
from K1's (B, H, W, 3) input.  The rungs, by the probe's labels:

* u8 passthrough copy: (128, N) u8, the baseline;
* one cast: (128, N) int16;
* through f32: lanes 64-95 hold G + B (the probe's ``o2``);
* DEFAULT dots and bf16 one-pass dots: ``my·R``, ``mc·G`` and ``mc·B`` on
  raw samples (G and B through their odd columns), one pass of the hi
  bf16 basis part, truncated toward zero with no offset and no snap: one
  kernel on Hopper, whose row is recorded twice;
* HIGHEST dots: three exact bf16 parts;
* HIGHEST and bf16 dots with transposed out: block-major (N, 128).

Gates first, then each variant's CUDA-event time and fenced chain
(``profiles/megakernel.py::run_variants``).  Run on the card from the
repository root::

    python -m lz4jpeg_tpu_torch.profiles.megakernel_dma --output ladder.json
"""

from __future__ import annotations

from typing import Dict, Optional

from lz4jpeg_tpu_torch.profiles.megakernel import main_of, run_variants

# (the probe's label (probe_megakernel_dma.py:167-174), variant)
ROWS = (
    ("u8 passthrough copy (pure DMA)", "copy_u8"),
    ("u8 -> i16 out (one cast)", "cast_i16"),
    ("u8 -> f32 -> i16 out", "sum_f32"),
    ("+ DEFAULT dots", "dots_one_part"),
    ("+ HIGHEST dots", "dots_three_parts"),
    ("+ bf16 one-pass dots (u8-exact operands)", "dots_one_part"),
    ("+ HIGHEST dots, transposed out", "dots_three_parts_block"),
    ("+ bf16 dots, transposed out", "dots_one_part_block"),
)


def run_megakernel_ladder(device="cuda", frames: int = 32, side: int = 2048,
                          runs: int = 4, chain: int = 8,
                          output: Optional[str] = None,
                          seed: int = 0) -> Dict:
    """The ladder on ``frames`` noise frames of side² (see
    ``run_variants``)."""
    return run_variants("megakernel ladder", ROWS, device, frames, side,
                        runs, chain, output, seed)


def main(argv=None) -> int:
    return main_of(run_megakernel_ladder,
                   "python -m lz4jpeg_tpu_torch.profiles.megakernel_dma",
                   "The ladder of bare costs under the forward megakernel.",
                   argv)


if __name__ == "__main__":
    raise SystemExit(main())
