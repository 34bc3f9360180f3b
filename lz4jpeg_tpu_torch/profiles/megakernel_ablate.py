"""Ablation of the forward megakernel (K1): one part switched off at a time.

Port of ``profiles/probe_megakernel_ablate.py``, which ablated the TPU's
megakernel on 32 frames of 2048² (N = 2,097,152 blocks): dot precision,
output orientation, colour, channels, the sparse epilogue and the chunk of
blocks per grid step.  Here each row is a compile-time variant of the
port's K1 (``profiles/megakernel.py``, ``csrc/fwd_probe_kernel.cu``) on
the same N, read from K1's (B, H, W, 3) input.  The rows, by the probe's
labels:

* full: exactly K1 (identical to ``forward_combined``), the baseline;
* DEFAULT precision: one bf16 basis part instead of three;
* no transpose: coefficient-major (128, N) output;
* no rle: the truncated coefficients, no deltas;
* no colour: y = cr = cb = R, chroma from R's odd columns;
* luma only: (N, 64);
* the chunk sweep C = 4096, 8192, 1024: bands of T = 128, 16, 32 tiles (K1's
  T = 64 plays C = 2048; T = 256 does not fit the SM's shared memory, so
  C = 8192 runs at T = 16 and the sweep extends downward); each identical
  to ``forward_combined``;
* bare: one part, no colour, no rle, coefficient-major.

Gates first, then each variant's CUDA-event time and fenced chain
(``profiles/megakernel.py::run_variants``).  Run on the card from the
repository root::

    python -m lz4jpeg_tpu_torch.profiles.megakernel_ablate --output ablate.json
"""

from __future__ import annotations

from typing import Dict, Optional

from lz4jpeg_tpu_torch.profiles.megakernel import main_of, run_variants

# (the probe's label (probe_megakernel_ablate.py:148-167), variant)
ROWS = (
    ("full (C=2048, HIGHEST, transpose, color, 3ch, rle)  [baseline]", "full"),
    ("dot DEFAULT precision", "one_part"),
    ("no output transpose (KT layout out)", "coefficient_major"),
    ("no rle epilogue", "no_sparse"),
    ("no color (y=r for all)", "no_colour"),
    ("luma only", "luma_only"),
    ("C_CHUNK=4096 (band T=128)", "band_128"),
    ("C_CHUNK=8192 (band T=16: T=256 does not fit)", "band_16"),
    ("C_CHUNK=1024 (band T=32)", "band_32"),
    ("bare: DEFAULT dot only, KT out", "bare"),
)


def run_megakernel_ablation(device="cuda", frames: int = 32, side: int = 2048,
                            runs: int = 4, chain: int = 8,
                            output: Optional[str] = None,
                            seed: int = 0) -> Dict:
    """The ablation on ``frames`` noise frames of side² (see
    ``run_variants``)."""
    return run_variants("megakernel ablation", ROWS, device, frames, side,
                        runs, chain, output, seed)


def main(argv=None) -> int:
    return main_of(run_megakernel_ablation,
                   "python -m lz4jpeg_tpu_torch.profiles.megakernel_ablate",
                   "Ablation of the forward megakernel's parts.", argv)


if __name__ == "__main__":
    raise SystemExit(main())
