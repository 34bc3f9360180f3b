"""The forward megakernel's combined output from the KT layout, by band.

Port of ``profiles/probe_megakernel_v2.py``, which timed on the TPU its
megakernel's combined (C, 128) output read from random (3, 64, N) uint8
(N = 2,097,152 blocks) in three modes at chunks of C = 1024, 2048 and 4096
blocks.  Here each row is a KT variant of K1's template
(``profiles/megakernel.py``, ``csrc/fwd_probe_kernel.cu``) with the band of
T = 32, 64, 128 tiles for C = 1024, 2048, 4096.  The rows, by the probe's
labels:

* copy + transpose only: R[0:64], G[0:32], B[0:32] of each block cast to
  int16, block-major (N, 128) (``kt_copy_32``, ``kt_copy``,
  ``kt_copy_128``), the baseline at C = 1024;
* full colour + product + sparse deltas (``kt_full_32``, ``kt_full``,
  ``kt_full_128``);
* colour + product only, the truncated coefficients (``kt_dct``).

Gates first (each variant against its plain version on random KT blocks,
and, as the probe's small case, ``kt_full_32`` on ``rgb_to_kt`` of 2
frames of 512² against its plain version and identical to
``forward_combined``), then each row's CUDA-event time and fenced chain
(``profiles/megakernel.py::run_rows``).  Run on the card from the
repository root::

    python -m lz4jpeg_tpu_torch.profiles.megakernel_v2 --output v2.json
"""

from __future__ import annotations

from typing import Dict, Optional

from lz4jpeg_tpu_torch.profiles.megakernel import main_of, run_layout

TITLE = "megakernel v2 (combined (N, 128) out from KT)"
CHECK_SHAPE = (2, 512, 512)  # the probe's small case (:155)
# (the probe's label (probe_megakernel_v2.py:145-149), variant)
ROWS = (
    ("copy+transpose only, C=1024", "kt_copy_32"),
    ("copy+transpose only, C=2048", "kt_copy"),
    ("copy+transpose only, C=4096", "kt_copy_128"),
    ("FULL color+dct+sparse, C=1024", "kt_full_32"),
    ("FULL color+dct+sparse, C=2048", "kt_full"),
    ("FULL color+dct+sparse, C=4096", "kt_full_128"),
    ("color+dct only (no sparse), C=2048", "kt_dct"),
)


def run_megakernel_v2(device="cuda", frames: int = 32, side: int = 2048,
                      runs: int = 4, chain: int = 8,
                      output: Optional[str] = None, seed: int = 0) -> Dict:
    """The probe's rows on random KT blocks, as many as ``frames`` frames of
    side² hold (see ``run_layout``)."""
    return run_layout(TITLE, ROWS, [name for _, name in ROWS], device, frames,
                      side, runs, chain, output, seed, random_kt=True,
                      small_case=(CHECK_SHAPE, ["kt_full_32"]))


def main(argv=None) -> int:
    return main_of(run_megakernel_v2,
                   "python -m lz4jpeg_tpu_torch.profiles.megakernel_v2",
                   "The forward megakernel's combined output from the KT "
                   "layout.", argv)


if __name__ == "__main__":
    raise SystemExit(main())
