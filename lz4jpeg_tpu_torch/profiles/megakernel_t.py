"""The orientation of the forward megakernel's product on the KT layout.

Port of ``profiles/probe_megakernel_t.py``, which compared on the TPU the
production megakernel (basis × samples, a (128, C) product transposed on
the way out) with a product that contracts the samples' axis and comes out
(C, 128) directly, bit for bit equal, on 32 frames of 2048² (N = 2,097,152
blocks, even columns repeating odd ones).  K1 on Hopper already runs the
second way round (the samples are the mma's A operand), so the Hopper
counterpart is an orientation switch of K1's template
(``profiles/megakernel.py``, ``csrc/fwd_probe_kernel.cu``), both fed
``rgb_to_kt`` of the same frames.  The rows, by the probe's labels:

* production megakernel (transpose out): ``kt_basis_a``, the basis as A,
  the product (lane, tile) written transposed into the staging, the
  baseline;
* transposed-dot megakernel (no transpose): ``kt_full``, the samples as A;
* K1 on RGB (``forward_combined``).

Gates first (``kt_full`` identical to ``forward_combined``, ``kt_basis_a``
held to its plain version by the one-step rule and reported identical or
not), then each row's CUDA-event time and fenced chain
(``profiles/megakernel.py::run_rows``).  Run on the card from the
repository root::

    python -m lz4jpeg_tpu_torch.profiles.megakernel_t --output t.json
"""

from __future__ import annotations

from typing import Dict, Optional

from lz4jpeg_tpu_torch.profiles.megakernel import (
    K1_STEP,
    main_of,
    run_layout,
)

TITLE = "megakernel product orientation"
# (the probe's label (probe_megakernel_t.py:129-132), step)
ROWS = (
    ("production megakernel (transpose out)", "kt_basis_a"),
    ("transposed-dot megakernel (no transpose)", "kt_full"),
    ("K1 on RGB (forward_combined)", K1_STEP),
)


def run_megakernel_t(device="cuda", frames: int = 32, side: int = 2048,
                     runs: int = 4, chain: int = 8,
                     output: Optional[str] = None, seed: int = 0) -> Dict:
    """The probe's rows on ``frames`` frames of side² (see ``run_layout``)."""
    return run_layout(TITLE, ROWS, ["kt_basis_a", "kt_full"], device, frames,
                      side, runs, chain, output, seed)


def main(argv=None) -> int:
    return main_of(run_megakernel_t,
                   "python -m lz4jpeg_tpu_torch.profiles.megakernel_t",
                   "The orientation of the forward megakernel's product.",
                   argv)


if __name__ == "__main__":
    raise SystemExit(main())
