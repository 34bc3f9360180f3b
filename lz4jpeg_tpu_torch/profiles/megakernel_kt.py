"""The forward megakernel fed the KT block layout, against K1 on RGB.

Port of ``profiles/probe_megakernel.py``, which asked on the TPU whether
its megakernel should read a precomputed (3, 64, N) KT layout ("stage A",
an XLA transpose) and write per-channel outputs with run counts, on 32
frames of 2048² (N = 2,097,152 blocks, even columns repeating odd ones so
that runs exist).  Here the kernel is ``kt_split_runs``, K1's template
reading KT slabs (``profiles/megakernel.py``, ``csrc/fwd_probe_kernel.cu``):
(N, 64), (N, 32), (N, 32) int16 sparse deltas and three (N,) int32 run
counts.  The rows, by the probe's labels:

* the plain chain on the device (colour, 4:2:2, three basis products,
  sparse epilogues and run counts: ``split_chain_ref``);
* stage A alone (``ops/fwd_megakernel.py::rgb_to_kt``, torch ops);
* the kernel on the pre-transposed input, the baseline;
* stage A then the kernel, end to end from RGB;
* K1 on RGB (``forward_combined``): Hopper's answer to the same question,
  the same function without the relayout.

Gates first (the kernel against its plain version, its three outputs
side by side identical to ``forward_combined``), then each row's CUDA-event
time and fenced chain (``profiles/megakernel.py::run_rows``).  Run on the
card from the repository root::

    python -m lz4jpeg_tpu_torch.profiles.megakernel_kt --output kt.json
"""

from __future__ import annotations

from typing import Dict, Optional

from lz4jpeg_tpu_torch.profiles.megakernel import (
    K1_STEP,
    PLAIN_CHAIN,
    STAGE_A,
    main_of,
    run_layout,
)

TITLE = "megakernel on the KT layout"
# (the probe's label (probe_megakernel.py:200-205), step)
ROWS = (
    ("XLA chain: color + 3 plane einsums + sparse epilogues", PLAIN_CHAIN),
    ("Stage A alone: RGB -> (3, 64, N) u8 transpose", STAGE_A),
    ("megakernel alone (pre-transposed input)", "kt_split_runs"),
    ("Stage A + megakernel end-to-end", f"{STAGE_A}+kt_split_runs"),
    ("K1 on RGB (forward_combined)", K1_STEP),
)


def run_megakernel_kt(device="cuda", frames: int = 32, side: int = 2048,
                      runs: int = 4, chain: int = 8,
                      output: Optional[str] = None, seed: int = 0) -> Dict:
    """The probe's rows on ``frames`` frames of side² (see ``run_layout``)."""
    return run_layout(TITLE, ROWS, ["kt_split_runs"], device, frames, side,
                      runs, chain, output, seed, baseline="kt_split_runs")


def main(argv=None) -> int:
    return main_of(run_megakernel_kt,
                   "python -m lz4jpeg_tpu_torch.profiles.megakernel_kt",
                   "The forward megakernel fed the KT layout.", argv)


if __name__ == "__main__":
    raise SystemExit(main())
