"""Kernel candidates and their A/Bs: the port's counterpart of the
repository's ``profiles/`` probes.

The JAX package ships none of these kernels; its probes measured them
against the formulations it does ship.  Each module here holds a
hand-written Hopper kernel, its plain torch version and a launch count on
its wrapper (a CPU tensor runs the plain version, a CUDA tensor launches the
kernel or raises):

* ``mcu``: the fused MCU forward and inverse transforms
  (``csrc/mcu_transform_kernel.cu``; ``profiles/pallas_mcu.py``);
* ``rle``: the run-length compaction into [count, value] pairs
  (``csrc/rle_compact_kernel.cu``; ``profiles/pallas_rle.py``);
* ``plane_color``: the plane YCbCr → RGB merge with the 4:2:2 upsample
  (``csrc/plane_color_kernel.cu``;
  ``profiles/profile_plane_color_kernel.py``), and its A/B;
* ``candidates_ab``: the A/B of ``mcu`` and ``rle`` against
  ``ops/fused.py`` and ``ops/rle.py`` (``profiles/profile_pallas.py``);
* ``megakernel``: the forward megakernel's attribution variants,
  compile-time instantiations of K1's template
  (``csrc/fwd_megakernel.cuh`` → ``csrc/fwd_probe_kernel.cu``), and their
  runner;
* ``megakernel_ablate``: K1 with one part switched off at a time
  (``profiles/probe_megakernel_ablate.py``);
* ``megakernel_dma``: the ladder of bare costs from a u8 copy up to the
  basis dots (``profiles/probe_megakernel_dma.py``).

The codec's paths do not reach this package.  The A/Bs and probes run as
``python -m lz4jpeg_tpu_torch.profiles.candidates_ab``,
``python -m lz4jpeg_tpu_torch.profiles.plane_color``,
``python -m lz4jpeg_tpu_torch.profiles.megakernel_ablate`` and
``python -m lz4jpeg_tpu_torch.profiles.megakernel_dma``.
"""

from lz4jpeg_tpu_torch.profiles import megakernel_ablate, megakernel_dma  # noqa: F401
