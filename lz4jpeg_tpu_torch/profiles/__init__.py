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
  basis dots (``profiles/probe_megakernel_dma.py``);
* ``megakernel_kt``, ``megakernel_t``, ``megakernel_v2``: K1's layout
  probes (``profiles/probe_megakernel.py``, ``probe_megakernel_t.py``,
  ``probe_megakernel_v2.py``);
* ``bitonic_sort``: the matcher's block sort with a payload and its
  reverse replay of the recorded swap masks
  (``csrc/bitonic_sort_kernel.cu``; ``profiles/profile_pallas_sort.py``),
  and its run against ``torch.sort``;
* ``bucket_partition``: the radix partition's concentration stage and the
  bitonic compare-exchange stage, two instantiations of
  ``csrc/stage_rate_kernel.cu`` (``profiles/probe_bucket_partition.py``),
  and their per-stage rates;
* ``rle_decode``: the packed16 decode by interval membership
  (``csrc/rle_membership_kernel.cu``; ``profiles/pallas_rle_decode.py``),
  and its A/B against K6 and K8;
* ``rle_expand``: K7's phase split: three copies of the packed16 stream
  (row-major, transposed, into the plane layout;
  ``csrc/rle_expand_copy_kernel.cu``; ``profiles/profile_rle_expand_rm.py``)
  and K7's body cut after each of its phases, instantiations of K7's
  template (``csrc/expand16_plane.cuh`` → ``csrc/expand16_probe_kernel.cu``;
  ``profiles/profile_rle_expand_ablate.py``), and the plane inverse's einsum
  in both orientations;
* ``rle_expand_rm``, ``rle_expand_ablate``: their runners;
* ``sublane_rle``: the packed16 compaction along the sublane axis of
  (SEG, B) tiles, SEG 32 or 64 (``csrc/sublane_rle_kernel.cu``;
  ``profiles/profile_sublane_butterfly.py``, ``profile_plane_exact.py``);
* ``sublane_butterfly``, ``plane_exact``: its runners (the A/B against K5
  and transpose + K4; the plane einsum against the tile product);
* ``casts``: the seven dtype casts of ``profiles/profile_mosaic_casts.py``
  (``csrc/cast_kernel.cu``), and their run;
* ``dct_gates``: the fp32 basis product and the minor-dims transpose
  (``csrc/dct_gate_kernel.cu``) and the lane split on the stream-copy
  kernel (``profiles/profile_fused_dct_gates.py``), and their run;
* ``pallas_color``: the colour probe's RGB → Y and odd-column chroma in
  the probe's float32 FMA order (``csrc/rgb_color_probe_kernel.cu``;
  ``profiles/profile_pallas_color.py``), and its run;
* ``mcu_relayout``: the plane → MCU tile relayout
  (``csrc/mcu_relayout_kernel.cu``; ``profiles/profile_colorsplit3.py``),
  and ``colorsplit3``, the probe's run;
* ``onehot_gather``: the LZ4T resolve as a dense one-hot product on the
  tensor cores, one template for the four gather probes
  (``csrc/onehot_gather_kernel.cu``;
  ``profiles/probe_lz4t_mxu_gather{,2,3,4}.py``), and
  ``lz4t_mxu_gather``, their run;
* ``timing``: what the probe runners share (per-call times, kernel
  attributes, bytes and issue bounds).

The codec's paths do not reach this package.  The A/Bs and probes run as
``python -m lz4jpeg_tpu_torch.profiles.candidates_ab``,
``python -m lz4jpeg_tpu_torch.profiles.plane_color``,
``python -m lz4jpeg_tpu_torch.profiles.megakernel_ablate``,
``python -m lz4jpeg_tpu_torch.profiles.megakernel_dma``, the three layout
runs (``megakernel_kt``, ``megakernel_t``, ``megakernel_v2``),
``python -m lz4jpeg_tpu_torch.profiles.bitonic_sort``,
``python -m lz4jpeg_tpu_torch.profiles.bucket_partition``,
``python -m lz4jpeg_tpu_torch.profiles.rle_decode``,
``python -m lz4jpeg_tpu_torch.profiles.rle_expand_rm``,
``python -m lz4jpeg_tpu_torch.profiles.rle_expand_ablate``,
``python -m lz4jpeg_tpu_torch.profiles.sublane_butterfly``,
``python -m lz4jpeg_tpu_torch.profiles.plane_exact``,
``python -m lz4jpeg_tpu_torch.profiles.casts``,
``python -m lz4jpeg_tpu_torch.profiles.dct_gates``,
``python -m lz4jpeg_tpu_torch.profiles.pallas_color``,
``python -m lz4jpeg_tpu_torch.profiles.colorsplit3`` and
``python -m lz4jpeg_tpu_torch.profiles.lz4t_mxu_gather`` (add ``--device
cpu`` and small sizes on a host without a card).
"""

from lz4jpeg_tpu_torch.profiles import megakernel_ablate, megakernel_dma  # noqa: F401
