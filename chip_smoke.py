#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lz4jpeg_tpu_torch) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one card.  At first use it builds the thirty-seven Hopper
kernels (one nvcc per source file, twenty-four files, all started together,
sm_90a; the five megakernel probes are one file of twenty-six
instantiations of K1's template, K7's phase variants one file of eight
instantiations of K7's, the casts one template of seven instantiations,
the one-hot gathers one template of nine)
and the native runtime (g++) into ``lz4jpeg_tpu_torch/_build/``, then runs
thirty phases and fails (non-zero exit, no result line) if any of
them fails.  ``ab_kernels.py`` times K1, K2 and K4-K7 in turns with
another checkout's; ``sass_diff.py`` compares a source's machine code with
another checkout's.

1. the card's name and power limit, the torch and CUDA versions, and the
   build seconds;
2. the JPEG forward kernel (K1: persistent CTAs over bands of 64 tiles,
   cp.async band loads, colour on CUDA cores, the basis product as three
   bf16 mma.sync passes on the tensor cores) against its plain torch
   version (cuBLAS) on the card, at 2048×2048 (batch 8, duplicated columns
   for runs), the ragged shapes 2047×1531, 37×53 and 8×8 (direct-read
   route: W·3 % 16 ≠ 0), 2×512×1040 (banded route, a last band of 2
   tiles), 1×61×1040 and 2×1023×512 (banded route, a last block row
   past H), 4×48×528 with quality-75 tables, and an unaligned view of one
   256² frame (direct reads).  The only admissible difference is a
   sum-order flip (``lz4jpeg_tpu_torch/utils/parity.py``), at most 1e-5
   of the coefficients;
3. the JPEG main path: ``JPEGPipeline(JPEGConfig(), device="cuda")``,
   ``encode_batch`` of four 2048² frames, ``pack_container``,
   ``unpack_container``, ``decode_batch``.  K1 must have launched, and the
   decode must have launched the inverse megakernel K9 once;
   the containers must equal the CPU path's byte for byte (or differ only
   by phase 2's flips); the decoded RGB must stay within the fast-path
   envelope of the CPU path's decode (max |Δ| ≤ 3 on ≤ 2e-3 of pixels);
4. JPEG times on the card: the forward at 2048², batch 64, kernel against
   plain (CUDA events, 2 warm-up runs, 10 runs with min and max dropped,
   each run fenced by a checksum over its full output), the kernel alone at
   batch 256, and the encode → container → decode round trip of one 2048²
   frame;
5. the LZ4 match kernel (K2: a bitonic sort of the keys held 16 per thread
   in registers, every stride in registers through three register layouts
   but one shuffle stage per merge, 11 CTA barriers at Pa = 16,384)
   against its plain version on the card: 2048
   16 KiB blocks of generated text (the last one ragged) plus one block of
   uniform noise, strides 1, 2, 4 × lcp words 2, 4, and the crafted blocks
   of ``utils/inputs.py::crafted_match_blocks`` (one repeated byte, a
   4-byte period, a block shorter than a window, zeros, a zero-length
   padding block, a ragged block) at strides 1, 2, 4 × lcp words 1, 4,
   at 16 KiB and, with blocks of text, at 512, 256, 16 and 2 anchors per
   block (below 512 the sort pads to 512 slots; below 4 the row is stored
   word by word); the packed int32 words must be identical;
6. the LZ4T main path: ``LZ4Codec(LZ4Config(mode="fast"), device="cuda")``
   ``.encode(data, engine="device")`` of 32 MiB of generated text, then
   ``.decode(frame, engine="device")``.  K2, K3 and the parse kernel K10
   must have launched, K10 once (one ``_device_fast_encode``);
   the frame must equal the CPU codec's (plain K2) byte for byte; the
   device decode and the native decoder must return the input;
7. the rooted-resolve kernel (K3) against its plain version on the card:
   the fully rooted copy programs of 128 MiB of generated text encoded
   natively (64 KiB blocks) and of phase 6's frame (16 KiB blocks); the
   bytes must be identical;
8. LZ4T times on the card: K2 at 2048 × 16 KiB (stride 1, lcp 4) and K3 at
   128 MiB, kernel against plain as in phase 4; encode and decode MB/s of
   the main path, each with a staged split (the encode's: K2, then K10
   once);
9. the packed16 kernels K4-K7 against their plain versions on the card:
   each channel's zigzag values of eight 2048² frames with duplicated
   columns (from the K1 buffer), their plane (KT) views, and crafted rows
   for the decoders (lengths shorter than the nonzero words, count sums
   below and above K, value -512 with count 1); the kernels' tiling edges
   at K = 1, 2, 8, 32, 64: K4 on runny int16 and int32 values at row
   counts that are no multiple of its rows per warp step and in a view one
   element off a 16-byte boundary, K7 on crafted rows at plane widths 1, 7,
   63, 64, 65, 131 (around its 64-block tile), also with words and lengths
   in such views; identical outputs;
10. the packed16 path: phase 3's frames through ``to_packed16`` (K4), the
    entropy stage and ``pack_container`` (byte-identical to phase 3's
    containers) and ``decode_batch`` (K6); the plane chain
    ``fused_forward_plane`` → K5 (equal to K4's words) → K7 →
    ``fused_inverse_plane`` → ``ycbcr_planes_to_rgb``; every decode within
    the envelope of phase 3's and of the CPU port's; each of K4-K7
    launched in this phase's run; a container ending one block early
    takes the packed16 tier of ``unpack_container`` and decodes on the card;
11. quality 90 (the int16 pair layout, torch ops and cuBLAS, no kernel):
    encode, container, decode of the four frames; containers equal the CPU
    pipeline's up to phase 2's flips, decodes within the envelope;
12. times: K4-K7 against plain on the luma of 2048², batch 64 (4,194,304
    blocks), as in phase 4, K4 also fed int32 (as ``to_packed16`` feeds
    it), K4 and K7 also on the Cr chroma (K = 32); the round trip of one
    2048² frame through the packed16 path and at quality 90, each with a
    staged split;
13. the lane-dense packed16 decode kernel K8 against its plain version on
    phase 9's frames (luma K = 64 and chroma K = 32 words from K4) and on
    crafted rows, and against K6 (cast to int16) on phase 10's packed16
    words; phase 10's packed16 decode rebuilt from K8's values through
    ``fused_inverse`` and ``ycbcr_to_rgb_mcus`` (the run whose K8 launches
    are counted) identical to phase 10's K6 decode; K8, K6 and plain times
    on luma and chroma of 2048², batch 64, as in phase 12;
14. exact precision (float64) on the card: ``forward_stages`` and
    ``roundtrip`` identical to the numpy oracle at 64², 37×53 and 256²;
    at one 2048² frame the coefficients and containers identical to the
    CPU port's exact pipeline (tie differences counted by
    ``utils/parity.py::assert_quantized_parity``); a quality-75 container
    decoded in float64 from its sparse16 tier; encode and decode times;
15. per-block entropy, exact and fast: bitstrings identical to the oracle's
    at 64² and to the CPU port's at one 2048² frame; compressed bytes; the
    time of the native per-block pass;
16. the encode entry points on one 2048² frame: the overlapped ``encode``
    against the one-shot ``encode_batch`` and the CPU's (containers
    byte-identical), median times of both with the overlapped encode's
    staged split; ``encode_bucketed``/``decode_bucketed`` against
    ``encode``/``decode`` at 2048², 1000×1500 and 37×53 (admissible flips
    counted; decodes within the envelope); ``warmup``, after which an
    encode builds no library;
17. LZ4 parity mode on the card (``match_tables`` and ``greedy_parse`` as
    K11, launched once a batch chunk, its count zeroed before each encode
    and read after; the pointer-doubling ``resolve_copies`` as torch ops):
    ``LZ4Codec(LZ4Config(mode="parity"), device="cuda")`` on generated text
    (seed 0) of 350, 2,000, 20,000 and 30,000 B (the reference experiment's
    lengths), 76,500 B (255 blocks, the largest frame the format holds) and
    30,000 B at block length 1,024: every frame byte-identical to the CPU
    port's, the native ``encode_parity``'s and, up to 2,000 B, the oracle's;
    ``decode(engine="device")`` returns the input; encode, device decode and
    native encode medians of 5 (host clock) and staged splits;
18. the CLI on the card (``lz4jpeg_tpu_torch.cli.main`` in-process):
    ``lz4 encode`` fast with ``--engine device`` on 32 MiB of generated text
    and parity with ``--log`` and ``--hexdump`` on 30,000 B, ``lz4 decode
    --engine device`` of both, ``--text``, ``jpeg encode``/``decode``/
    ``roundtrip --mse --visualize`` on a 2048² noise PNG the port wrote;
    every output file equal to the same command's with ``--device cpu``
    (the container up to phase 2's flips, decoded PNGs within the envelope);
    K1, K2 and K3 launched; ``lzw encode``/``decode`` and ``lz4 inspect``
    (host); ``python -m lz4jpeg_tpu_torch`` once in a process of its own on
    the default device;
19. the parallel paths (``lz4jpeg_tpu_torch/parallel/``) on
    ``codec_mesh(MeshConfig(), "cuda")`` (one shard per card) and on a mesh
    of four shards of cuda:0, each kernel's count reset before a step and
    held to one launch per shard after it: ``ShardedSparseJPEG`` forward of
    one 2048² noise frame (K1 per band) identical to the pipeline's encode,
    its inverse (K9 per band) identical to the pipeline's decode or within
    max |Δ| ≤ 1 on < 2e-3 of pixels (the differing pixels counted); ``ShardedJPEGForward``,
    fast and exact, at 512²: stages against the card pipeline's
    ``forward_stages`` (fast: up to phase 2's flips), the inverse in the
    pair layout and in packed16 (K6 per shard and channel) against the
    card's decode of the same streams; ``sharded_fast_parse`` of phase 6's
    32 MiB (K2 and K10 per shard, 2 lcp words) identical to the unsharded
    kernels, its frame decoding to the input; ``sharded_fast_decode`` of
    phase 6's frame (K3 per shard); ``sharded_block_parse`` (K11 per shard)
    of 76,500 B of parity
    blocks identical to the unsharded card parse, its psum the match
    count; an NCCL group of one process in-process: ``multihost_fast_encode``
    of the 32 MiB (K2 once, through the codec's ``block_payloads``) equal to
    the codec's device encode, ``multihost_jpeg_encode`` of the 2048² frame
    equal to the pipeline's container, both decodes; two ranks over gloo on
    cuda:0 in processes of their own (``chip_smoke.py --rank``; NCCL refuses
    two ranks on one card) whose frames and containers equal the
    in-process ones; host-clock medians of the sharded forward and inverse
    against the pipeline's, of the multihost encodes with and without the
    group, and ``jpeg_scaling_sweep(2048, device="cuda")``; K1 alone (CUDA
    events) on the whole frame and on one of the four-shard mesh's bands;
20. the benchmark layer (``lz4jpeg_tpu_torch/bench/``), about a minute:
    the stream-copy kernel (``csrc/stream_copy_kernel.cu``, the streaming
    template ``csrc/stream_copy.cuh``) identical to ``x.clone()`` on u8,
    i16 and f32 at 512 MiB in (rows, 2048), at 1,000,003 elements and in a
    view one element off a 16-byte boundary (the byte-wise route); in u8 at
    the template's chunk edges (16 KiB − 1, 16 KiB, + 1, 3 chunks + 5), in
    offset views and between equal offsets 5 through the C entry point
    (head, body, tail), and at 2^31 + 17 bytes; each launch's CTA count from
    the C plan, held to ``ops/stream.py::copy_plan``'s mirror, and the
    kernel's registers and CTAs per SM printed; kernel, plain and
    ``Tensor.copy_`` times at 512
    MiB u8 (phase 4's method); ``measure_hbm_stream_ceiling`` (its count
    of copy-kernel launches is the kernel's record); the headline at 2048²,
    batch 256 (K1 launched 48 times); the sweeps at small scale with
    ``runs=3`` on 4 MiB of generated text: lz4-device at 64 and 1,024
    blocks (K2 and K10 128 times, K10's field entry 64 times in the sort
    series), lz4t-decode at 1, 4, 16 MB (K3 15 times),
    jpeg-inverse at 512², 1024², 2048² (batch 256 each; peak device memory
    printed; K9 60 times, once a dispatch), jpeg-perblock at 64²–256²,
    entropy-ab at 1024²; both rooflines at their defaults (the inverse's
    three stages the plain chain, its ``full_inverse`` K9, guarded by its
    launches); every artifact naming the device and the
    card; ``python -m lz4jpeg_tpu_torch bench headline --device cuda`` in a
    process of its own; the wall time of each suite;
21. the kernel candidates (``lz4jpeg_tpu_torch/profiles/``), a few
    seconds: the MCU forward and inverse kernels
    (``csrc/mcu_transform_kernel.cu``) against their plain versions (cuBLAS)
    at HW 64 and 32 on 1, 5, 63, 64, 65 (a ring chunk ± 1), 511, 513 and
    2,097,152 random tiles, the inverse on the forward's coefficients, on
    the same × 8 ± 256 + 0.1 (|z| ≥ 256 with a fraction: the mid and lo
    parts' votes; most pixels clamp), on the same plus a uniform fraction,
    on the coefficients of smooth tiles under the quality-100 table (|z|
    past 256 with pixels in range) and with the DC set so that every sum
    lies near -1.2e7 (every byte 0), identical up to
    one-step flips at summation ties (``utils/parity.py::transform_flips``:
    forward ratios within 1e-4 of an integer, inverse pixels within the
    float32 error bound of a round-half tie; at most 1e-5 of the outputs
    of each kind of input, every count printed with the share of pixels
    at 0 or 255), both kernels' registers,
    shared memory, CTAs an SM and spill bytes printed and each launch's C
    plan held to its mirror (``profiles/mcu.py::chunk_plan``); the RLE
    compaction kernel (``csrc/rle_compact_kernel.cu``) identical at L = 2,
    32, 64, 128 on 1, 5, 4,099 and 2,097,152 rows (crafted all-equal,
    all-distinct and int16-extreme rows first; at 4,099 rows also int32
    input and a view one element off a 16-byte boundary); the plane colour
    kernel (``csrc/plane_color_kernel.cu``) identical at 131,072 × 2048,
    7 × 2 and 3 × 130; each kernel and its plain version timed at the A/B
    shapes (phase 4's method; the MCU kernels with cuBLAS fp32 of the bare
    product, TF32 off, as the library call, and the inverse also on
    coefficients with a fraction, all nine part products); then
    ``run_candidates_ab`` and
    ``run_plane_color_ab`` at their defaults (artifacts in a temporary
    directory, each naming the card), each kernel's count set to 0 just
    before its A/B and read just after (every kernel launched), every time
    and verdict printed, and the phase's wall time;
22. the forward megakernel's attribution variants
    (``profiles/megakernel.py``: seventeen instantiations of K1's template
    ``csrc/fwd_megakernel.cuh`` in ``csrc/fwd_probe_kernel.cu``), about a
    minute: every variant against its plain version at 2 × 64 × 128 and at
    32 × 2048² (one-step truncation flips at ties of the variant's own
    product admitted by ``variant_flips``, at most 1e-5 of its outputs, 1e-3
    for the ladder's raw, unsnapped dots (``flip_limit``); the bare rungs
    identical), the full row and the bands of 128, 16 and 32
    tiles identical to K1 (``forward_combined``), on ``PROBE_RAGGED`` too
    (a partial last band at every T) and ``PROBE_REPEATS`` launches of each
    band row at 32 × 2048² identical to the first; each band row's build:
    its groups, warps a group, ring slots (``rgb_frame``, held to the
    card's shared memory), registers, ptxas's spill bytes (none allowed)
    and warp instructions a tile in its SASS (``band_sass_counts``,
    ``probe_ptxas``: the toolkit's, counted beside the checks); then the
    ablation
    (``run_megakernel_ablation``, the ten rows of
    ``profiles/probe_megakernel_ablate.py``) and the ladder
    (``run_megakernel_ladder``, the eight rows of
    ``profiles/probe_megakernel_dma.py``) at their defaults, 32 frames of
    2048², the variants' launch count set to 0 just before each run and
    read just after; every row printed with its CUDA-event and fenced-chain
    times, its difference from the baseline row, registers, shared memory,
    CTAs per SM and its bound; the phase's wall time;
23. the megakernel's layout variants (nine more instantiations of the same
    template, reading the (3, 64, N) KT layout of ``rgb_to_kt``), about
    20 s: every KT variant against its plain version on ``rgb_to_kt`` of
    the frames of ``PROBE_CHECKS`` (even columns repeating odd ones), the
    K1-arithmetic rows (``KT_SAME_AS_K1``: the split stage's three outputs
    side by side) identical to ``forward_combined`` on the same frames,
    ``kt_basis_a`` held to the one-step rule and reported identical or not;
    every KT variant on a ragged N (``LAYOUT_RAGGED_N``: N % 16 == 0, N % T
    ≠ 0 for every T: a last band of 16 of 32 tiles, 48 of 64 and of 128)
    against its plain version, and an N % 16 ≠ 0 refused by the wrapper
    and by the C entry point; ``LAYOUT_REPEATS`` launches of each at 32 ×
    2048², each identical to the first; each build's consumer groups,
    registers, ptxas's spill bytes (none allowed), shared memory and
    warp instructions a tile in its SASS by warp role
    (``megakernel.band_sass_counts``, the toolkit's, counted beside the
    checks); then the three layout runners
    (``run_megakernel_kt``, ``run_megakernel_t``, ``run_megakernel_v2``:
    the rows of ``profiles/probe_megakernel.py``, ``probe_megakernel_t.py``
    and ``probe_megakernel_v2.py``) at their defaults, 32 frames of 2048²,
    the variants' launch count set to 0 just before each run and read just
    after; the phase's wall time;
24. the matcher sorts and the membership decode (``profiles/
    bitonic_sort.py``, ``bucket_partition.py``, ``rle_decode.py``): the
    sort (``csrc/bitonic_sort_kernel.cu``) identical to its plain version
    and to ``torch.sort`` + ``torch.gather`` at 1, 3, 8 and 2,048 blocks of
    the probe's keys and on crafted sorted, reversed and all-same-bucket
    blocks, its replay variant returning the sorted keys and the input
    payload, both on duplicate keys identical to the plain version, and
    each variant launched ``SORT_REPEATS`` = 20 times more at 2,048 blocks,
    every launch identical to the plain version; both
    stage kernels (``csrc/stage_rate_kernel.cu``) identical to their plain
    versions at 256 and 2,048 blocks, at 1 block and at one resident wave
    of the concentration's grid ± 1 block (``STAGE_EDGES``), on a view one
    element off a 16-byte boundary and on crafted rows, and each launched
    ``STAGE_REPEATS`` = 20 times more at 2,048 blocks; the membership kernel
    (``csrc/rle_membership_kernel.cu``) identical to K6 and to its plain
    version on phase 10's luma and Cr words and on crafted rows (a valid
    word 0, lengths 0, runs past out_size; N = 1, 5, 4,099 and a CTA's row
    tile ± 1; out_size L and L/2 + 3), and three refused shapes refused by
    the wrapper and the C entry point; the kernels' registers, shared
    memory and CTAs per SM and ptxas's spill stores
    (``profiles/sass_loops.py::spill_stores``), and the stage kernels'
    lane instructions per stage-element counted in their SASS loops
    (``bucket_partition.stage_sass_counts``), which the stage runner's
    records take for their SASS floor; then the three
    runners at their defaults (2,048 sorted
    blocks; stages at 256 and 2,048 blocks; the membership A/B against K6
    and K8 on the luma words of 64 frames of 2048²), each kernel's launch
    count set to 0 just before its run and read just after, every row
    printed with registers, shared memory and CTAs per SM, K2's phase-8
    time beside the sort's, and the phase's wall time;
25. K7's phase split (``profiles/rle_expand.py``), about 10 s: the three
    copies (``csrc/rle_expand_copy_kernel.cu``: row-major, contiguous
    transpose, transpose into the plane layout) identical to their plain
    versions at the probe's luma and chroma streams (1,048,576 × 64,
    524,288 × 32), at 4,099 rows (off the 64-row tile), bw 131 (% 8 ≠ 0),
    N = 1, K 24 and 4,104, each also on a view one element off a 16-byte
    boundary and on the (rows/2, 128) view where it exists; the row-major
    copy (the streaming template of ``csrc/stream_copy.cuh``) also at K 8
    and 4,104 on rows · K · 2 bytes at the template's chunk edges
    (``EXPAND_RM_EDGES``), each launch's CTA count printed; the four
    ablated phases of K7 (``csrc/expand16_probe_kernel.cu``) identical to
    their plain versions, and the full phase (K7 itself) to
    ``pack16_decode_plane_ref``, on the probe's words (4,096 block rows of
    luma and chroma), on phase 10's luma and Cr words and on crafted rows
    (a valid word 0, lengths 0, runs past K; 4,096, 455 and 1 rows at bw
    64, 7 and 1; an offset view); three shapes refused by the wrapper and
    by the C entry point; then both runners at their defaults (16 frames of
    2048²), each wrapper's count set to 0 just before its run and read just
    after, with the verdicts and the phase's wall time;
26. the sublane RLE, the casts and the fused-DCT gates (``profiles/
    sublane_rle.py``, ``casts.py``, ``dct_gates.py``), about 6 s: the
    sublane kernel (``csrc/sublane_rle_kernel.cu``) identical to its plain
    version at SEG 32 and 64 on the probes' run-structured values at B 1,
    131, 256, 512, 70,001 and on uniform values at 2,097,152, in int32, in
    int16 and in a view one element off a 16-byte boundary; the cast kernel
    (``csrc/cast_kernel.cu``) identical to ``x.to(dst)`` for all seven
    pairs on the probe's tile, over the source's whole range (every
    bfloat16 bit pattern; NaN as NaN), in an offset view, at 1,000,003
    random words and at its chunk edges (1, a vector - 1, a chunk ± 1), and
    uint8 → int32 at 2^29 + 5 elements (2^31 + 20 bytes out), each launch's
    plan (CTAs) from the C code held to ``casts.cast_plan`` and printed;
    the basis product (``csrc/dct_gate_kernel.cu``) within 64 · 2^-24 ·
    Σ|x·m| of float64 at 512 (the probe's), 1, 63, 64, 65, 4,099 and
    2,097,152 rows, one tile short of and past a full ring a CTA and an
    offset view, each launch's plan (tiles, CTAs, tiles a CTA) held to
    ``dct_gates.dot_plan`` and printed, cuBLAS too, the outputs that differ
    from cuBLAS and the largest difference in ulp printed; the transpose
    identical at the probe's (8, 256, 8) and (8, 128, 4), ragged shapes,
    tw 1 and 64, the timed bands and an offset view, and on both routes
    (``TRANSPOSE_ROUTES``: tw 2, 4 and 8 at bw 128, 256 and 132 on the
    vector route; bw 130, tw 3, 16 and 64 on the tile route), each
    shape's route counted and every route's count checked; the lane split on the
    stream-copy kernel identical at (8, 2048), (5, 7) and (32,768, 2048)
    and in offset views, each launch's CTA count printed; five shapes refused by the wrapper and by the C
    entry point; registers, shared memory and CTAs per SM of every
    instantiation (both transpose routes); then the four runners at their
    defaults (``BUTTERFLY_RUN``, ``PLANE_EXACT_RUN``, ``CASTS_RUN``,
    ``GATES_RUN``), each wrapper's count (and the transpose's per-route
    counts) set to 0 just before its run and read just after;
27. the colour probe and the MCU relayout (``profiles/pallas_color.py``,
    ``mcu_relayout.py``): the colour kernel
    (``csrc/rgb_color_probe_kernel.cu``) identical to its plain version
    (the probe's float32 FMA order emulated in float64) on the probe's
    (16, 2048, 3) case, over the whole 2^24 colour cube in both column
    phases (each channel's mismatches against ``rgb_to_ycbcr`` printed: the
    probe has no tie snap), on ``COLOR_SHAPES`` and an offset view; the
    relayout (``csrc/mcu_relayout_kernel.cu``) identical to
    ``split_mcus``'s copy on ``RELAYOUT_SHAPES`` (the timed luma and
    chroma, also against ``split_mcus`` itself, Wp % 16 ≠ 0, wider than a
    span) and their offset views; three shapes refused by the
    wrappers and the C entry points; registers, shared memory and CTAs per
    SM; then both runners at their defaults (``COLOR_PROBE_RUN``,
    ``COLORSPLIT_RUN``), each wrapper's count set to 0 just before its run
    and read just after;
28. the one-hot gathers (``profiles/onehot_gather.py``): every
    instantiation of ``csrc/onehot_gather_kernel.cu`` identical to its
    plain version (the dense product in float64) on ``GATHER_SYNTHETIC``
    roots (some outside [0, P); 1, 3 and 133 blocks at P = 2,048, 4,096
    and 65,536, so that the persistent CTAs' runs of steps cross blocks)
    and on an offset view of them, three refusals by the wrapper and the C
    entry point, every instantiation's registers, shared memory and CTAs
    per SM; then the runner of the four probes' ten rows at its defaults
    (``MXU_GATHER_RUN``: 4 MiB of generated text, 64 KiB blocks; every
    full row equal to ``torch.gather`` and the text; each row's time with
    its torch code and the kernel's alone printed), the gather's and K3's
    counts set to 0 just before and read just after;
29. the inverse megakernel K9 (``csrc/inv_megakernel.cu``,
    ``ops/inv_megakernel.py``), about 20 s: against its plain version
    (the torch chain on cuBLAS) on K1's buffers of noise frames at
    ``INV_CASES`` (2048² b8, 2047×1531 and 37×53 on the byte store route,
    8×8, 1×1, 2×512×1040 with a last unit of 2 tiles, 4×48×528 at quality
    75, 2048² b4 at quality 90 and 100, whose deltas issue the mid part's
    products, a 256² input view off 16 bytes on the word load route), each
    launch's C plan held to ``inverse_plan``'s mirror, its tie pass's count
    of recomputed plane values printed, every differing pixel explained by
    one-step plane flips at summation ties (``utils/parity.py::
    decode_flips``; the count printed, at most ``INV_MAX_FLIPS`` = 1e-5 of
    the pixels) and every decode within max |Δ| ≤ 3 on ≤ 2e-3 of pixels;
    words 0, 1024, -512, -32768 and 32767 at every lane identical to the
    plain version; the innermost SASS loops and the innermost loop holding
    K9's HMMA (one at least), registers, shared memory, CTAs an SM and ptxas's
    spill stores (none allowed); K9 and plain timed at 2048² b64 (phase
    4's method), K9 at b256;
30. LZ4's greedy parses (``csrc/lz4_parse_kernel.cu``,
    ``ops/lz4_parse.py``) against their plain versions, bit for bit,
    dtypes included: K10's candidate entry (``parse_candidates``) on
    phase 5's kind of text, 2048 blocks of 16 KiB with a ragged last one,
    at strides 1, 2, 4 and lcp words 2, 4 on K2's words, also (lcp 4)
    at a segment past its tile (16,384 bytes), at 64 bytes and at
    ``max_dist`` 3,000 and 9, on the crafted blocks of
    ``utils/inputs.py::crafted_match_blocks`` and on
    ``segment_end_candidates`` (matches ending on every segment's end,
    ragged lengths, distance caps; every segment's last match held to end
    on it); K10's field entry (``greedy_parse``) inside the sort matcher
    at 2048 × 16 KiB (against the same matcher with the plain walk) and
    on int32 and int64 inputs at ``FIELD_CASES``, values that wrap
    included, then a sort-matcher encode of 4 MiB with its count zeroed
    before and read after (one launch; frame equal to the CPU codec's);
    K11 (``parity_tables``: best_len, best_dist, is_match, emit_len,
    emit_dist) on 76,500 B at block length 300 (255 blocks), 30,000 B at
    1,024 and 17,000 B at 9,000 (two tiles of positions), all-equal bytes,
    255 random blocks and the truncation and tie rows of
    ``crafted_parity_bytes`` at 300 and 1,024, each at max_match 1,024 and
    100; K10's entries timed against plain at 2048 × 16 KiB (phase 4's
    method), K11 at 255 × 300 and 30 × 1,024 queued (``timing.time_ms``,
    plain, kernel, kernel, plain), each with its bytes bound.

The line before the last is the kernels' JSON record: per kernel (the
packed16 kernels once per timed channel and input dtype) its launches on
the main path (phase 21's kernels: per A/B call), its error against the
plain version, its time, the plain version's, its bound (the larger of
the bytes it must move over 3.35 TB/s and the operations as bf16
tensor-core work over 989 TFLOP/s, the H100 SXM data sheet's rates: K1's
three-part product, and the MCU kernels' product counted the same way,
three basis parts against exact pixel values, and against the parts each
tile of the timed coefficients needs for the inverse
(``profiles/mcu.py::inverse_products``), which leaves both MCU kernels
bound by their bytes) and the time of one PyTorch call that computes the
same function where there is one (K3: ``torch.gather``; the copy kernel:
``Tensor.copy_``; the sort: ``torch.sort`` of the keys alone; the MCU
kernels: cuBLAS fp32 of the bare product; none for the rest of phase
21's, for 22's and 23's kernels, the stage kernels and the membership
decode; phase 25's copies: ``Tensor.copy_`` and, for the transposes,
their plain version, which is that call; none for the phase variants;
phase 26's: none for the sublane RLE, ``x.to(dst)`` for the casts (also
their plain version), cuBLAS fp32 for the basis product, ``.transpose(1,
2).contiguous()`` for the transpose, ``Tensor.copy_`` for the split).
K9's record (phase 29) bounds it by the larger of its bytes and the bf16
tensor work of the part products the timed buffer's warp fragments issue
(``ops/inv_megakernel.py::part_products``: 3 a channel and unit, 6 where
the vote finds a mid part), adds each alone (``bytes_bound_ms``,
``tensor_bound_ms``), the FMA bound of every term at 132 SMs × 128 lanes ×
1.98 GHz (fp32 outside the tensor cores, the parent's design:
``ffma_bound_ms``; phase 29 prints it and the non-zero deltas' FMA bound
as the parent's yardstick), its time at b256, its flips and its tie
share; no library call.
The probe runners' times (phases 22-25, ``profiles/timing.py``) are
queued behind a spin on the card, so that the host's issue of each call
drops out.  Phase 24's
records add an issue bound (``issue_bound_ms``: the
least lane instructions the algorithm needs, as warp instructions over
132 SMs × 4 schedulers at the card's highest SM clock, labelled by what
they count in ``issue_counts``; the stage kernels' records also the
floor at the count of this run's SASS loop, ``sass_issue_bound_ms`` and
``sass_counts``): integer compares and selects have no
data-sheet rate, so ``bound_ms`` stays the bytes bound.  Phase
22's two records (``megakernel_ablate``, ``megakernel_dma``) and phase
23's three (``megakernel_kt``, ``megakernel_t``, ``megakernel_v2``) give
the baseline row's time, bound and plain time, the launches of the whole
run, and a ``variants`` list of every row; phase 25's
``expand16_phases`` record gives the luma dist row (the last ablated
phase), the launches of the ablated phases in the ablation run and a
``variants`` list of every phase at luma and chroma, the full one K7's;
phase 26's six records (one per TPU site: the butterfly, the SEG 32/64
butterfly, the casts, the product, the transpose, the split) give the
runners' rows (the SEG 32/64 butterfly its SEG 32 time: SEG 64 is the
butterfly's row), the casts the int32 → float32 pair with a ``variants``
list of all seven, the product its FFMA bound (67 TFLOP/s fp32) beside the
bytes bound; phase 27's two (the colour probe with the torch chain's time
and K1's colour share beside it, no library call; the relayout's luma row
with ``split_mcus``'s transposing copy as the library call, the stream
copy's time and the probe's rows; each record's ``max_abs_err`` the
largest |kernel − plain| of the phase's checks) and phase 28's four (one
per probe: g1, g2's full row, g3 at T = 512, g4 at (32, bf16), each with
a ``variants`` list of its rows, bound by the product's operations over
989 TFLOP/s bf16 or 1,979 TOPS int8 (``bound``), ``torch.gather`` the
library call, K3's and the pointer doubling's times beside it); phase
30's three (K10's candidate and field entries, K11) bound by their bytes,
with no library call, K10's launches from phase 6's encode, K11's from
phase 17's 76,500 B encode, the field entry's from phase 30's
sort-matcher encode.  Before
it, one line per
bytes-bound kernel gives its share of the data sheet's bound and of the
same bytes over the stream ceiling phase 20 measured.  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
MAX_FLIP_SHARE = 1e-5
KERNEL_SOURCE = "lz4jpeg_tpu_torch/csrc/fwd_megakernel.cu"
KERNEL_REPLACES = "lz4jpeg_tpu/ops/pallas_fwd.py:106"
MATCH_SOURCE = "lz4jpeg_tpu_torch/csrc/match_kernel.cu"
MATCH_REPLACES = "lz4jpeg_tpu/ops/pallas_match.py:87"
RESOLVE_SOURCE = "lz4jpeg_tpu_torch/csrc/resolve_kernel.cu"
RESOLVE_REPLACES = "lz4jpeg_tpu/ops/lz4t_decode.py:235"
PACK_SOURCE = "lz4jpeg_tpu_torch/csrc/pack16_kernel.cu"
EXPAND_SOURCE = "lz4jpeg_tpu_torch/csrc/expand16_kernel.cu"
WIDE_SOURCE = "lz4jpeg_tpu_torch/csrc/expand16_wide_kernel.cu"
WIDE_REPLACES = "lz4jpeg_tpu/ops/pallas_rle.py:552"
# (record name, wrapper in ops/pack16.py, source, the TPU kernel it replaces)
PAIR_KERNELS = (
    ("pack16_rows", "pack16_encode", PACK_SOURCE,
     "lz4jpeg_tpu/ops/pallas_rle.py:75"),
    ("pack16_kt", "pack16_encode_kt", PACK_SOURCE,
     "lz4jpeg_tpu/ops/pallas_rle.py:191"),
    ("expand16_rows", "pack16_decode", EXPAND_SOURCE,
     "lz4jpeg_tpu/ops/pallas_rle.py:443"),
    ("expand16_plane", "pack16_decode_plane", EXPAND_SOURCE,
     "lz4jpeg_tpu/ops/pallas_rle.py:478"),
)
MIB = 1 << 20
MATCH_BLOCKS = 2048  # 16 KiB blocks of text in phase 5 (the last ragged)
SMALL_ANCHORS = (512, 256, 16, 2)  # anchors per block of phase 5's small blocks
MAIN_BYTES = 32 * MIB  # the LZ4T main path's input (2048 × 16 KiB)
TEXT_BYTES = 128 * MIB  # the natively encoded input of phases 7-8
SIDE = 2048  # frame side of phases 9 and 12
CHECK_FRAMES = 8  # frames of phase 9
# Phase 9's tiling edges: segment widths K, K4 row counts that are no
# multiple of its rows per warp step, K7 plane widths around its 64-block
# tile (T - 1, T, T + 1, 2T + 3 and below).
EDGE_SEGS = (1, 2, 8, 32, 64)
EDGE_ROWS = (1, 17, 999, 4099)
EDGE_WIDTHS = (1, 7, 63, 64, 65, 131)
TIME_FRAMES = 64  # frames of phase 12's and phase 13's kernel times
ORACLE_SHAPES = ((64, 64), (37, 53), (256, 256))  # phase 14 (numpy oracle)
BUCKET_SHAPES = ((2048, 2048), (1000, 1500), (37, 53))  # phase 16
ENCODE_RUNS = 11  # timed encodes of each entry point in phase 16
# Phase 17: (bytes, block length) of generated text; the first four are the
# reference experiment's text lengths, 76,500 B the largest parity frame
# (255 blocks: the block count is one byte).
PARITY_SIZES = ((350, 300), (2000, 300), (20_000, 300), (30_000, 300),
                (76_500, 300), (30_000, 1024))
ORACLE_MAX_BYTES = 2000  # phase 17 holds frames up to this size to the oracle
PARITY_RUNS = 5  # timed runs of each phase-17 stage (median)
CLI_TEXT_BYTES = 32 * MIB  # phase 18's fast-mode input
CLI_PARITY_BYTES = 30_000  # phase 18's parity-mode input
PAR_SHARDS = 4  # phase 19's shards of cuda:0
PAR_STAGED_SIDE = 512  # phase 19's ShardedJPEGForward frame and rank frame
PAR_PARITY_BYTES = 76_500  # phase 19's parity input (phase 17's largest)
PAR_RANK_TEXT_BYTES = 2 * MIB  # phase 19's two-rank LZ4T input
PAR_RUNS = 5  # host-clock runs of each phase-19 time (median)
COPY_SOURCE = "lz4jpeg_tpu_torch/csrc/stream_copy_kernel.cu"
COPY_REPLACES = "profiles/probe_pallas_copy_ceiling.py:50"
COPY_BYTES = 512 * MIB  # phase 20's copy arrays, (rows, 2048) as the probe's
COPY_COLUMNS = 2048
COPY_BIG_BYTES = 2**31 + 17  # phase 20's copy above 2^31 bytes (64-bit offsets)
COPY_EQUAL_OFFSET = 5  # phase 20's source and destination offset modulo 16
HEADLINE_SHAPE = (2048, 256)  # phase 20's headline: side, batch
BENCH_TEXT_BYTES = 4 * MIB  # phase 20's generated corpus for the LZ4 sweeps
BENCH_RUNS = 3  # timed runs of each phase-20 sweep
BENCH_LZ4_BATCHES = (64, 1024)
BENCH_LZ4T_MB = (1, 4, 16)
BENCH_INVERSE_SIZES = (512, 1024, 2048)
BENCH_PERBLOCK_SIZES = (64, 128, 256)
BENCH_ENTROPY_SIDE = 1024
ROOFLINE_FORWARD = {}  # the suites' defaults: 2048², batch 32, chain 8
ROOFLINE_INVERSE = {}  # 2048², batch 64, chain 8
MCU_SOURCE = "lz4jpeg_tpu_torch/csrc/mcu_transform_kernel.cu"
RLE_SOURCE = "lz4jpeg_tpu_torch/csrc/rle_compact_kernel.cu"
COLOR_SOURCE = "lz4jpeg_tpu_torch/csrc/plane_color_kernel.cu"
# Phase 21's MCU tile counts: 64 is a ring chunk (profiles/mcu.py::CHUNK).
CAND_TILES = (1, 5, 63, 64, 65, 511, 513, 2 * 1024 * 1024)
CAND_SEGS = (2, 32, 64, 128)  # phase 21's RLE row lengths
CAND_ROWS = (1, 5, 4099, 2 * 1024 * 1024)  # and row counts
CAND_PLANES = ((131_072, 2048), (7, 2), (3, 130))  # phase 21's (n, w) planes
CAND_AB = {}  # the candidate A/B's defaults: 2,097,152 luma tiles, chain 8
COLOR_AB = {}  # the colour A/B's defaults: 2048², batch 64
PROBE_SOURCE = "lz4jpeg_tpu_torch/csrc/fwd_probe_kernel.cu"
PROBE_REPLACES = {"megakernel_ablate": "profiles/probe_megakernel_ablate.py:77",
                  "megakernel_dma": "profiles/probe_megakernel_dma.py:78"}
PROBE_CHECKS = ((2, 64, 128), (32, 2048, 2048))  # phase 22's (frames, H, W)
# Phase 22's ragged shape: 130 tiles a block row, a last band of 2 tiles at
# T = 16, 32 and 128 (and 64).
PROBE_RAGGED = (2, 64, 1040)
PROBE_REPEATS = 20  # phase 22: launches of each band row at 32 × 2048²
PROBE_RUN = {}  # both probe runs' defaults: 32 frames of 2048², chains of 8
LAYOUT_REPLACES = {"megakernel_kt": "profiles/probe_megakernel.py:108",
                   "megakernel_t": "profiles/probe_megakernel_t.py:50",
                   "megakernel_v2": "profiles/probe_megakernel_v2.py:85"}
LAYOUT_RAGGED_N = 64 * 64 + 48  # phase 23: N % 16 == 0, N % 32, 64, 128 ≠ 0
LAYOUT_REPEATS = 20  # phase 23: launches of each KT variant at 32 × 2048²
LAYOUT_REFUSED_N = 4100  # phase 23: N % 16 ≠ 0
LAYOUT_RUN = {}  # the three layout runs' defaults: 32 frames of 2048²
SORT_SOURCE = "lz4jpeg_tpu_torch/csrc/bitonic_sort_kernel.cu"
STAGE_SOURCE = "lz4jpeg_tpu_torch/csrc/stage_rate_kernel.cu"
MEMBERSHIP_SOURCE = "lz4jpeg_tpu_torch/csrc/rle_membership_kernel.cu"
SORT_BLOCKS = (1, 3, 8, 2048)  # phase 24's sorts against plain and torch.sort
SORT_REPEATS = 20  # phase 24: launches of the largest sort, each held to plain
STAGE_BLOCKS = (256, 2048)  # phase 24's stage kernels against plain
# and at 1 block and one resident wave of the concentration's grid (396
# blocks: 132 SMs x 3 CTAs x 4 warps x 32 rows) ± 1 block
STAGE_EDGES = (1, 395, 396, 397)
STAGE_REPEATS = 20  # phase 24: launches of each stage kernel at 2,048 blocks
MEMBER_ROWS = (1, 5, 4099)  # phase 24's crafted packed16 rows (and a row tile ± 1)
MEMBER_REFUSED = ((64, 65), (16, 16), (128, 64))  # (L, out_size) refused
SORT_RUN = {}  # the runners' defaults: 2,048 blocks, 8 checked
STAGE_RUN = {}  # 256 and 2,048 blocks
RLE_RUN = {}  # the luma words of 64 frames of 2048²
COPIES_SOURCE = "lz4jpeg_tpu_torch/csrc/rle_expand_copy_kernel.cu"
PHASES_SOURCE = "lz4jpeg_tpu_torch/csrc/expand16_probe_kernel.cu"
# Phase 25's copies (rows, K, bw): the probe's luma and chroma streams; rows
# off the 64-row tile; bw % 8 != 0; N = 1; K no power of two; K over 64.
EXPAND_COPIES = ((1_048_576, 64, 256), (524_288, 32, 128), (4099, 64, 4099),
                 (917, 64, 131), (1, 8, 1), (30, 24, 5), (100, 4104, 10))
# phase 25's copy_rm-only shapes: rows · K · 2 bytes at the stream-copy
# template's chunk edges (16 KiB ∓ 16), 3 chunks + 16, and K 4,104 (more
# than 512 16-byte pieces a row) a chunk + 32
EXPAND_RM_EDGES = ((1023, 8), (1024, 8), (1025, 8), (3073, 8), (2, 4104))
EXPAND_PROBE_BH = 4096  # phase 25's probe words: 4,096 block rows a channel
EXPAND_CRAFTED = ((4096, 64), (7 * 65, 7), (1, 1))  # (rows, bw) of crafted rows
EXPAND_RM_RUN = {}  # both runners' defaults: 16 frames of 2048²
EXPAND_ABLATE_RUN = {}
SUBLANE_SOURCE = "lz4jpeg_tpu_torch/csrc/sublane_rle_kernel.cu"
CAST_SOURCE = "lz4jpeg_tpu_torch/csrc/cast_kernel.cu"
GATE_SOURCE = "lz4jpeg_tpu_torch/csrc/dct_gate_kernel.cu"
# Phase 26's checks: sublane widths (the probes' 256 and 512, ragged ones,
# the runners' 2,097,152); basis-product rows; transposes (B, bw, tw): the
# probe's, ragged, tw 1 and 64, the timed bands; splits ((rows, W), tw).
SUBLANE_COLS = (1, 131, 256, 512, 70_001, 2_097_152)
DOT_ROWS = (512, 1, 63, 64, 65, 4099, 2_097_152)
TRANSPOSE_SHAPES = ((8, 256, 8), (8, 128, 4), (3, 7, 5), (2, 1000, 64),
                    (1, 1, 1), (5, 129, 3), (4, 300, 33), (32_768, 256, 8),
                    (32_768, 128, 4))
# (B, bw, tw) on each route of the transpose: vector (tw 2, 4, 8, bw % 4
# == 0) and tile (ragged bw, other tw).
TRANSPOSE_ROUTES = ((8, 128, 2), (8, 256, 2), (8, 132, 2), (8, 256, 4),
                    (8, 132, 4), (8, 128, 8), (8, 132, 8), (8, 130, 4),
                    (8, 130, 8), (8, 128, 3), (8, 128, 16), (8, 128, 64))
SPLIT_SHAPES = (((8, 2048), 8), ((5, 7), 7), ((32_768, 2048), 8))
CAST_RAGGED = 1_000_003  # phase 26's random cast inputs, off every vector
CAST_BIG = (1 << 29) + 5  # phase 26's uint8 -> int32: 2^31 + 20 bytes out
BUTTERFLY_RUN = {}  # the four runners' defaults: (64, 2,097,152) int32,
PLANE_EXACT_RUN = {}  # 256² and 512² frames and (32, 2,097,152),
CASTS_RUN = {}  # 134,217,728 elements a pair,
GATES_RUN = {}  # 2,097,152 × 64 and 32,768 band rows
RGB_SOURCE = "lz4jpeg_tpu_torch/csrc/rgb_color_probe_kernel.cu"
RELAYOUT_SOURCE = "lz4jpeg_tpu_torch/csrc/mcu_relayout_kernel.cu"
ONEHOT_SOURCE = "lz4jpeg_tpu_torch/csrc/onehot_gather_kernel.cu"
# Phase 27's checks: RGB shapes (..., W, 3) past the colour kernel's
# 16-pixel runs; relayout planes ((..., H, Wp), tw): the timed luma and
# chroma, Wp % 16 ≠ 0 (rows loaded in 4-byte words), wider than a span.
COLOR_SHAPES = ((3, 130, 3), (1, 2, 3), (5, 18, 3), (2, 64, 2048, 3))
RELAYOUT_SHAPES = (((32, 2048, 2048), 8), ((32, 2048, 1024), 4),
                   ((16, 20), 4), ((8, 24), 8), ((3, 24, 4104), 8),
                   ((1, 8, 2064), 4))
# Phase 28's synthetic roots: (blocks, P), some outside [0, P); 1, 3 and
# 133 blocks do not divide among the resident CTAs, so runs cross blocks.
GATHER_SYNTHETIC = ((2, 4096), (3, 16_384), (1, 2048), (3, 2048),
                    (133, 2048), (1, 4096), (3, 4096), (133, 4096),
                    (1, 65_536), (3, 65_536), (133, 65_536))
COLOR_PROBE_RUN = {}  # the runners' defaults: 32 × 2048² and the cube,
COLORSPLIT_RUN = {}  # 32 noise frames of 2048²,
MXU_GATHER_RUN = {}  # 4 MiB of generated text, 64 KiB blocks
INV_SOURCE = "lz4jpeg_tpu_torch/csrc/inv_megakernel.cu"
INV_REPLACES = "lz4jpeg_tpu/models/jpeg.py:408"
# Phase 29's K9 checks: (label, (frames, H, W), quality); the timed batches.
INV_CASES = (("2048x2048 b8", (8, 2048, 2048), None),
             ("2047x1531", (1, 2047, 1531), None),
             ("37x53", (1, 37, 53), None),
             ("8x8", (1, 8, 8), None),
             ("1x1", (1, 1, 1), None),
             ("2x512x1040, last unit 2 tiles", (2, 512, 1040), None),
             ("4x48x528 quality 75", (4, 48, 528), 75),
             ("2048x2048 b4 quality 90", (4, 2048, 2048), 90),
             ("2048x2048 b4 quality 100", (4, 2048, 2048), 100),
             ("256x256 unaligned input view", (1, 256, 256), None))
INV_MAX_FLIPS = 1e-5  # flips against plain, a share of the pixels
INV_WORDS = (0, 1024, -512, -32768, 32767)  # crafted words at every lane
INV_TIME_FRAMES = (64, 256)
PARSE_SOURCE = "lz4jpeg_tpu_torch/csrc/lz4_parse_kernel.cu"
# The XLA stages K10 and K11 replace: the Pallas matcher's post-pass scan,
# the sort matcher's scan, parity mode's match tables (and greedy_parse).
PARSE_REPLACES = "lz4jpeg_tpu/ops/pallas_match.py:320"
FIELDS_REPLACES = "lz4jpeg_tpu/ops/lz4_fast.py:223"
PARITY_REPLACES = "lz4jpeg_tpu/ops/match.py:56"
# Phase 30: K10 at phase 5's 2048 x 16 KiB, (seg, max_dist) beside the
# codec's (512, 65535): a segment past K10's tile, one below the walk's
# batch, and two distance caps; the field entry's (seg, stride) and the
# sort-matcher encode's bytes; K11's (bytes of text, block length) and
# crafted blocks, each at max_match 1,024 and 100.
PARSE_SEGMENTS = ((16384, 65535), (64, 65535), (512, 3000), (512, 9))
FIELD_CASES = ((512, 1), (16384, 1), (100, 3), (7, 2))
SORT_ENCODE_BYTES = 4 * MIB
PARITY_CASES = ((76_500, 300), (30_000, 1024), (17_000, 9000))
PARITY_MAX_MATCH = (1024, 100)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
INT8_OP_PER_S = 1979e12  # H100 SXM dense int8 tensor cores (data sheet)
# fp32 FMA outside the tensor cores: 132 SMs × 128 lanes at 1.98 GHz.
FFMA_PER_S = 132 * 128 * 1.98e9
# K1's tensor-core work per 8x8 tile: three bf16 passes of a 64-deep luma
# and two 32-deep chroma products, 2 operations per multiply-add.
K1_FLOP_PER_TILE = 3 * 2 * (64 * 64 + 2 * 32 * 32)
# The MCU candidates' product counted the same way, per 64-deep luma tile
# and part product: three bf16 basis parts against exact pixel values
# (forward); the inverse's parts are those each tile's coefficients need
# (profiles/mcu.py::inverse_products).
MCU_FLOP_PER_PRODUCT = 2 * 64 * 64
MCU_FWD_FLOP_PER_TILE = 3 * MCU_FLOP_PER_PRODUCT


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def noise(b: int, h: int, w: int, rng: np.random.Generator, runs: bool = False):
    rgb = rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)
    if runs:  # duplicated columns make runs of equal coefficients
        rgb[:, :, 0 : 2 * (w // 2) : 2] = rgb[:, :, 1::2]
    return rgb


def runny_values(n: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """(n, k) int32 values in [-511, 511], each repeating the one before it
    with probability 0.7, so rows hold runs of every length; row 0 holds the
    limits ±511."""
    vals = rng.integers(-511, 512, size=(n, k))
    repeat = rng.random((n, k)) < 0.7
    for j in range(1, k):
        vals[:, j] = np.where(repeat[:, j], vals[:, j - 1], vals[:, j])
    vals[0, 0], vals[0, -1] = 511, -511
    return vals.astype(np.int32)


def offset_view(x):
    """``x`` copied into a view one element past a 16-byte boundary."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape).copy_(x)
    check(view.data_ptr() % 16 != 0, "the view is 16-byte aligned")
    return view


def copy_ctas(label: str, src: int, dst: int, n: int) -> int:
    """Phases 20, 25, 26: the CTA count of the stream-copy template's launch
    of ``n`` bytes between these device addresses, from the C code's plan,
    held equal to ``ops/stream.py::copy_plan``'s mirror and printed."""
    from lz4jpeg_tpu_torch.ops import stream

    got = stream.launch_plan(src, dst, n)
    want = stream.copy_plan(n, src % 16, dst % 16)
    check(got == want, f"{label}: the C plan {got} is not the mirror's {want}")
    print(f"{label}: {n} bytes, src % 16 = {src % 16}, dst % 16 = {dst % 16}: "
          f"{got.ctas} CTAs (head {got.head}, {got.n_vec} vectors, tail "
          f"{got.tail})")
    return got.ctas


def cast_ctas(label: str, pair: int, n: int) -> int:
    """Phase 26: the CTAs of the cast kernel's launch for ``n`` elements of
    the pair, from the C code's plan, held equal to
    ``profiles/casts.py::cast_plan``'s mirror and printed."""
    from lz4jpeg_tpu_torch.profiles import casts

    got, want = casts.launch_plan(pair, n), casts.cast_plan(pair, n)
    check(got == want, f"{label}: the C plan {got} is not the mirror's {want}")
    print(f"{label}: {n} elements: {got.ctas} CTAs of {got.threads} threads "
          f"({got.n_vec} vectors of {got.vec_elems}, tail {got.tail})")
    return got.ctas


def dot_ctas(label: str, n: int, dev, resident: int):
    """Phase 26: the basis product's launch for ``n`` rows from the C code's
    plan, held equal to ``profiles/dct_gates.py::dot_plan``'s mirror on a
    card where ``resident`` CTAs fit, and printed; returns the plan."""
    from lz4jpeg_tpu_torch.profiles import dct_gates as dg

    got, want = dg.dot_launch_plan(n, dev), dg.dot_plan(n, resident)
    check(got == want, f"{label}: the C plan {got} is not the mirror's {want}")
    per_cta = -(-got.tiles // got.ctas) if got.ctas else 0
    print(f"{label}: {n} rows: {got.tiles} tiles of {got.tile_rows} over "
          f"{got.ctas} CTAs, {per_cta} tiles a CTA at most, a ring of "
          f"{got.stages}")
    return got


def timed_runs(fn, x, warmup: int = 2, runs: int = 10):
    """Per-run CUDA-event ms of ``fn(x)`` and the full-output checksums."""
    import torch

    for _ in range(warmup):
        fn(x)
    events, sums = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(x)
        end.record()
        outs = out if isinstance(out, tuple) else (out,)
        sums.append(sum(t.sum(dtype=torch.int64) for t in outs))
        events.append((start, end))
        del out, outs
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in events]
    return ms, {int(s) for s in sums}


def bound(n_bytes: float, flops: float = 0.0, int8_ops: float = 0.0):
    """(bound_ms, bound_by): the least time the card could take for the
    work, the larger of ``n_bytes`` over the HBM rate and the tensor-core
    work over its peak: ``flops`` bf16 operations and ``int8_ops`` int8
    ones."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = (flops / BF16_FLOP_PER_S + int8_ops / INT8_OP_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def trimmed_mean(ms):
    kept = sorted(ms)[1:-1]
    return sum(kept) / len(kept)


def time_versions(label: str, fns: dict, x, identical: bool = True):
    """Phase-4 method for versions of one function: blocks of ``timed_runs``
    in the order given, then in reverse (plain, kernel, kernel, plain);
    returns each version's mean of its two trimmed means, after checking
    that every run of a version gave one checksum and, if ``identical``,
    that all versions gave the same one."""
    blocks = {}
    for name in [*fns, *reversed(list(fns))]:
        ms, sums = timed_runs(fns[name], x)
        blocks.setdefault(name, []).append((trimmed_mean(ms), sums))
        print(f"{label} {name}: trimmed mean {trimmed_mean(ms):.4f} ms "
              f"(runs {[round(t, 4) for t in ms]})")
    checksums = {}
    for name, runs in blocks.items():
        sums = set().union(*(s for _, s in runs))
        check(len(sums) == 1, f"{label}: {name} output changed: {sums}")
        checksums[name] = sums.pop()
    print(f"{label}: output checksums {checksums}")
    check(not identical or len(set(checksums.values())) == 1,
          f"{label}: versions' checksums differ")
    return {name: sum(t for t, _ in runs) / 2 for name, runs in blocks.items()}


def build_all():
    """Start every build at once (one nvcc per kernel source, g++ for the
    native runtime); return the seconds each took."""
    from concurrent.futures import ThreadPoolExecutor

    from lz4jpeg_tpu_torch.native import native_backend
    from lz4jpeg_tpu_torch.ops import (
        fused_match,
        fwd_megakernel,
        inv_megakernel,
        lz4_parse,
        lz4t_decode,
        pack16,
        stream,
    )
    from lz4jpeg_tpu_torch.profiles import (
        bitonic_sort,
        bucket_partition,
        casts,
        dct_gates,
        mcu_relayout,
        megakernel,
        mcu,
        onehot_gather,
        pallas_color,
        plane_color,
        rle,
        rle_decode,
        rle_expand,
        sublane_rle,
    )

    builds = {
        "nvcc fwd_megakernel": fwd_megakernel.load_kernel,
        "nvcc inv_megakernel": inv_megakernel.load_kernel,
        "nvcc match_kernel": fused_match.load_kernel,
        "nvcc lz4_parse_kernel": lz4_parse.load_kernel,
        "nvcc resolve_kernel": lz4t_decode.load_kernel,
        "nvcc pack16_kernel": pack16.load_pack_kernels,
        "nvcc expand16_kernel": pack16.load_expand_kernels,
        "nvcc expand16_wide_kernel": pack16.load_wide_kernel,
        "nvcc stream_copy_kernel": stream.load_kernel,
        "nvcc mcu_transform_kernel": mcu.load_kernel,
        "nvcc rle_compact_kernel": rle.load_kernel,
        "nvcc plane_color_kernel": plane_color.load_kernel,
        "nvcc fwd_probe_kernel": megakernel.load_kernel,
        "nvcc bitonic_sort_kernel": bitonic_sort.load_kernel,
        "nvcc stage_rate_kernel": bucket_partition.load_kernel,
        "nvcc rle_membership_kernel": rle_decode.load_kernel,
        "nvcc rle_expand_copy_kernel": rle_expand.load_copy_kernels,
        "nvcc expand16_probe_kernel": rle_expand.load_phase_kernels,
        "nvcc sublane_rle_kernel": sublane_rle.load_kernel,
        "nvcc cast_kernel": casts.load_kernel,
        "nvcc dct_gate_kernel": dct_gates.load_kernel,
        "nvcc rgb_color_probe_kernel": pallas_color.load_kernel,
        "nvcc mcu_relayout_kernel": mcu_relayout.load_kernel,
        "nvcc onehot_gather_kernel": onehot_gather.load_kernel,
        "g++ lz4core": native_backend,
    }

    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in builds.items()}
        return {name: f.result() for name, f in futures.items()}


def lz4_phases(dev):
    """Phases 5-8 (the LZ4T codec); returns the K2 and K3 kernel records,
    phase 6's 32 MiB input and its frame, and K10's launches in phase
    6's encode."""
    import torch

    from lz4jpeg_tpu_torch import LZ4Codec, LZ4Config
    from lz4jpeg_tpu_torch.formats.fast_frame import (
        assemble_frame,
        verify_frame_checksum,
    )
    from lz4jpeg_tpu_torch.models.lz4 import densify_records, fetch_records
    from lz4jpeg_tpu_torch.native import native_backend
    from lz4jpeg_tpu_torch.ops.fused_match import (
        match_candidates,
        match_candidates_ref,
        parse_candidates,
    )
    from lz4jpeg_tpu_torch.ops.lz4_fast import (
        TPU_BLOCK_LOG,
        compact_parse,
        pad_blocks_fast,
    )
    from lz4jpeg_tpu_torch.ops.lz4t_decode import (
        _trim_rows,
        build_copy_program_fast,
        resolve_rooted,
        resolve_rooted_ref,
        root_program,
    )
    from lz4jpeg_tpu_torch.utils.inputs import (
        MATCH_BLOCK_KINDS,
        crafted_match_blocks,
        generate_text,
    )

    rng = np.random.default_rng(SEED)
    t = time.perf_counter()
    text = generate_text(TEXT_BYTES, rng)
    print(f"phase 5: generated {len(text)} bytes of text in "
          f"{time.perf_counter() - t:.2f} s")
    p = 1 << TPU_BLOCK_LOG
    native = native_backend()

    # ---- phase 5: K2 against plain, on the card ---------------------------
    padded, lengths = pad_blocks_fast(text[: (MATCH_BLOCKS - 1) * p + 9000])
    blocks = np.concatenate([
        padded.astype(np.uint8),
        rng.integers(0, 256, (1, p), dtype=np.uint8),  # uniform noise
    ])
    lengths = np.append(lengths, p).astype(np.int32)
    x = torch.from_numpy(blocks).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    k2_err = 0
    for stride in (1, 2, 4):
        for words in (2, 4):
            got = match_candidates(x, lens, stride, words)
            want = match_candidates_ref(x, lens, stride, words)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            k2_err = max(k2_err, err)
            print(f"phase 5: K2 stride {stride} lcp {words}: kernel vs plain "
                  f"{'identical' if torch.equal(got, want) else 'DIFFERENT'} "
                  f"({got.shape[0]}x{got.shape[1]} words, "
                  f"{int((got != 0).sum())} candidates, max |d| {err})")
            check(torch.equal(got, want),
                  f"K2 differs from plain at stride {stride} lcp {words}")
    # The crafted blocks at 16 KiB, then with blocks of text at P = anchors ·
    # stride for SMALL_ANCHORS anchors per block.
    crafted = crafted_match_blocks(p, np.random.default_rng(SEED + 5))
    small_rng = np.random.default_rng(SEED + 6)
    for stride in (1, 2, 4):
        sets = [(p, *crafted)]
        for anchors in SMALL_ANCHORS:
            q = anchors * stride
            c, c_lens = crafted_match_blocks(q, small_rng)
            t, t_lens = pad_blocks_fast(generate_text(3 * q + 1, small_rng),
                                        q.bit_length() - 1)
            sets.append((q, np.concatenate([c, t.astype(np.uint8)]),
                         np.concatenate([c_lens, t_lens])))
        for q, blocks_q, lens_q in sets:
            x = torch.from_numpy(blocks_q).to(dev)
            lens = torch.from_numpy(lens_q).to(dev)
            for words in (1, 4):
                got = match_candidates(x, lens, stride, words)
                want = match_candidates_ref(x, lens, stride, words)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                k2_err = max(k2_err, err)
                counts = (got != 0).sum(dim=1).tolist()
                kinds = dict(zip(MATCH_BLOCK_KINDS, counts))
                if q != p:
                    kinds["text"] = counts[len(MATCH_BLOCK_KINDS):]
                print(f"phase 5: K2 crafted blocks P {q} ({q // stride} anchors) "
                      f"stride {stride} lcp {words}: "
                      f"{'identical' if torch.equal(got, want) else 'DIFFERENT'} "
                      f"(candidates per block {kinds}, max |d| {err})")
                check(torch.equal(got, want),
                      f"K2 differs from plain on crafted blocks of {q} bytes at "
                      f"stride {stride} lcp {words}")
    del x, lens, got, want

    # ---- phase 6: the LZ4T main path --------------------------------------
    data = text[:MAIN_BYTES]
    codec = LZ4Codec(LZ4Config(mode="fast"), device=dev)
    match_candidates.launches = 0
    parse_candidates.launches = 0
    resolve_rooted.launches = 0
    frame = codec.encode(data, engine="device")
    decoded = codec.decode(frame, engine="device")
    torch.cuda.synchronize()
    k2_launches = match_candidates.launches
    k10_launches = parse_candidates.launches
    k3_launches = resolve_rooted.launches
    check(k2_launches > 0, "the LZ4T encode never launched the match kernel")
    check(k10_launches == 1,
          f"the LZ4T encode launched the parse kernel K10 {k10_launches} "
          "times, not once (one _device_fast_encode)")
    check(k3_launches > 0, "the LZ4T decode never launched the resolve kernel")
    check(decoded == data, "device decode does not return the input")
    check(codec.decode(frame, engine="native") == data,
          "native decode does not return the input")
    t = time.perf_counter()
    cpu_frame = LZ4Codec(LZ4Config(mode="fast"), device="cpu").encode(
        data, engine="device")
    cpu_s = time.perf_counter() - t
    check(frame == cpu_frame, "the card's LZ4T frame differs from the CPU's")
    print(f"phase 6: launches K2 {k2_launches}, K10 {k10_launches}, K3 "
          f"{k3_launches}; frame "
          f"byte-identical to the CPU codec's (plain K2, {cpu_s:.2f} s); "
          f"device and native decode return the input; {len(data)} B -> "
          f"{len(frame)} B (ratio {len(frame) / len(data):.4f}; native "
          f"encoder {len(native.encode_fast(data))} B)")

    # ---- phase 7: K3 against plain, on the card ---------------------------
    big_frame = native.encode_fast(text)
    # The 128 MiB program comes last: phase 8 times K3 on it.
    programs = {"32 MiB device (16 KiB blocks)": frame,
                "128 MiB native (64 KiB blocks)": big_frame}
    k3_err = 0
    for name, f in programs.items():
        lit, src, _, _, depth = build_copy_program_fast(f, depth_cap=1)
        lit_d = torch.from_numpy(lit).to(dev)
        root_d = root_program(torch.from_numpy(src).to(dev))
        got = resolve_rooted(lit_d, root_d)
        want = resolve_rooted_ref(lit_d, root_d)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        k3_err = max(k3_err, err)
        print(f"phase 7: K3 {name}: kernel vs plain "
              f"{'identical' if torch.equal(got, want) else 'DIFFERENT'} "
              f"({lit.shape[0]}x{lit.shape[1]} bytes, depth {depth}, "
              f"max |d| {err})")
        check(torch.equal(got, want), f"K3 differs from plain on {name}")
    big_lit, root_big = lit_d, root_d
    del lit, src, lit_d, root_d, got, want

    # ---- phase 8: times on the card ----------------------------------------
    padded, lengths = pad_blocks_fast(data)
    main_in = (torch.from_numpy(padded.astype(np.uint8)).to(dev),
               torch.from_numpy(lengths).to(dev))
    t = time_versions(
        "phase 8: K2 2048x16KiB stride 1 lcp 4",
        {"plain": lambda t: match_candidates_ref(t[0], t[1], 1, 4),
         "kernel": lambda t: match_candidates(t[0], t[1], 1, 4)},
        main_in,
    )
    k2_ms, k2_plain_ms = t["kernel"], t["plain"]
    mb = len(data) / 1e6
    pa = main_in[0].shape[1]
    k2_bound = bound(main_in[0].numel() + main_in[1].numel() * 4
                     + main_in[0].shape[0] * pa * 4)
    print(f"phase 8: K2 2048x16KiB: kernel {k2_ms:.4f} ms "
          f"({mb / k2_ms * 1e3:.1f} MB/s), plain {k2_plain_ms:.4f} ms "
          f"({mb / k2_plain_ms * 1e3:.1f} MB/s); bound {k2_bound[0]:.4f} ms "
          f"({k2_bound[1]}), "
          f"{k2_bound[0] / k2_ms:.1%} of it")
    root_long = root_big.long()
    t = time_versions(
        "phase 8: K3 128 MiB (2048x64KiB)",
        {"plain": lambda t: resolve_rooted_ref(*t),
         "library": lambda t: torch.gather(t[0], 1, root_long),
         "kernel": lambda t: resolve_rooted(*t)},
        (big_lit, root_big),
    )
    k3_ms, k3_plain_ms, k3_lib_ms = t["kernel"], t["plain"], t["library"]
    big_mb = big_lit.numel() / 1e6
    k3_bound = bound(big_lit.numel() * 2 + root_big.numel() * 4)
    print(f"phase 8: K3 128 MiB: kernel {k3_ms:.4f} ms "
          f"({big_mb / k3_ms * 1e3:.1f} MB/s), plain {k3_plain_ms:.4f} ms "
          f"({big_mb / k3_plain_ms * 1e3:.1f} MB/s), torch.gather "
          f"{k3_lib_ms:.4f} ms; bound {k3_bound[0]:.4f} ms ({k3_bound[1]}), "
          f"{k3_bound[0] / k3_ms:.1%} of it")
    del main_in, big_lit, root_big, root_long

    for label, fn in (("encode", lambda: codec.encode(data, engine="device")),
                      ("decode", lambda: codec.decode(frame, engine="device"))):
        runs = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t)
        med = sorted(runs)[1]
        print(f"phase 8: LZ4T {label} 32 MiB end to end: median "
              f"{med * 1e3:.3f} ms = {mb / med:.1f} MB/s "
              f"(runs ms {[round(r * 1e3, 3) for r in runs]})")

    split = Stopwatch()
    padded, lengths = pad_blocks_fast(data, TPU_BLOCK_LOG)
    data_u8 = padded.astype(np.uint8)
    split.mark("pad")
    blocks_d = torch.from_numpy(data_u8).to(dev)
    lens_d = torch.from_numpy(lengths).to(dev)
    split.mark("H2D")
    packed = match_candidates(blocks_d, lens_d, 1, 4)
    split.mark("K2")
    before = parse_candidates.launches
    fields = parse_candidates(packed, lens_d, p)
    split.mark("K10 parse")
    check(parse_candidates.launches == before + 1,
          "the staged parse did not launch K10 once")
    records = fetch_records(*compact_parse(*fields), p)
    split.mark("compact + D2H")
    raws = [data_u8[i, : int(n)].tobytes() for i, n in enumerate(lengths)]
    staged_frame = assemble_frame(
        native.emit_blocks(data_u8, lengths, *densify_records(*records, p)),
        raws, len(data), TPU_BLOCK_LOG,
    )
    split.mark("native emit")
    split.report("phase 8: LZ4T encode 32 MiB staged ms")
    check(staged_frame == frame, "staged encode differs from the codec's")
    del blocks_d, lens_d, packed, fields

    split = Stopwatch()
    lit, src, raw_sizes, _, _ = build_copy_program_fast(frame, depth_cap=1)
    split.mark("copy-program build")
    lit_d = torch.from_numpy(lit).to(dev)
    src_d = torch.from_numpy(src).to(dev)
    split.mark("H2D")
    out_d = resolve_rooted(lit_d, root_program(src_d))
    split.mark("K3")
    out = out_d.cpu().numpy()
    split.mark("D2H")
    staged_bytes = _trim_rows(out, raw_sizes)
    verify_frame_checksum(frame, staged_bytes)
    split.mark("checksum")
    split.report("phase 8: LZ4T decode 32 MiB staged ms")
    check(staged_bytes == data, "staged decode does not return the input")

    return [{
        "name": "match_kernel",
        "route": "cuda",
        "source": MATCH_SOURCE,
        "replaces": MATCH_REPLACES,
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": None,
    }, {
        "name": "resolve_kernel",
        "route": "cuda",
        "source": RESOLVE_SOURCE,
        "replaces": RESOLVE_REPLACES,
        "launches": k3_launches,
        "max_abs_err": k3_err,
        "ms": k3_ms,
        "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound[0],
        "bound_by": k3_bound[1],
        "library_ms": k3_lib_ms,
    }], data, frame, k10_launches


def envelope(label: str, got, want):
    """Max |Δ| and the largest share of differing pixels of each pair of
    decoded frames; fails outside the fast-path envelope (≤ 3, ≤ 2e-3)."""
    worst, share = 0, 0.0
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        check(a.shape == b.shape, f"{label}: shapes {a.shape} vs {b.shape}")
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        worst = max(worst, int(diff.max()))
        share = max(share, float((diff != 0).mean()))
    check(worst <= 3 and share <= 2e-3,
          f"{label}: max |d| {worst}, differing share {share:.3g}")
    return f"max |d| {worst}, differing share {share:.3g}"


def pair_phases(dev, frames, containers, decoded):
    """Phases 9-12 (the pair layouts); returns the K4-K7 kernel records,
    phase 10's packed16 encodes and their K6 decode.  ``frames``,
    ``containers`` and ``decoded`` are phase 3's four 2048² frames, their
    sparse16 containers and the card's decode of them."""
    import dataclasses

    import torch

    from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
    from lz4jpeg_tpu_torch.formats.jpeg_container import (
        pack_container,
        unpack_container,
    )
    from lz4jpeg_tpu_torch.models.jpeg import (
        CHANNELS,
        _CHANNEL_SHAPES,
        _layout_of,
        scaled_tables,
    )
    from lz4jpeg_tpu_torch.ops import pack16
    from lz4jpeg_tpu_torch.ops.color import (
        chroma_subsample_422,
        rgb_to_ycbcr,
        ycbcr_planes_to_rgb,
        ycbcr_to_rgb_mcus,
    )
    from lz4jpeg_tpu_torch.ops.fused import (
        fused_forward_plane,
        fused_inverse,
        fused_inverse_plane,
    )
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import (
        CHANNEL_SLICES,
        forward_combined,
    )
    from lz4jpeg_tpu_torch.ops.rle import (
        packed16_to_sparse16,
        rle_decode_packed16,
        rle_decode_sparse16,
    )
    from lz4jpeg_tpu_torch.utils.inputs import crafted_packed16_rows
    from lz4jpeg_tpu_torch.utils.parity import combined_of, sum_order_flips

    rng = np.random.default_rng(SEED + 9)
    tables = scaled_tables(None)
    lum, chroma = tables["lum"], tables["r"]
    wrappers = {name: getattr(pack16, attr) for name, attr, _, _ in PAIR_KERNELS}
    refs = {name: getattr(pack16, f"{attr}_ref") for name, attr, _, _ in PAIR_KERNELS}
    errs = dict.fromkeys(wrappers, 0)

    def same(name, what, *args):
        got, want = wrappers[name](*args), refs[name](*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        ok = all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
        errs[name] = max(errs[name], err)
        print(f"phase 9: {name} {what}: kernel vs plain "
              f"{'identical' if ok else 'DIFFERENT'} (max |d| {err})")
        check(ok, f"{name} differs from its plain version on {what}")
        return got

    # ---- phase 9: K4-K7 against plain, on the card -------------------------
    x = torch.from_numpy(noise(CHECK_FRAMES, SIDE, SIDE, rng, runs=True)).to(dev)
    comb = forward_combined(x, lum, chroma)
    del x
    bw = SIDE // 8
    for c in CHANNELS:
        sl = CHANNEL_SLICES[c]
        k = sl.stop - sl.start
        vals = rle_decode_sparse16(comb[:, sl]).to(torch.int16)
        n = vals.shape[0]
        words, lens = same("pack16_rows", f"{c} {n}x{k} int16", vals)
        same("pack16_rows", f"{c} {n}x{k} int32", vals.int())
        kt = vals.reshape(n // bw, bw, k).transpose(1, 2).contiguous()
        kt_words, kt_lens = same("pack16_kt", f"{c} KT {tuple(kt.shape)}", kt)
        check(torch.equal(kt_words, words) and torch.equal(kt_lens, lens),
              f"{c}: K5 words differ from K4's")
        (dec,) = same("expand16_rows", f"{c} {n}x{k}", words, lens, k)
        check(torch.equal(dec, vals.int()), f"{c}: K6 does not give K4's input")
        same("expand16_plane", f"{c} plane bw {bw}", words, lens, bw)
        cw, cl = crafted_packed16_rows(k, rng, n_random=4084)
        cw, cl = torch.from_numpy(cw).to(dev), torch.from_numpy(cl).to(dev)
        for out_size in sorted({k, k // 2, min(64, k + 9)}):
            same("expand16_rows", f"{c} crafted rows, out_size {out_size}",
                 cw, cl, out_size)
        same("expand16_plane", f"{c} crafted rows, bw 64", cw, cl, 64)
    del comb, vals, words, lens, kt, kt_words, kt_lens, dec
    # The tiling edges: K4 on row counts off its warp step and on offset
    # views, in int16 and int32; K7 on widths around its tile, also with
    # the words and lengths in offset views.
    for k in EDGE_SEGS:
        vals = torch.from_numpy(runny_values(max(EDGE_ROWS), k, rng)).to(dev)
        for dtype in (torch.int16, torch.int32):
            x = vals.to(dtype)
            for n in EDGE_ROWS:
                same("pack16_rows", f"edge {n}x{k} {str(dtype)[6:]}", x[:n])
            same("pack16_rows", f"edge {n}x{k} {str(dtype)[6:]} offset view",
                 offset_view(x))
        cw, cl = crafted_packed16_rows(k, rng, n_random=1300)
        cw, cl = torch.from_numpy(cw).to(dev), torch.from_numpy(cl).to(dev)
        for bw in EDGE_WIDTHS:
            n = (cw.shape[0] // bw) * bw
            same("expand16_plane", f"edge K {k}, {n} crafted rows, bw {bw}",
                 cw[:n], cl[:n], bw)
            same("expand16_plane", f"edge K {k}, bw {bw}, offset views",
                 offset_view(cw[:n]), offset_view(cl[:n]), bw)
    del vals, x, cw, cl
    print(f"phase 9: ok, max |d| {errs}")

    # ---- phase 10: the packed16 path ---------------------------------------
    pipe = JPEGPipeline(JPEGConfig(), device=dev)
    cpu = JPEGPipeline(JPEGConfig(), device="cpu")
    encs = pipe.encode_batch(frames, entropy=False)
    for w in wrappers.values():
        w.launches = 0
    packed = [pipe.entropy_encode(e) for e in pipe.to_packed16(encs)]
    p_containers = [pack_container(e) for e in packed]
    p_decoded = pipe.decode_batch(packed)
    x = torch.from_numpy(frames).to(dev)
    y, cr, cb = rgb_to_ycbcr(x)
    planes = {"lum": y, "r": chroma_subsample_422(cr), "b": chroma_subsample_422(cb)}
    b, h, w = frames.shape[:3]
    plane_out, plane_sparse = {}, []
    for c in CHANNELS:
        tw = _CHANNEL_SHAPES[c][1]
        zz_kt = fused_forward_plane(planes[c], tables[c], tw).to(torch.int16)
        kt_words, kt_lens = pack16.pack16_encode_kt(zz_kt)
        back = pack16.pack16_decode_plane(kt_words, kt_lens, zz_kt.shape[2])
        plane_out[c] = fused_inverse_plane(
            back, tables[c], tw, upsample_cols=(c != "lum")).reshape(b, h, w)
        plane_sparse.append((kt_words.cpu(), kt_lens.cpu()))
    plane_rgb = ycbcr_planes_to_rgb(
        plane_out["lum"], plane_out["r"], plane_out["b"], h, w).cpu().numpy()
    torch.cuda.synchronize()
    launches = {name: wr.launches for name, wr in wrappers.items()}
    del x, y, cr, cb, planes, zz_kt, back, plane_out
    print(f"phase 10: launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"the packed16 path never launched {name}")
    check(p_containers == containers,
          "packed16 containers differ from phase 3's sparse16 containers")
    print("phase 10: packed16 containers byte-identical to phase 3's sparse16 "
          f"containers ({sum(map(len, p_containers))} bytes)")
    cpu_p_decoded = cpu.decode_batch(packed)
    print("phase 10: packed16 decode (K6) vs the CPU port's packed16 decode: "
          + envelope("packed16 vs CPU packed16", p_decoded, cpu_p_decoded))
    print("phase 10: packed16 decode vs phase 3's sparse16 decode: "
          + envelope("packed16 vs phase 3", p_decoded, decoded))
    # K5 on the plane forward (cuBLAS) against K4 on K1's coefficients:
    # identical, or apart only by admissible sum-order flips.
    k4_words = {c: np.concatenate([e.rle[c] for e in packed]) for c in CHANNELS}
    same_words = all(
        np.array_equal(words.numpy().view(np.uint16), k4_words[c])
        for c, (words, _) in zip(CHANNELS, plane_sparse))
    plane_comb = torch.cat(
        [packed16_to_sparse16(*wl)[0] for wl in plane_sparse], dim=1).numpy()
    flips = sum_order_flips(
        frames, plane_comb, np.concatenate([e.rle_combined for e in encs]),
        lum, chroma)
    check(same_words or flips <= MAX_FLIP_SHARE * plane_comb.size,
          f"K5 words differ from K4's by {flips} flips")
    # A flipped coefficient moves its block by up to a table step, so the
    # plane decode (K7 → plane inverse) is held against the staged decode of
    # the same K5 words; against phase 3 only where no coefficient flipped.
    kt_encs = [dataclasses.replace(
        e, entropy_mode=None, shared_streams=None,
        rle={c: wl[0].numpy().view(np.uint16).reshape(b, -1, wl[0].shape[1])[i]
             for c, wl in zip(CHANNELS, plane_sparse)},
        rle_lengths={c: wl[1].numpy().reshape(b, -1)[i]
                     for c, wl in zip(CHANNELS, plane_sparse)},
    ) for i, e in enumerate(packed)]
    staged = cpu.decode_batch(kt_encs)
    print(f"phase 10: plane chain, K5 words vs K4 words "
          f"{'identical' if same_words else f'{flips} admissible flips'}; "
          "plane decode (K7) vs the CPU staged decode of the same words: "
          + envelope("plane chain vs staged", plane_rgb, staged))
    if same_words:
        print("phase 10: plane decode vs phase 3: "
              + envelope("plane chain vs phase 3", plane_rgb, decoded))
    else:
        diff = np.abs(np.stack(plane_rgb).astype(np.int32) - np.stack(decoded))
        print(f"phase 10: plane decode vs phase 3 (apart by the flips): max "
              f"|d| {int(diff.max())}, differing share {float((diff != 0).mean()):.3g}")
    del plane_sparse, plane_comb, kt_encs, staged

    forced = dataclasses.replace(packed[0], rle_lengths=dict(packed[0].rle_lengths))
    forced.rle_lengths["lum"] = forced.rle_lengths["lum"].copy()
    forced.rle_lengths["lum"][-1] = 0  # the stream ends one block early
    data = pack_container(pipe.entropy_encode(forced))
    card_enc = unpack_container(data)
    check(_layout_of(card_enc) == "packed16",
          f"the early-ending container took the {_layout_of(card_enc)} tier")
    before = pack16.pack16_decode.launches
    forced_rgb = pipe.decode(card_enc)
    check(pack16.pack16_decode.launches > before, "its decode never ran K6")
    print("phase 10: a container ending one block early takes the packed16 "
          "tier; card decode (K6) vs the CPU's: " + envelope(
              "forced tier", [forced_rgb], [cpu.decode(unpack_container(data))]))

    # ---- phase 11: quality 90, the int16 pair layout -----------------------
    q90 = JPEGPipeline(JPEGConfig(quality=90), device=dev)
    cpu90 = JPEGPipeline(JPEGConfig(quality=90), device="cpu")
    t90 = scaled_tables(90)
    encs90 = q90.encode_batch(frames)
    c90 = [pack_container(e) for e in encs90]
    un90 = [unpack_container(d) for d in c90]
    d90 = [q90.decode(u) for u in un90]
    direct90 = q90.decode_batch(encs90)
    torch.cuda.synchronize()
    check(all(_layout_of(e) == "pairs" for e in encs90),
          "quality 90 did not encode in the pair layout")
    cpu_encs90 = cpu90.encode_batch(frames)
    flips90 = 0
    for i, (e, ce) in enumerate(zip(encs90, cpu_encs90)):
        if c90[i] != pack_container(ce):
            flips90 += sum_order_flips(frames[i : i + 1], combined_of(e),
                                       combined_of(ce), t90["lum"], t90["r"])
    check(flips90 <= MAX_FLIP_SHARE * b * (h // 8) * (w // 8) * 128,
          f"{flips90} flips between the card's and the CPU's q90 containers")
    tiers = [_layout_of(u) for u in un90]
    print(f"phase 11: quality 90 containers "
          + ("byte-identical to the CPU pipeline's" if flips90 == 0 else
             f"equal up to {flips90} admissible flips")
          + f" ({sum(map(len, c90))} bytes for 4 frames; container tiers {tiers})")
    print("phase 11: card decode of the containers vs the CPU's: " + envelope(
        "q90", d90, [cpu90.decode(u) for u in un90]))
    print("phase 11: card decode of the pair encodes vs of the containers: "
          + envelope("q90 direct", direct90, d90))
    mse = float(np.mean((np.stack(d90).astype(np.float64) - frames) ** 2))
    print(f"phase 11: PSNR vs input {10 * np.log10(255.0 ** 2 / mse):.3f} dB "
          "(uniform noise)")
    del encs90, cpu_encs90, un90, d90, direct90

    # ---- phase 12: times on the card ----------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    big = torch.randint(0, 256, (TIME_FRAMES, SIDE, SIDE, 3), dtype=torch.uint8,
                        device=dev, generator=gen)
    comb = forward_combined(big, lum, chroma)
    del big
    # (record name, channel, input dtype, arguments, bytes it must move):
    # luma (K = 64) and Cr chroma (K = 32); K4 also fed int32, as
    # to_packed16 feeds it.
    cases = []
    bw = SIDE // 8
    for channel, c in (("luma", "lum"), ("chroma", "r")):
        sl = CHANNEL_SLICES[c]
        k = sl.stop - sl.start
        vals = rle_decode_sparse16(comb[:, sl]).to(torch.int16)
        n = vals.shape[0]
        words, lens = pack16.pack16_encode(vals)
        cases += [
            ("pack16_rows", channel, "int16", (vals,), n * k * 4 + n * 4),
            ("pack16_rows", channel, "int32", (vals.int(),), n * k * 6 + n * 4),
        ]
        if channel == "luma":
            kt = vals.reshape(-1, bw, k).transpose(1, 2).contiguous()
            cases += [
                ("pack16_kt", channel, "int16", (kt,), n * k * 4 + n * 4),
                ("expand16_rows", channel, "int16", (words, lens, k),
                 n * k * 6 + n * 4),
            ]
        cases.append(("expand16_plane", channel, "int16", (words, lens, bw),
                      n * k * 4 + n * 4))
    del comb, vals, words, lens, kt
    times = []
    for name, channel, dtype, a, io in cases:
        label = f"{name} {channel} {dtype} {SIDE}x{SIDE} b{TIME_FRAMES}"
        t = time_versions(
            f"phase 12: {label}",
            {"plain": lambda t, f=refs[name]: f(*t),
             "kernel": lambda t, f=wrappers[name]: f(*t)}, a)
        ms, plain_ms = t["kernel"], t["plain"]
        times.append((name, channel, dtype, ms, plain_ms, io))
        print(f"phase 12: {label}: kernel {ms:.4f} ms "
              f"({io / ms / 1e6:.1f} GB/s of {io} bytes), "
              f"plain {plain_ms:.4f} ms; bound {bound(io)[0]:.4f} ms, "
              f"{bound(io)[0] / ms:.1%} of it")
    del cases, a

    frame = frames[:1]
    for label, trip in (
        ("packed16", lambda: pipe.decode(pipe.entropy_encode(
            pipe.to_packed16(pipe.encode_batch(frame, entropy=False))[0]))),
        ("quality 90", lambda: q90.decode(unpack_container(pack_container(
            q90.encode(frame[0]))))),
    ):
        runs = []
        for _ in range(6):
            t = time.perf_counter()
            trip()
            runs.append((time.perf_counter() - t) * 1e3)
        runs = sorted(runs[1:])
        print(f"phase 12: round trip {label} 2048x2048: median "
              f"{runs[len(runs) // 2]:.3f} ms (runs {[round(r, 3) for r in runs]})")

    split = Stopwatch()
    (enc,) = pipe.encode_batch(frame, entropy=False)
    split.mark("K1 forward + D2H")
    (p,) = pipe.to_packed16([enc])
    split.mark("H2D + K4 + D2H")
    pipe.entropy_encode(p)
    split.mark("entropy encode (host)")
    pack_container(p)
    split.mark("container")
    rle, lengths = pipe.entropy_decode(p)
    split.mark("entropy decode (host)")
    rle_d = {c: torch.from_numpy(rle[c].view(np.int16)).to(dev) for c in CHANNELS}
    len_d = {c: torch.from_numpy(lengths[c]).to(dev) for c in CHANNELS}
    split.mark("H2D")
    zz = {c: rle_decode_packed16(rle_d[c], len_d[c], rle_d[c].shape[1])
          for c in CHANNELS}
    split.mark("K6")
    tiles = {c: fused_inverse(zz[c], tables[c], _CHANNEL_SHAPES[c][1], 8)
             for c in CHANNELS}
    rgb = ycbcr_to_rgb_mcus(tiles["lum"], tiles["r"], tiles["b"],
                            enc.blocks_per_col, enc.blocks_per_row, h, w)
    split.mark("inverse + color")
    rgb = rgb.cpu().numpy()
    split.mark("D2H")
    split.report("phase 12: packed16 round trip 2048x2048 staged ms")
    envelope("staged packed16", [rgb], [p_decoded[0]])

    split = Stopwatch()
    (e90,) = q90.encode_batch(frame, entropy=False)
    split.mark("H2D + forward + pair RLE + D2H")
    q90.entropy_encode(e90)
    split.mark("entropy encode (host)")
    data = pack_container(e90)
    split.mark("container")
    u90 = unpack_container(data)
    split.mark(f"unpack ({_layout_of(u90)} tier)")
    q90.decode(u90)
    split.mark("decode")
    split.report("phase 12: quality 90 round trip 2048x2048 staged ms")

    source = {name: (src, rep) for name, _, src, rep in PAIR_KERNELS}
    return [{
        "name": name,
        "route": "cuda",
        "source": source[name][0],
        "replaces": source[name][1],
        "channel": channel,
        "dtype": dtype,
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound(io)[0],
        "bound_by": bound(io)[1],
        "library_ms": None,
    } for name, channel, dtype, ms, plain_ms, io in times], packed, p_decoded


def wide_phase(dev, packed, p_decoded):
    """Phase 13 (K8); returns its kernel record.  ``packed`` and
    ``p_decoded`` are phase 10's packed16 encodes and their K6 decode."""
    import torch

    from lz4jpeg_tpu_torch.models.jpeg import (
        CHANNELS,
        _CHANNEL_SHAPES,
        scaled_tables,
    )
    from lz4jpeg_tpu_torch.ops import pack16
    from lz4jpeg_tpu_torch.ops.color import ycbcr_to_rgb_mcus
    from lz4jpeg_tpu_torch.ops.fused import fused_inverse
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import (
        CHANNEL_SLICES,
        forward_combined,
    )
    from lz4jpeg_tpu_torch.ops.rle import rle_decode_sparse16
    from lz4jpeg_tpu_torch.utils.inputs import crafted_packed16_rows

    tables = scaled_tables(None)
    wide, wide_ref = pack16.pack16_decode_wide, pack16.pack16_decode_wide_ref
    err = 0

    def same(what, got, want):
        nonlocal err
        torch.cuda.synchronize()
        d = int((got.int() - want.int()).abs().max())
        err = max(err, d)
        ok = got.dtype == want.dtype == torch.int16 and torch.equal(got, want)
        print(f"phase 13: K8 {what}: {'identical' if ok else 'DIFFERENT'} "
              f"(max |d| {d})")
        check(ok, f"K8 differs on {what}")

    # Phase 9's frames (same seed, same draw) and crafted rows: word 0 valid
    # mid-row, count sums below and above K (runs that start past the last
    # slot), lengths shorter than the nonzero words.
    rng = np.random.default_rng(SEED + 9)
    x = torch.from_numpy(noise(CHECK_FRAMES, SIDE, SIDE, rng, runs=True)).to(dev)
    comb = forward_combined(x, tables["lum"], tables["r"])
    del x
    for c in CHANNELS:
        sl = CHANNEL_SLICES[c]
        k = sl.stop - sl.start
        vals = rle_decode_sparse16(comb[:, sl]).to(torch.int16)
        words, lens = pack16.pack16_encode(vals)
        got = wide(words, lens)
        same(f"{c} {vals.shape[0]}x{k} vs plain", got, wide_ref(words, lens))
        check(torch.equal(got, vals), f"{c}: K8 does not give K4's input")
        cw, cl = crafted_packed16_rows(k, rng, n_random=4084)
        cw, cl = torch.from_numpy(cw).to(dev), torch.from_numpy(cl).to(dev)
        same(f"{c} crafted rows vs plain", wide(cw, cl), wide_ref(cw, cl))
        same(f"{c} crafted rows vs K6", wide(cw, cl),
             pack16.pack16_decode(cw, cl, k).to(torch.int16))
    del comb, vals, words, lens, got

    # Phase 10's real packed16 words, against K6.
    inputs = {}
    for c in CHANNELS:
        words = torch.from_numpy(
            np.concatenate([e.rle[c] for e in packed]).view(np.int16)).to(dev)
        lens = torch.from_numpy(np.concatenate(
            [e.rle_lengths[c] for e in packed]).astype(np.int32)).to(dev)
        same(f"{c} phase 10 words {tuple(words.shape)} vs K6", wide(words, lens),
             pack16.pack16_decode(words, lens, words.shape[1]).to(torch.int16))
        inputs[c] = (words, lens)

    # Phase 10's packed16 decode rebuilt from K8's values: K8's path, the
    # run whose launches are counted.
    e0 = packed[0]
    wide.launches = 0
    tiles = {}
    for c in CHANNELS:
        th, tw = _CHANNEL_SHAPES[c]
        tiles[c] = fused_inverse(wide(*inputs[c]), tables[c], tw, th).reshape(
            len(packed), e0.num_blocks, th, tw)
    rgb = ycbcr_to_rgb_mcus(tiles["lum"], tiles["r"], tiles["b"],
                            e0.blocks_per_col, e0.blocks_per_row,
                            e0.height, e0.width).cpu().numpy()
    torch.cuda.synchronize()
    launches = wide.launches
    check(launches > 0, "the K8 decode never launched K8")
    check(all(np.array_equal(a, b) for a, b in zip(rgb, p_decoded)),
          "the K8 decode differs from phase 10's K6 decode")
    print(f"phase 13: launches K8 {launches}; packed16 decode through K8 "
          "identical to phase 10's K6 decode")
    del inputs, tiles, rgb

    # Times: luma (K = 64) and chroma (K = 32) of 2048², batch 64.
    gen = torch.Generator(device=dev).manual_seed(SEED)
    big = torch.randint(0, 256, (TIME_FRAMES, SIDE, SIDE, 3), dtype=torch.uint8,
                        device=dev, generator=gen)
    comb = forward_combined(big, tables["lum"], tables["r"])
    del big
    times, io = {}, {}
    for c, label in (("lum", "luma"), ("r", "chroma")):
        sl = CHANNEL_SLICES[c]
        k = sl.stop - sl.start
        words, lens = pack16.pack16_encode(
            rle_decode_sparse16(comb[:, sl]).to(torch.int16))
        n = words.shape[0]
        times[label] = t = time_versions(
            f"phase 13: {label} {SIDE}x{SIDE} b{TIME_FRAMES} ({n}x{k})",
            {"plain": lambda a: wide_ref(*a), "K8": lambda a: wide(*a),
             "K6": lambda a, k=k: pack16.pack16_decode(*a, k)},
            (words, lens))
        io_k8 = n * k * 2 + n * 4 + n * k * 2  # words, lengths in; int16 out
        io_k6 = n * k * 2 + n * 4 + n * k * 4  # int32 out
        io[label] = io_k8
        print(f"phase 13: {label}: K8 {t['K8']:.4f} ms ({io_k8 / t['K8'] / 1e6:.1f}"
              f" GB/s of {io_k8} bytes), K6 {t['K6']:.4f} ms "
              f"({io_k6 / t['K6'] / 1e6:.1f} GB/s of {io_k6} bytes), plain "
              f"{t['plain']:.4f} ms; K8 bound {bound(io_k8)[0]:.4f} ms, "
              f"{bound(io_k8)[0] / t['K8']:.1%} of it")
        del words, lens
    del comb
    return {
        "name": "expand16_wide",
        "route": "cuda",
        "source": WIDE_SOURCE,
        "replaces": WIDE_REPLACES,
        "launches": launches,
        "max_abs_err": err,
        "ms": times["luma"]["K8"],
        "plain_ms": times["luma"]["plain"],
        "bound_ms": bound(io["luma"])[0],
        "bound_by": bound(io["luma"])[1],
        "library_ms": None,
    }


def median_ms(fn, runs: int):
    """Host-clock ms of ``runs`` calls of ``fn`` (each ending on the host);
    returns (median, sorted runs)."""
    ms = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t) * 1e3)
    ms.sort()
    return ms[len(ms) // 2], ms


def exact_phase(dev, frame):
    """Phase 14: exact precision (float64) on the card."""
    import torch

    from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
    from lz4jpeg_tpu_torch.formats.jpeg_container import (
        pack_container,
        unpack_container,
    )
    from lz4jpeg_tpu_torch.models.jpeg import (
        CHANNELS,
        _CHANNEL_SHAPES,
        _layout_of,
        scaled_tables,
    )
    from lz4jpeg_tpu_torch.ops.color import (
        chroma_subsample_422,
        rgb_to_ycbcr,
        split_mcus,
    )
    from lz4jpeg_tpu_torch.ops.dct import dct2_batched
    from lz4jpeg_tpu_torch.ops.quantize import zigzag_indices
    from lz4jpeg_tpu_torch.ops.zigzag import zigzag
    from lz4jpeg_tpu_torch.oracle import jpeg_oracle
    from lz4jpeg_tpu_torch.utils.parity import assert_quantized_parity

    rng = np.random.default_rng(SEED + 14)
    pipe = JPEGPipeline(JPEGConfig(precision="exact"), dev)
    cpu = JPEGPipeline(JPEGConfig(precision="exact"), "cpu")
    for h, w in ORACLE_SHAPES:
        img = noise(1, h, w, rng)[0]
        t = time.perf_counter()
        rec, ref = jpeg_oracle.jpeg_roundtrip_oracle(img, snap_ties=True)
        oracle_s = time.perf_counter() - t
        stages = pipe.forward_stages(img)
        for c in CHANNELS:
            check(stages[c]["zz"].dtype == np.float64
                  and np.array_equal(stages[c]["zz"], ref[f"zz_{c}"]),
                  f"exact {h}x{w} {c}: coefficients differ from the oracle's")
        check(np.array_equal(pipe.roundtrip(img), rec),
              f"exact {h}x{w}: round trip differs from the oracle's")
        print(f"phase 14: exact {h}x{w} on the card: forward_stages (float64) "
              f"and roundtrip identical to the oracle (oracle {oracle_s:.2f} s)")

    h, w = frame.shape[:2]
    stages, cpu_stages = pipe.forward_stages(frame), cpu.forward_stages(frame)
    tables = scaled_tables(None)
    y, cr, cb = rgb_to_ycbcr(torch.from_numpy(frame), torch.float64)
    ties = 0
    for c, tiles in zip(CHANNELS, split_mcus(y, chroma_subsample_422(cr),
                                             chroma_subsample_422(cb))):
        th, tw = _CHANNEL_SHAPES[c]
        coef = zigzag(dct2_batched(tiles, torch.float64), tw, th).numpy()
        table = np.asarray(tables[c])[zigzag_indices(tw, th)]
        ties += assert_quantized_parity(stages[c]["zz"], cpu_stages[c]["zz"],
                                        coef, table)
    enc, cpu_enc = pipe.encode(frame), cpu.encode(frame)
    data = pack_container(enc)
    same = data == pack_container(cpu_enc)
    check(same or ties > 0, "exact containers differ with no tie difference")
    dec = pipe.decode(enc)
    check(ties > 0 or np.array_equal(dec, cpu.decode(cpu_enc)),
          "exact decode differs from the CPU port's")
    print(f"phase 14: exact {h}x{w}: coefficients vs the CPU port's: {ties} "
          f"tie differences; containers "
          f"{'byte-identical' if same else 'apart by the ties'} "
          f"({len(data)} bytes); decode identical to the CPU's")

    q75 = JPEGPipeline(JPEGConfig(precision="exact", quality=75), dev)
    cpu75 = JPEGPipeline(JPEGConfig(precision="exact", quality=75), "cpu")
    img = noise(1, 256, 256, rng)[0]
    e75 = q75.encode(img)
    d75 = pack_container(e75)
    check(d75 == pack_container(cpu75.encode(img)),
          "q75 exact containers differ from the CPU's")
    un = unpack_container(d75)
    got = q75.decode(un)
    check(np.array_equal(got, q75.decode(e75))
          and np.array_equal(got, cpu75.decode(unpack_container(d75))),
          "q75 exact container decode differs")
    print(f"phase 14: quality 75 exact container ({_layout_of(un)} tier) "
          "decodes in float64 on the card identically to the encode's own "
          "decode and to the CPU port's")

    enc_ms, enc_runs = median_ms(lambda: pipe.encode(frame), 5)
    dec_ms, dec_runs = median_ms(lambda: pipe.decode(enc), 5)
    print(f"phase 14: exact {h}x{w}: encode median {enc_ms:.3f} ms (runs "
          f"{[round(t, 3) for t in enc_runs]}), decode median {dec_ms:.3f} ms "
          f"(runs {[round(t, 3) for t in dec_runs]})")


def per_block_phase(dev, frame):
    """Phase 15: per-block entropy, exact and fast."""
    from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
    from lz4jpeg_tpu_torch.models.jpeg import CHANNELS
    from lz4jpeg_tpu_torch.native import native_backend
    from lz4jpeg_tpu_torch.ops.quantize import (
        CHROMINANCE_QUANTIZATION_TABLE as CHR,
        LUMINANCE_QUANTIZATION_TABLE as LUM,
    )
    from lz4jpeg_tpu_torch.oracle import jpeg_oracle
    from lz4jpeg_tpu_torch.utils.parity import combined_of, sum_order_flips

    rng = np.random.default_rng(SEED + 15)
    img = noise(1, 64, 64, rng)[0]
    _, ref = jpeg_oracle.jpeg_roundtrip_oracle(img, snap_ties=True)
    for precision in ("exact", "fast"):
        pipe = JPEGPipeline(JPEGConfig(precision=precision,
                                       entropy="per_block"), dev)
        enc = pipe.encode(img)
        check(enc.entropy_mode == "per_block" and not enc.rle_sparse16,
              f"{precision} per_block encode is {enc.entropy_mode}")
        apart = 0
        for c in CHANNELS:
            for i, bits in enumerate(enc.per_block_bits[c]):
                rle = [int(v) for v in enc.rle[c][i, : enc.rle_lengths[c][i]]]
                if bits != ref["huff_bits"][c][i]:
                    # Only where the runs differ (a float32 flip).
                    check(rle != ref[f"rle_{c}"][i],
                          f"{precision} {c} block {i}: bits differ on equal runs")
                    apart += 1
        check(precision == "fast" or apart == 0,
              f"exact per_block bits differ from the oracle's in {apart} blocks")
        print(f"phase 15: {precision} per_block 64x64: bitstrings identical "
              f"to the oracle's huff_bits in all but {apart} blocks (of "
              f"{3 * enc.num_blocks}; differences only where float32 runs "
              f"differ); {enc.compressed_bytes()} bytes")

    native = native_backend()
    for precision in ("exact", "fast"):
        cfg = JPEGConfig(precision=precision, entropy="per_block")
        enc = JPEGPipeline(cfg, dev).encode(frame)
        cpu_enc = JPEGPipeline(cfg, "cpu").encode(frame)
        flips = sum_order_flips(frame[None], combined_of(enc),
                                combined_of(cpu_enc), LUM, CHR)
        check(precision == "fast" or flips == 0, "exact runs differ from the CPU's")
        check(flips <= MAX_FLIP_SHARE * enc.num_blocks * 128,
              f"{flips} flips between the card's and the CPU's runs")
        for c in CHANNELS:
            same_rows = (enc.rle[c] == cpu_enc.rle[c]).all(axis=1)
            for i in np.nonzero(same_rows)[0]:
                check(enc.per_block_bits[c][i] == cpu_enc.per_block_bits[c][i],
                      f"{precision} {c} block {i}: bits differ from the CPU's")
        print(f"phase 15: {precision} per_block {frame.shape[0]}x"
              f"{frame.shape[1]}: bitstrings identical to the CPU port's "
              f"({flips} admissible flips in the runs); compressed_bytes "
              f"{enc.compressed_bytes()}")
        if precision == "exact":
            ms, runs = median_ms(lambda: [native.huff_per_block(
                enc.rle[c], enc.rle_lengths[c]) for c in CHANNELS], 3)
            print(f"phase 15: native per-block pass, 3 channels of "
                  f"{enc.num_blocks} blocks: median {ms:.3f} ms (runs "
                  f"{[round(t, 3) for t in runs]})")


def entry_phase(dev, frame):
    """Phase 16: the encode entry points."""
    import torch

    from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
    from lz4jpeg_tpu_torch.formats.jpeg_container import pack_container
    from lz4jpeg_tpu_torch.native import native_backend
    from lz4jpeg_tpu_torch.ops import fwd_megakernel
    from lz4jpeg_tpu_torch.ops.quantize import (
        CHROMINANCE_QUANTIZATION_TABLE as CHR,
        LUMINANCE_QUANTIZATION_TABLE as LUM,
    )
    from lz4jpeg_tpu_torch.utils.parity import sum_order_flips

    pipe = JPEGPipeline(JPEGConfig(), dev)
    cpu = JPEGPipeline(JPEGConfig(), "cpu")
    h, w = frame.shape[:2]
    bpc, bpr = -(-h // 8), -(-w // 8)
    check(bpc * bpr >= pipe._OVERLAP_MIN_BLOCKS,
          f"{h}x{w} does not take the overlapped encode")
    over = pipe.encode(frame)
    one = pipe.encode_batch(frame[None])[0]
    cpu_enc = cpu.encode(frame)
    check(pack_container(over) == pack_container(one),
          "overlapped and one-shot containers differ")
    flips = 0
    if pack_container(one) != pack_container(cpu_enc):
        flips = sum_order_flips(frame[None], one.rle_combined,
                                cpu_enc.rle_combined, LUM, CHR)
    check(flips <= MAX_FLIP_SHARE * bpc * bpr * 128,
          f"{flips} flips between the card's and the CPU's containers")
    print(f"phase 16: {h}x{w}: overlapped encode container byte-identical to "
          "the one-shot encode_batch's; to the CPU's "
          + ("byte-identical" if flips == 0 else f"up to {flips} admissible flips"))

    fns = {"overlapped": lambda: pipe.encode(frame),
           "one-shot": lambda: pipe.encode_batch(frame[None])[0]}
    ms = {name: [] for name in fns}
    for _ in range(ENCODE_RUNS):  # in turns
        for name, fn in fns.items():
            t = time.perf_counter()
            fn()
            ms[name].append((time.perf_counter() - t) * 1e3)
    for name, runs in ms.items():
        runs.sort()
        print(f"phase 16: {name} encode {h}x{w}: median "
              f"{runs[len(runs) // 2]:.3f} ms (runs {[round(t, 3) for t in runs]})")

    x = torch.from_numpy(frame)[None].to(dev).contiguous()
    splits = []
    for _ in range(ENCODE_RUNS):
        spans, seen = {}, {}
        last = [time.perf_counter()]

        def mark(name):
            now = time.perf_counter()
            if name in ("wait", "walk"):  # one span per band
                seen[name] = seen.get(name, -1) + 1
                name = f"{name} band {seen[name]}"
            spans[name] = spans.get(name, 0.0) + (now - last[0]) * 1e3
            last[0] = now

        pipe._encode_overlapped(x, bpc, bpr, mark)
        splits.append(spans)
    print("phase 16: overlapped encode staged ms (median of "
          f"{ENCODE_RUNS} runs, host clock, no device synchronise): "
          + ", ".join(f"{k} {float(np.median([s[k] for s in splits])):.3f}"
                      for k in splits[0]))
    split = Stopwatch()
    (enc,) = pipe.encode_batch(frame[None], entropy=False)
    split.mark("K1 forward + D2H")
    pipe.entropy_encode(enc)
    split.mark("entropy encode (host)")
    split.report(f"phase 16: one-shot encode {h}x{w} staged ms")

    rng = np.random.default_rng(SEED + 16)
    n_flips = n_coeffs = 0
    for bh, bw_ in BUCKET_SHAPES:
        img = frame if (bh, bw_) == (h, w) else noise(1, bh, bw_, rng)[0]
        e = pipe.encode(img)
        eb = pipe.encode_bucketed(img)
        f = 0
        if pack_container(eb) != pack_container(e):
            f = sum_order_flips(img[None], eb.rle_combined, e.rle_combined, LUM, CHR)
        n_flips += f
        n_coeffs += e.num_blocks * 128
        print(f"phase 16: {bh}x{bw_}: encode_bucketed (cuBLAS forward) vs "
              f"encode (K1): {f} admissible flips; decode_bucketed vs decode: "
              + envelope(f"bucketed {bh}x{bw_}", [pipe.decode_bucketed(e)],
                         [pipe.decode(e)]))
    check(n_flips <= MAX_FLIP_SHARE * n_coeffs,
          f"{n_flips} flips between encode_bucketed and encode")

    loaders = {"native": native_backend, "K1": fwd_megakernel.load_kernel}
    for loader in loaders.values():
        loader.cache_clear()
    fresh = JPEGPipeline(JPEGConfig(), dev)
    fresh.warmup([(h, w)])
    warm = {k: f.cache_info().misses for k, f in loaders.items()}
    fresh.encode(frame)
    after = {k: f.cache_info().misses for k, f in loaders.items()}
    check(warm == after and set(warm.values()) == {1},
          f"warmup left builds to the encode: {warm} -> {after}")
    print(f"phase 16: warmup built {warm}; the encode after it built nothing "
          f"more ({after})")


def parity_phase(dev):
    """Phase 17: LZ4 parity mode on the card (the match tables and the
    greedy parse as K11, the pointer-doubling decode as torch ops).
    Returns K11's launches in the encode of the largest frame (76,500 B,
    255 blocks)."""
    import torch

    from lz4jpeg_tpu_torch import LZ4Codec, LZ4Config
    from lz4jpeg_tpu_torch.formats.lz4_frame import pack_frame, unpack_frame
    from lz4jpeg_tpu_torch.models.lz4 import _build_sequences
    from lz4jpeg_tpu_torch.native import native_backend
    from lz4jpeg_tpu_torch.ops.lz4_decode import (
        build_copy_program,
        doubling_steps,
        resolve_copies,
    )
    from lz4jpeg_tpu_torch.ops.lz4_parse import parity_parse
    from lz4jpeg_tpu_torch.ops.match import pad_blocks
    from lz4jpeg_tpu_torch.oracle import lz4_encode_oracle
    from lz4jpeg_tpu_torch.utils.inputs import generate_text

    text = generate_text(max(n for n, _ in PARITY_SIZES),
                         np.random.default_rng(SEED))
    native = native_backend()

    def staged_encode(data, block_length):
        watch = Stopwatch()
        padded, lengths = pad_blocks(data, block_length)
        x = torch.from_numpy(padded).to(dev)
        watch.mark("pad + H2D")
        is_match, emit_len, emit_dist = parity_parse(x)
        watch.mark("K11 (match tables + greedy parse)")
        fields = torch.stack([is_match.int(), emit_len, emit_dist]).cpu().numpy()
        watch.mark("D2H")
        blocks = [_build_sequences(data[i * block_length : (i + 1) * block_length],
                                   *fields[:, i], int(n))
                  for i, n in enumerate(lengths)]
        watch.mark("_build_sequences (host)")
        frame = pack_frame(blocks)
        watch.mark("pack_frame (host)")
        return frame, watch.spans

    def staged_decode(frame):
        watch = Stopwatch()
        lit, src = build_copy_program(unpack_frame(frame))
        watch.mark("unpack + copy program (host)")
        lit_d, src_d = torch.from_numpy(lit).to(dev), torch.from_numpy(src).to(dev)
        watch.mark("H2D")
        out = resolve_copies(lit_d, src_d, doubling_steps(len(lit)))
        watch.mark("resolve_copies")
        data = out.cpu().numpy().tobytes()
        watch.mark("D2H")
        return data, watch.spans

    def median_spans(fn, *args):
        runs = [fn(*args) for _ in range(PARITY_RUNS)]
        spans = {k: float(np.median([r[1][k] for r in runs])) for k in runs[0][1]}
        return runs[0][0], spans

    main_launches = 0
    for n, block_length in PARITY_SIZES:
        data = text[:n]
        cfg = LZ4Config(mode="parity", block_length=block_length)
        codec = LZ4Codec(cfg, dev)
        parity_parse.launches = 0
        frame = codec.encode(data)
        torch.cuda.synchronize()
        launches = parity_parse.launches
        chunks = -(-(-(-n // block_length)) // codec.batch_blocks)
        check(launches == chunks,
              f"parity {n} B: K11 launched {launches} times, not once per "
              f"batch chunk ({chunks})")
        if n == max(m for m, _ in PARITY_SIZES):
            main_launches = launches
        check(frame == LZ4Codec(cfg, "cpu").encode(data),
              f"parity {n} B: the card's frame differs from the CPU port's")
        check(frame == native.encode_parity(data, block_length),
              f"parity {n} B: the card's frame differs from the native encoder's")
        if n <= ORACLE_MAX_BYTES:
            check(frame == lz4_encode_oracle(data, block_length),
                  f"parity {n} B: the card's frame differs from the oracle's")
        check(codec.decode(frame, engine="device") == data,
              f"parity {n} B: the card's decode does not return the input")
        enc_ms, enc_runs = median_ms(lambda: codec.encode(data), PARITY_RUNS)
        dec_ms, dec_runs = median_ms(lambda: codec.decode(frame, engine="device"),
                                     PARITY_RUNS)
        nat_ms, nat_runs = median_ms(
            lambda: native.encode_parity(data, block_length), PARITY_RUNS)
        staged, enc_spans = median_spans(staged_encode, data, block_length)
        check(staged == frame, f"parity {n} B: staged encode differs")
        back, dec_spans = median_spans(staged_decode, frame)
        check(back == data, f"parity {n} B: staged decode differs")
        same = "CPU port, native" + (", oracle" if n <= ORACLE_MAX_BYTES else "")
        print(f"phase 17: parity {n} B, block length {block_length} "
              f"({frame[0]} blocks): K11 launched {launches} times (once a "
              f"batch chunk); frame byte-identical to the {same} "
              f"({len(frame)} B, ratio {len(frame) / n:.4f}); device decode "
              "returns the input")
        print(f"phase 17: parity {n} B/{block_length}: encode median "
              f"{enc_ms:.3f} ms (runs "
              f"{[round(t, 3) for t in enc_runs]}), decode (device) median "
              f"{dec_ms:.3f} ms (runs {[round(t, 3) for t in dec_runs]}), "
              f"native encode_parity median {nat_ms:.3f} ms")
        for label, spans in (("encode", enc_spans), ("decode", dec_spans)):
            print(f"phase 17: parity {n} B/{block_length} {label} staged ms "
                  f"(median of "
                  f"{PARITY_RUNS}, synchronised marks): " + ", ".join(
                      f"{k} {v:.3f}" for k, v in spans.items())
                  + f"; sum {sum(spans.values()):.3f}")
    return main_launches


def cli_phase(dev):
    """Phase 18: ``python -m lz4jpeg_tpu_torch`` on the card against the
    same commands with ``--device cpu``."""
    import contextlib
    import io
    import tempfile

    from lz4jpeg_tpu_torch.cli import main as cli
    from lz4jpeg_tpu_torch.formats.jpeg_container import unpack_container
    from lz4jpeg_tpu_torch.ops.fused_match import match_candidates
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import forward_combined
    from lz4jpeg_tpu_torch.ops.lz4t_decode import resolve_rooted
    from lz4jpeg_tpu_torch.ops.quantize import (
        CHROMINANCE_QUANTIZATION_TABLE as CHR,
        LUMINANCE_QUANTIZATION_TABLE as LUM,
    )
    from lz4jpeg_tpu_torch.utils.inputs import generate_noise_image, generate_text
    from lz4jpeg_tpu_torch.utils.io import read_png, write_png
    from lz4jpeg_tpu_torch.utils.parity import sum_order_flips

    rng = np.random.default_rng(SEED + 18)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        text, short, png = tmp / "text.txt", tmp / "short.txt", tmp / "in.png"
        data = generate_text(CLI_TEXT_BYTES, rng)
        text.write_bytes(data)
        short.write_bytes(data[:CLI_PARITY_BYTES])
        rgb = generate_noise_image(SIDE, SIDE, rng)
        write_png(str(png), rgb)
        check(np.array_equal(read_png(str(png)), rgb), "PNG round trip differs")
        card = tmp / "card"

        def commands(d):
            # Decodes read the card's outputs in both runs: the same command.
            return {
                "lz4 encode fast": ["lz4", "encode", text, d / "fast.lz4",
                                    "--mode", "fast", "--engine", "device",
                                    "--log", d / "fast.log"],
                "lz4 decode fast": ["lz4", "decode", card / "fast.lz4",
                                    d / "fast.out", "--engine", "device"],
                "lz4 encode parity": ["lz4", "encode", short, d / "parity.lz4",
                                      "--mode", "parity", "--log",
                                      d / "parity.log", "--hexdump",
                                      d / "parity.hex"],
                "lz4 decode parity": ["lz4", "decode", card / "parity.lz4",
                                      d / "parity.out", "--engine", "device"],
                "lz4 decode parity --text": ["lz4", "decode",
                                             card / "parity.lz4",
                                             d / "parity.txt", "--text"],
                "jpeg encode": ["jpeg", "encode", png, d / "out.tjpg"],
                "jpeg decode": ["jpeg", "decode", card / "out.tjpg",
                                d / "dec.png"],
                "jpeg roundtrip": ["jpeg", "roundtrip", png, d / "rec.png",
                                   "--mse", "--visualize", d / "viz"],
            }

        said, secs = {}, {}
        for run, device in (("card", dev.type), ("cpu", "cpu")):
            (tmp / run).mkdir()
            if run == "card":
                for f in (forward_combined, match_candidates, resolve_rooted):
                    f.launches = 0
            for name, argv in commands(tmp / run).items():
                out = io.StringIO()
                t = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    rc = cli([*map(str, argv), "--device", device])
                secs[run, name] = time.perf_counter() - t
                check(rc == 0, f"{name} --device {device} exited {rc}")
                said[run, name] = out.getvalue().strip()
            if run == "card":
                launches = {"K1": forward_combined.launches,
                            "K2": match_candidates.launches,
                            "K3": resolve_rooted.launches}
                check(all(launches.values()),
                      f"the CLI on the card left a kernel unlaunched: {launches}")
        cpu = tmp / "cpu"
        same = ["fast.lz4", "fast.log", "fast.out", "parity.lz4", "parity.log",
                "parity.hex", "parity.out", "parity.txt", "viz/luminance.png",
                "viz/rChrominance.png", "viz/bChrominance.png"]
        for name in same:
            check((card / name).read_bytes() == (cpu / name).read_bytes(),
                  f"CLI output {name} differs between the card and the CPU")
        check((card / "fast.out").read_bytes() == data
              and (card / "parity.out").read_bytes() == data[:CLI_PARITY_BYTES],
              "the CLI's decodes do not return the input")
        card_runs, cpu_runs = (unpack_container((d / "out.tjpg").read_bytes())
                               .rle_combined for d in (card, cpu))
        flips = sum_order_flips(rgb[None], card_runs, cpu_runs, LUM, CHR)
        check(flips <= MAX_FLIP_SHARE * (SIDE // 8) ** 2 * 128,
              f"{flips} flips between the card's and the CPU's containers")
        # `jpeg decode` decodes the card's container on both devices (phase
        # 3's rule); `roundtrip` decodes each device's own encode, so it
        # equals the card's `jpeg decode` and, outside the 8x8 blocks whose
        # runs a flip changed, the CPU's roundtrip.
        dec, rec = (read_png(str(card / f)) for f in ("dec.png", "rec.png"))
        check(np.array_equal(rec, dec),
              "the card's roundtrip differs from its encode + decode")
        dec_env = envelope("jpeg decode", [dec], [read_png(str(cpu / "dec.png"))])
        flipped = np.zeros((SIDE // 8, SIDE // 8), bool)
        flipped.flat[np.nonzero((card_runs != cpu_runs).any(axis=1))[0]] = True
        keep = ~np.repeat(np.repeat(flipped, 8, axis=0), 8, axis=1)
        rec_env = envelope("jpeg roundtrip outside flipped blocks", [rec[keep]],
                           [read_png(str(cpu / "rec.png"))[keep]])

        # lzw runs on the host only (no --device).
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            check(cli(["lzw", "encode", str(short), str(tmp / "codes.txt")]) == 0
                  and cli(["lzw", "decode", str(tmp / "codes.txt"),
                           str(tmp / "lzw.out")]) == 0, "lzw exited non-zero")
            check(cli(["lz4", "inspect", str(card / "parity.lz4")]) == 0,
                  "lz4 inspect exited non-zero")
        check((tmp / "lzw.out").read_bytes() == data[:CLI_PARITY_BYTES],
              "lzw decode does not return the input")
        inspect = out.getvalue().splitlines()[2:]
        check(inspect[0].startswith("parity frame: 100 block(s)"),
              f"lz4 inspect printed {inspect[:1]}")

        # The module entry point, in a process of its own, on the default
        # device (cuda).
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "lz4jpeg_tpu_torch", "lz4", "decode",
             str(card / "parity.lz4"), str(tmp / "main.out"), "--engine",
             "device"],
            capture_output=True, text=True, timeout=300,
            cwd=str(Path(__file__).resolve().parent),
        )
        main_s = time.perf_counter() - t
        check(proc.returncode == 0, f"python -m lz4jpeg_tpu_torch: {proc.stderr}")
        check((tmp / "main.out").read_bytes() == data[:CLI_PARITY_BYTES],
              "python -m lz4jpeg_tpu_torch lz4 decode does not return the input")

    print(f"phase 18: CLI launches on the card {launches}; {len(same)} output "
          "files byte-identical to the --device cpu runs; JPEG container "
          + ("byte-identical" if flips == 0 else f"up to {flips} admissible flips")
          + f" ({int(flipped.sum())} blocks); jpeg decode {dec_env}; "
          f"roundtrip equal to the card's decode, vs the CPU's outside the "
          f"flipped blocks {rec_env}; lzw round trip and lz4 inspect "
          f"({len(inspect)} lines) ok; python -m lz4jpeg_tpu_torch on the "
          f"default device ok ({main_s:.2f} s)")
    for name in commands(card):
        print(f"phase 18: {name}: card {secs['card', name]:.3f} s, cpu "
              f"{secs['cpu', name]:.3f} s; said {said['card', name]!r}")
    check(said["card", "jpeg roundtrip"].startswith("MSE: "),
          "jpeg roundtrip --mse printed no MSE")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_inputs():
    """The two-rank run's inputs (phase 19): text and a noise frame."""
    from lz4jpeg_tpu_torch.utils.inputs import generate_noise_image, generate_text

    rng = np.random.default_rng(SEED + 19)
    return (generate_text(PAR_RANK_TEXT_BYTES, rng),
            generate_noise_image(PAR_STAGED_SIDE, PAR_STAGED_SIDE, rng))


def rank_worker(coordinator: str, rank: int, out: str) -> int:
    """One of phase 19's two ranks: a gloo group (NCCL refuses two ranks on
    one card), the work on cuda:0; writes its frame and container to
    ``out.<rank>.lz4`` and ``out.<rank>.tjpg``."""
    import torch.distributed as dist

    from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
    from lz4jpeg_tpu_torch.formats.jpeg_container import unpack_container
    from lz4jpeg_tpu_torch.parallel import jpeg as pjpeg
    from lz4jpeg_tpu_torch.parallel import lz4 as plz4
    from lz4jpeg_tpu_torch.parallel.multihost import initialize

    check(initialize(coordinator, 2, rank, device="cpu") == 2, "world size")
    try:
        text, img = rank_inputs()
        frame = plz4.multihost_fast_encode(text, device="cuda")
        check(plz4.multihost_fast_decode(frame, device="cuda") == text,
              f"rank {rank}: multihost_fast_decode does not return the input")
        container = pjpeg.multihost_jpeg_encode(img, JPEGConfig(), device="cuda")
        rgb = pjpeg.multihost_jpeg_decode(container, JPEGConfig(), device="cuda")
        local = JPEGPipeline(JPEGConfig(), "cuda").decode(unpack_container(container))
        print(f"rank {rank}: jpeg decode vs the pipeline's: "
              + band_envelope(f"rank {rank} decode", rgb, local))
        Path(f"{out}.{rank}.lz4").write_bytes(frame)
        Path(f"{out}.{rank}.tjpg").write_bytes(container)
    finally:
        dist.destroy_process_group()
    return 0


def band_envelope(label: str, got, want) -> str:
    """Identity, or the banded inverse's envelope (max |Δ| ≤ 1 on < 2e-3 of
    pixels: cuBLAS may sum a band's product in another order than the whole
    frame's); returns the count of differing pixels as text."""
    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape, f"{label}: shapes {got.shape} vs {want.shape}")
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    n = int((diff != 0).sum())
    check(int(diff.max()) <= 1 and n < 2e-3 * diff.size,
          f"{label}: max |d| {int(diff.max())}, {n} pixels differ")
    return "identical" if n == 0 else (
        f"{n} of {diff.size} values differ by 1 (share {n / diff.size:.3g})")


def parallel_phase(dev, card: str, data: bytes, lz4_frame: bytes):
    """Phase 19: the parallel paths on the card; ``data`` and ``lz4_frame``
    are phase 6's 32 MiB and its frame."""
    import tempfile

    import torch
    import torch.distributed as dist

    from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline, LZ4Codec, LZ4Config
    from lz4jpeg_tpu_torch.bench.scaling import jpeg_scaling_sweep
    from lz4jpeg_tpu_torch.config import MeshConfig
    from lz4jpeg_tpu_torch.formats.fast_frame import assemble_frame
    from lz4jpeg_tpu_torch.formats.jpeg_container import (
        pack_container,
        unpack_container,
    )
    from lz4jpeg_tpu_torch.models.jpeg import CHANNELS, scaled_tables
    from lz4jpeg_tpu_torch.native import native_backend
    from lz4jpeg_tpu_torch.ops import pack16
    from lz4jpeg_tpu_torch.ops.fused_match import (
        fast_match_blocks_fused,
        match_candidates,
    )
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import forward_combined
    from lz4jpeg_tpu_torch.ops.inv_megakernel import inverse_combined
    from lz4jpeg_tpu_torch.ops.lz4_fast import TPU_BLOCK_LOG, pad_blocks_fast
    from lz4jpeg_tpu_torch.ops.lz4_parse import parity_parse, parse_candidates
    from lz4jpeg_tpu_torch.ops.lz4t_decode import resolve_rooted
    from lz4jpeg_tpu_torch.ops.match import greedy_parse, match_tables, pad_blocks
    from lz4jpeg_tpu_torch.ops.rle import rle_encode_sparse16
    from lz4jpeg_tpu_torch.parallel import (
        ShardedJPEGForward,
        ShardedSparseJPEG,
        codec_mesh,
        pad_to_devices,
        sharded_block_parse,
    )
    from lz4jpeg_tpu_torch.parallel import jpeg as pjpeg
    from lz4jpeg_tpu_torch.parallel import lz4 as plz4
    from lz4jpeg_tpu_torch.parallel import multihost
    from lz4jpeg_tpu_torch.parallel.mesh import CodecMesh
    from lz4jpeg_tpu_torch.utils.inputs import generate_noise_image, generate_text
    from lz4jpeg_tpu_torch.utils.parity import sum_order_flips

    t_phase = time.perf_counter()
    meshes = {
        "codec_mesh": codec_mesh(MeshConfig(), dev.type),
        f"{PAR_SHARDS} shards of cuda:0": CodecMesh(
            (torch.device(dev.type, 0),) * PAR_SHARDS),
    }
    four = list(meshes)[1]
    launched = {}

    def counted(counter, label: str, want: int, fn):
        """``fn()`` with ``counter``'s launches counted from 0 just before
        it and read just after; holds them to ``want``."""
        counter.launches = 0
        out = fn()
        torch.cuda.synchronize()
        launched[label] = counter.launches
        check(counter.launches == want,
              f"phase 19: {label}: {counter.launches} launches, want {want}")
        return out

    # ---- JPEG sparse16: band-sharded forward (K1) and folded inverse -----
    frame = generate_noise_image(SIDE, SIDE, np.random.default_rng(SEED))
    pipe = JPEGPipeline(JPEGConfig(), dev)
    enc = pipe.encode(frame, entropy=False)
    ref_dec = pipe.decode(enc, from_entropy=False)
    nb = SIDE // 8
    for name, mesh in meshes.items():
        ssj = ShardedSparseJPEG(mesh)
        comb = counted(forward_combined, f"K1 ShardedSparseJPEG.forward, {name}",
                       mesh.size, lambda: ssj.forward(frame))
        check(np.array_equal(comb, enc.rle_combined),
              f"phase 19: ShardedSparseJPEG on {name} differs from encode")
        rec = counted(inverse_combined, f"K9 ShardedSparseJPEG.inverse, {name}",
                      mesh.size, lambda: ssj.inverse(comb, nb, nb, SIDE, SIDE))
        print(f"phase 19: ShardedSparseJPEG {SIDE}x{SIDE} on {name}: forward "
              f"identical to the pipeline's encode (K1 x{mesh.size}); inverse "
              f"(K9 x{mesh.size}) vs the pipeline's decode: "
              + band_envelope(f"sparse inverse on {name}", rec, ref_dec))

    # ---- JPEG staged forward and its inverse (pairs; packed16 with K6) --
    img = generate_noise_image(PAR_STAGED_SIDE, PAR_STAGED_SIDE,
                               np.random.default_rng(SEED + 19))
    side, nb = PAR_STAGED_SIDE, PAR_STAGED_SIDE // 8
    tables = scaled_tables(None)
    for precision in ("fast", "exact"):
        cfg = JPEGConfig(precision=precision)
        p = JPEGPipeline(cfg, dev)
        ref = p.forward_stages(img)
        (packed,) = p.to_packed16([p.encode(img, entropy=False)]) if (
            precision == "fast") else (None,)
        for name, mesh in meshes.items():
            sj = ShardedJPEGForward(mesh, cfg)
            stages, n = sj(img)
            same = all(np.array_equal(stages[c][k][:n], ref[c][k])
                       for c in CHANNELS for k in ("zz", "rle", "rle_lengths"))
            flips = 0
            if not same:
                check(precision == "fast", f"phase 19: exact stages on {name} "
                      "differ from forward_stages")

                def comb_of(st, rows):
                    return np.concatenate([rle_encode_sparse16(torch.from_numpy(
                        np.ascontiguousarray(st[c]["zz"][:rows])).to(torch.int16))[0]
                        .numpy() for c in CHANNELS], axis=1)

                flips = sum_order_flips(img[None], comb_of(stages, n),
                                        comb_of(ref, n), tables["lum"], tables["r"])
                check(flips <= MAX_FLIP_SHARE * n * 128,
                      f"phase 19: {flips} flips in the staged forward on {name}")
            pairs = {c: stages[c]["rle"][:n] for c in CHANNELS}
            lens = {c: stages[c]["rle_lengths"][:n] for c in CHANNELS}
            want = p.decode(p._wrap_pairs(pairs, lens, side, side, nb, nb),
                            from_entropy=False)
            pair_rec = sj.inverse(pairs, lens, nb, nb, side, side)
            line = (f"phase 19: ShardedJPEGForward {precision} {side}x{side} on "
                    f"{name}: stages {'identical to' if same else f'{flips} admissible flips from'} "
                    f"forward_stages; pairs inverse vs the card's staged decode: "
                    + band_envelope(f"{precision} pairs inverse on {name}",
                                    pair_rec, want))
            if packed is not None:
                got = counted(
                    pack16.pack16_decode, f"K6 ShardedJPEGForward.inverse, {name}",
                    len(CHANNELS) * mesh.size, lambda: sj.inverse(
                        packed.rle, packed.rle_lengths, nb, nb, side, side,
                        layout="packed16"))
                line += ("; packed16 inverse (K6) vs the card's packed16 decode: "
                         + band_envelope(f"packed16 inverse on {name}", got,
                                         p.decode(packed, from_entropy=False)))
            print(line)

    # ---- LZ4T: sharded K2 and K3 ------------------------------------------
    padded, lengths = pad_blocks_fast(data)
    data_u8 = padded.astype(np.uint8)
    raws = [data_u8[i, : int(n)].tobytes() for i, n in enumerate(lengths)]
    want = [f.cpu().numpy() for f in fast_match_blocks_fused(
        torch.from_numpy(data_u8).to(dev), torch.from_numpy(lengths).to(dev),
        lcp_words=plz4.FUSED_LCP_WORDS)]
    native = native_backend()
    for name, mesh in meshes.items():
        fields = counted(
            parse_candidates, f"K10 sharded_fast_parse, {name}", mesh.size,
            lambda: counted(match_candidates, f"K2 sharded_fast_parse, {name}",
                            mesh.size, lambda: plz4.sharded_fast_parse(
                                padded, lengths, mesh)))
        check(all(np.array_equal(g, w) for g, w in zip(fields, want)),
              f"phase 19: sharded_fast_parse on {name} differs from K2")
        sframe = assemble_frame(native.emit_blocks(data_u8, lengths, *fields),
                                raws, len(data), TPU_BLOCK_LOG)
        check(native.decode_fast(sframe, len(data)) == data,
              f"phase 19: the sharded parse's frame does not decode")
        out = counted(resolve_rooted, f"K3 sharded_fast_decode, {name}",
                      mesh.size, lambda: plz4.sharded_fast_decode(lz4_frame, mesh))
        check(out == data, f"phase 19: sharded_fast_decode on {name}")
        print(f"phase 19: LZ4T {len(data)} B on {name}: sharded_fast_parse "
              f"identical to unsharded K2 (lcp {plz4.FUSED_LCP_WORDS}), its "
              f"frame ({len(sframe)} B) decodes; sharded_fast_decode returns "
              "the input")

    # ---- LZ4 parity: sharded match tables + greedy parse, psum ------------
    text = generate_text(PAR_PARITY_BYTES, np.random.default_rng(SEED))
    pblocks, _ = pad_blocks(text, 300)
    pblocks, n_blocks = pad_to_devices(pblocks, PAR_SHARDS, pad_value=-1)
    want = [t.cpu().numpy() for t in greedy_parse(
        *match_tables(torch.from_numpy(pblocks).to(dev)))]
    for name, mesh in meshes.items():
        got = counted(parity_parse, f"K11 sharded_block_parse, {name}",
                      mesh.size, lambda: sharded_block_parse(pblocks, mesh))
        check(all(np.array_equal(g, w) for g, w in zip(got, want)),
              f"phase 19: sharded_block_parse on {name} differs")
        total = int(plz4.sharded_compressed_sizes(got[1], got[0], mesh))
        check(total == int(got[0].sum()) > 0, f"phase 19: psum {total}")
        print(f"phase 19: parity {len(text)} B ({n_blocks} blocks, padded to "
              f"{len(pblocks)}) on {name}: sharded_block_parse identical to "
              f"the card's parse; psum {total} matches")

    # ---- NCCL, one process -------------------------------------------------
    codec = LZ4Codec(LZ4Config(mode="fast"), dev)
    local_frame = codec.encode(data, engine="device")
    container_local = pack_container(pipe.encode(frame))
    check(multihost.initialize() == 1, "a process group exists already")
    secs = {}
    check(multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                               device=dev) == 1, "NCCL world size")
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mh = counted(match_candidates, "K2 multihost_fast_encode, NCCL", 1,
                     lambda: plz4.multihost_fast_encode(data, device=dev))
        check(mh == local_frame, "phase 19: NCCL multihost_fast_encode "
              "differs from the codec's device encode")
        check(counted(resolve_rooted, "K3 multihost_fast_decode, NCCL", 1,
                      lambda: plz4.multihost_fast_decode(mh, device=dev)) == data,
              "phase 19: NCCL multihost_fast_decode")
        container = counted(forward_combined, "K1 multihost_jpeg_encode, NCCL", 1,
                            lambda: pjpeg.multihost_jpeg_encode(frame, device=dev))
        check(container == container_local, "phase 19: NCCL "
              "multihost_jpeg_encode differs from the pipeline's container")
        rgb = pjpeg.multihost_jpeg_decode(container, device=dev)
        check(np.array_equal(rgb, pipe.decode(unpack_container(container))),
              "phase 19: NCCL multihost_jpeg_decode differs from decode")
        secs["lz4 nccl"] = median_ms(
            lambda: plz4.multihost_fast_encode(data, device=dev), 3)
        secs["jpeg nccl"] = median_ms(
            lambda: pjpeg.multihost_jpeg_encode(frame, device=dev), PAR_RUNS)
    finally:
        dist.destroy_process_group()
    secs["lz4 no group"] = median_ms(
        lambda: plz4.multihost_fast_encode(data, device=dev), 3)
    secs["jpeg no group"] = median_ms(
        lambda: pjpeg.multihost_jpeg_encode(frame, device=dev), PAR_RUNS)
    secs["lz4 codec"] = median_ms(lambda: codec.encode(data, engine="device"), 3)
    secs["jpeg pipeline"] = median_ms(lambda: pipe.encode(frame), PAR_RUNS)
    print(f"phase 19: NCCL group of one: multihost_fast_encode of {len(data)} B "
          "equal to the codec's device encode, multihost_fast_decode returns "
          f"it; multihost_jpeg_encode of {SIDE}x{SIDE} equal to the pipeline's "
          "container, its decode identical")

    # ---- two ranks on the one card ----------------------------------------
    text2, img2 = rank_inputs()
    want_frame = plz4.multihost_fast_encode(text2, device=dev)
    check(want_frame == codec.encode(text2, engine="device"),
          "phase 19: in-process multihost encode differs from the codec's")
    want_container = pack_container(pipe.encode(img2))
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "rank")
        addr = f"127.0.0.1:{free_port()}"
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", addr,
             str(rank), out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(Path(__file__).resolve().parent),
        ) for rank in range(2)]
        try:
            said = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rank_s = time.perf_counter() - t
        for rank, (p, text_out) in enumerate(zip(procs, said)):
            check(p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{text_out}")
            check(Path(f"{out}.{rank}.lz4").read_bytes() == want_frame,
                  f"rank {rank}: frame differs from the in-process one")
            check(Path(f"{out}.{rank}.tjpg").read_bytes() == want_container,
                  f"rank {rank}: container differs from the in-process one")
    print(f"phase 19: two gloo ranks on cuda:0 ({rank_s:.2f} s): frames of "
          f"{len(text2)} B and containers of {PAR_STAGED_SIDE}x{PAR_STAGED_SIDE} "
          "byte-equal to the in-process ones; "
          + "; ".join(s.strip().splitlines()[-1] for s in said))

    # ---- times --------------------------------------------------------------
    print(f"phase 19: times on {card}, host clock, ms, median of {PAR_RUNS} "
          "(multihost LZ4: of 3):")
    x = frame[None]
    fwd = {"pipeline encode_batch(entropy=False)":
           median_ms(lambda: pipe.encode_batch(x, entropy=False), PAR_RUNS)}
    inv = {"pipeline decode(from_entropy=False)":
           median_ms(lambda: pipe.decode(enc, from_entropy=False), PAR_RUNS)}
    for name, mesh in meshes.items():
        ssj = ShardedSparseJPEG(mesh)
        comb = ssj.forward(frame)
        fwd[f"ShardedSparseJPEG.forward on {name}"] = median_ms(
            lambda: ssj.forward(frame), PAR_RUNS)
        inv[f"ShardedSparseJPEG.inverse on {name}"] = median_ms(
            lambda: ssj.inverse(comb, SIDE // 8, SIDE // 8, SIDE, SIDE), PAR_RUNS)
    for label, table in (("forward", fwd), ("inverse", inv), ("encode", secs)):
        for k, (med, runs) in table.items():
            print(f"phase 19: {label} {SIDE}x{SIDE} / {len(data)} B, {k}: "
                  f"{med:.3f} (runs {[round(r, 3) for r in runs]})")
    band = SIDE // PAR_SHARDS
    for label, rows in (("the frame", SIDE), (f"one band of {band} rows", band)):
        x_d = torch.from_numpy(np.ascontiguousarray(frame[:rows]))[None].to(dev)
        ms, _ = timed_runs(
            lambda t: forward_combined(t, pipe._tables["lum"], pipe._tables["r"]),
            x_d)
        print(f"phase 19: K1 alone on {label} ({rows}x{SIDE}), CUDA events: "
              f"trimmed mean {trimmed_mean(ms):.4f} ms "
              f"(runs {[round(t, 4) for t in ms]})")
    sweep = jpeg_scaling_sweep(SIDE, device=dev.type)
    print(f"phase 19: jpeg_scaling_sweep({SIDE}, device='cuda') on {card}: "
          + json.dumps(sweep))
    print(f"phase 19: launches {launched}; {time.perf_counter() - t_phase:.1f} s")


class Stopwatch:
    """Host-clock split of a staged run; every mark synchronises the card
    first, so a stage's device work lands in its own span."""

    def __init__(self):
        self.spans = {}
        self._last = time.perf_counter()

    def mark(self, name: str) -> None:
        import torch

        torch.cuda.synchronize()
        now = time.perf_counter()
        self.spans[name] = (now - self._last) * 1e3
        self._last = now

    def report(self, label: str) -> None:
        print(f"{label}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in self.spans.items())
            + f"; sum {sum(self.spans.values()):.3f}")


def bench_phase(dev):
    """Phase 20: the copy kernel against its plain version, the stream
    ceiling, the headline and every benchmark suite of
    ``lz4jpeg_tpu_torch/bench/`` on the card; returns the copy kernel's
    record and the measured ceiling in GB/s."""
    import gc
    import tempfile

    import torch

    from lz4jpeg_tpu_torch.bench import (
        entropy_ab,
        experiments,
        headline,
        roofline,
    )
    from lz4jpeg_tpu_torch.ops.fused_match import match_candidates
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import forward_combined
    from lz4jpeg_tpu_torch.ops import lz4_parse, stream
    from lz4jpeg_tpu_torch.ops.inv_megakernel import inverse_combined
    from lz4jpeg_tpu_torch.ops.lz4t_decode import resolve_rooted
    from lz4jpeg_tpu_torch.ops.stream import stream_copy, stream_copy_ref
    from lz4jpeg_tpu_torch.profiles import rle_expand
    from lz4jpeg_tpu_torch.utils.inputs import generate_text

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    wall = {}

    # -- the copy kernel against x.clone(): both routes, three dtypes --------
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    n_err = 0

    def copy_held(label, x):
        got, want = stream_copy(x), stream_copy_ref(x)
        torch.cuda.synchronize()
        n = x.numel() * x.element_size()
        copy_ctas(f"phase 20: copy kernel {label} launch", x.data_ptr(),
                  got.data_ptr(), n)
        same = torch.equal(got, want)
        print(f"phase 20: copy kernel {label} ({n} bytes, ptr % 16 = "
              f"{x.data_ptr() % 16}): {'identical' if same else 'DIFFERS'}")
        return not same

    for dtype in (torch.uint8, torch.int16, torch.float32):
        rows = COPY_BYTES // (COPY_COLUMNS * torch.empty((), dtype=dtype).element_size())
        big = torch.randint(0, 100, (rows, COPY_COLUMNS), generator=gen,
                            device=dev, dtype=dtype)
        small = torch.randint(-100, 100, (1_000_003,), generator=gen,
                              device=dev).to(dtype)
        for label, x in ((f"{COPY_BYTES // MIB} MiB", big), ("odd", small),
                         ("offset view", offset_view(small))):
            n_err += copy_held(f"{dtype} {label}", x)
        del big, small
    # the template's chunk edges, aligned and as offset views; the same
    # sizes between equal offsets (head and tail) through the C entry point
    chunk = stream.CHUNK_BYTES
    lib = stream.load_kernel()
    cuda_stream = torch.cuda.current_stream(dev).cuda_stream
    off = COPY_EQUAL_OFFSET
    for n in (chunk - 1, chunk, chunk + 1, 3 * chunk + 5):
        x = torch.randint(0, 256, (n + off,), generator=gen, device=dev,
                          dtype=torch.uint8)
        n_err += copy_held(f"u8 {n} bytes", x[:n])
        n_err += copy_held(f"u8 {n} bytes offset view", offset_view(x[:n]))
        dst = torch.zeros_like(x)
        copy_ctas(f"phase 20: copy kernel u8 {n} bytes at offset {off} "
                  "launch", x.data_ptr() + off, dst.data_ptr() + off, n)
        rc = lib.stream_copy_launch(x.data_ptr() + off, dst.data_ptr() + off,
                                    n, cuda_stream)
        torch.cuda.synchronize()
        check(rc == 0, f"phase 20: stream_copy_launch returned {rc}")
        same = (torch.equal(dst[off:], x[off:])
                and not dst[:off].any())
        n_err += not same
        print(f"phase 20: copy kernel u8 {n} bytes between offsets {off} "
              f"(entry point): {'identical' if same else 'DIFFERS'}")
        del x, dst
    x = torch.randint(0, 256, (COPY_BIG_BYTES,), generator=gen, device=dev,
                      dtype=torch.uint8)
    n_err += copy_held(f"u8 {COPY_BIG_BYTES} bytes (above 2^31)", x)
    del x
    gc.collect()
    torch.cuda.empty_cache()
    check(n_err == 0, f"the copy kernel differs from x.clone() in {n_err} cases")
    attrs = rle_expand.copy_attributes(rle_expand.COPY_RM, dev)
    print(f"phase 20: the copy template (copy_rm's attributes entry) "
          f"registers {attrs['registers']}, shared {attrs['shared_bytes']} B, "
          f"{attrs['ctas_per_sm']} CTAs/SM")
    x = torch.randint(0, 100, (COPY_BYTES // COPY_COLUMNS, COPY_COLUMNS),
                      generator=gen, device=dev, dtype=torch.uint8)
    dst = torch.empty_like(x)
    t = time_versions(
        f"phase 20: copy {COPY_BYTES // MIB} MiB u8",
        {"plain": stream_copy_ref, "kernel": stream_copy,
         "library": lambda x: dst.copy_(x)},
        x,
    )
    copy_bound = bound(2 * x.numel())
    del x, dst

    stream_copy.launches = 0
    t0 = time.perf_counter()
    probe = roofline.measure_hbm_stream_ceiling(COPY_BYTES, device=dev)
    wall["stream ceiling"] = time.perf_counter() - t0
    copy_launches = stream_copy.launches
    check(copy_launches > 0, "the stream probe never launched the copy kernel")
    ceiling = probe["ceiling_gbs"]
    for name, v in probe["variants"].items():
        print(f"phase 20: stream {name}: {v['measured_s'] * 1e3:.4f} ms per "
              f"iteration, {v['achieved_gbs']:.1f} GB/s")
    print(f"phase 20: measured stream ceiling {ceiling:.1f} GB/s "
          f"({probe['ceiling_variant']}), {ceiling / 3350:.1%} of the data "
          f"sheet's 3,350; copy kernel launches {copy_launches}; card "
          f"{probe.get('card', probe['device'])}")
    print(f"phase 20: copy kernel {COPY_BYTES // MIB} MiB u8: {t['kernel']:.4f} ms "
          f"({2 * COPY_BYTES / t['kernel'] / 1e6:.1f} GB/s), plain "
          f"{t['plain']:.4f} ms, copy_ {t['library']:.4f} ms; bound "
          f"{copy_bound[0]:.4f} ms, {copy_bound[0] / t['kernel']:.1%} of it")

    def suite(name, fn):
        t0 = time.perf_counter()
        out = fn()
        wall[name] = time.perf_counter() - t0
        print(f"phase 20: {name}: {wall[name]:.2f} s", flush=True)
        return out

    # -- the headline at full size -----------------------------------------
    forward_combined.launches = 0
    line = suite("headline", lambda: headline.main(*HEADLINE_SHAPE, device=dev))
    check(line["metric"] == f"jpeg_forward_throughput_{HEADLINE_SHAPE[0]}_"
          f"b{HEADLINE_SHAPE[1]}_cuda" and line["value"] > 0,
          f"headline printed {line}")
    want = (headline.RUNS + headline.WARMUP) * headline.CHAIN
    check(forward_combined.launches == want,
          f"headline launched K1 {forward_combined.launches} times, not {want}")

    # -- every sweep at small scale, on generated text ------------------------
    corpus = generate_text(BENCH_TEXT_BYTES, np.random.default_rng(SEED + 20))
    runs = BENCH_RUNS
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        match_candidates.launches = 0
        lz4_parse.parse_candidates.launches = 0
        lz4_parse.greedy_parse.launches = 0
        got = suite("lz4-device", lambda: experiments.run_lz4_device_experiment(
            batches=list(BENCH_LZ4_BATCHES), runs=runs, corpus=corpus,
            device=dev, output=str(tmp / "lz4_device.json")))
        check(len(got) == 6 * len(BENCH_LZ4_BATCHES), "lz4-device series missing")
        want = 4 * len(BENCH_LZ4_BATCHES) * (1 + runs) * 4
        check(match_candidates.launches == want,
              f"lz4-device launched K2 {match_candidates.launches} times, not {want}")
        # K10 once a fused match (4 series) and its field entry once a sort
        # match (the 2 sort series), 4 chained matches a run.
        check(lz4_parse.parse_candidates.launches == want,
              f"lz4-device launched K10 {lz4_parse.parse_candidates.launches} "
              f"times, not {want}")
        sort_want = 2 * len(BENCH_LZ4_BATCHES) * (1 + runs) * 4
        check(lz4_parse.greedy_parse.launches == sort_want,
              f"lz4-device launched K10's field entry "
              f"{lz4_parse.greedy_parse.launches} times, not {sort_want}")
        resolve_rooted.launches = 0
        suite("lz4t-decode", lambda: experiments.run_lz4t_decode_device_experiment(
            sizes_mb=list(BENCH_LZ4T_MB), runs=runs, corpus=corpus, device=dev,
            output=str(tmp / "lz4t_decode.json")))
        want = len(BENCH_LZ4T_MB) * (2 + runs)
        check(resolve_rooted.launches == want,
              f"lz4t-decode launched K3 {resolve_rooted.launches} times, not {want}")
        inverse_combined.launches = 0
        suite("jpeg-inverse", lambda: experiments.run_jpeg_inverse_device_experiment(
            sizes=list(BENCH_INVERSE_SIZES), runs=runs, device=dev,
            output=str(tmp / "jpeg_inverse.json")))
        want = len(BENCH_INVERSE_SIZES) * (2 + runs) * 4
        check(inverse_combined.launches == want,
              f"jpeg-inverse launched K9 {inverse_combined.launches} times, "
              f"not {want}")
        suite("jpeg-perblock", lambda: experiments.run_jpeg_perblock_experiment(
            sizes=list(BENCH_PERBLOCK_SIZES), runs=runs, device=dev,
            output=str(tmp / "jpeg_perblock.json")))
        suite("entropy-ab", lambda: entropy_ab.run_entropy_ab(
            image_size=BENCH_ENTROPY_SIDE, runs=runs, device=dev,
            output=str(tmp / "entropy_ab.json")))
        forward_combined.launches = 0
        fwd = suite("roofline", lambda: roofline.run_jpeg_forward_roofline(
            **ROOFLINE_FORWARD, device=dev, output=str(tmp / "roofline.json")))
        check(forward_combined.launches > 0, "the roofline never launched K1")
        inverse_combined.launches = 0
        inv = suite("roofline-inverse", lambda: roofline.run_jpeg_inverse_roofline(
            **ROOFLINE_INVERSE, device=dev,
            output=str(tmp / "roofline_inverse.json")))
        check(inv["stages"]["full_inverse"]["route"] == "K9"
              and inverse_combined.launches > 0,
              "the inverse roofline's full_inverse never launched K9")
        for path in sorted(tmp.iterdir()):
            art = json.loads(path.read_text())
            entries = art if isinstance(art, list) else [art]
            check(all(e.get("device") == str(dev) and e.get("card")
                      for e in entries), f"{path.name} does not name the card")
        print(f"phase 20: {len(list(tmp.iterdir()))} artifacts, each naming "
              f"{dev} and the card")
    k1 = fwd["stages"]["megakernel"]
    print(f"phase 20: roofline K1 at {ROOFLINE_FORWARD}: "
          f"{k1['measured_s'] * 1e3:.4f} ms, {k1['sol_fraction']:.1%} of the "
          f"data sheet's bound, {k1['sol_fraction_measured']:.1%} of the "
          f"measured ceiling's")
    print("phase 20: inverse roofline: " + ", ".join(
        f"{k} ({st['route']}) {st['measured_s'] * 1e3:.4f} ms"
        for k, st in inv["stages"].items())
          + f"; K9 launches {inverse_combined.launches}")

    # -- the CLI's bench headline, in a process of its own --------------------
    gc.collect()
    torch.cuda.empty_cache()  # the sweeps' cached blocks would starve it
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lz4jpeg_tpu_torch", "bench", "headline",
         "--device", "cuda"],
        capture_output=True, text=True, timeout=600,
        cwd=str(Path(__file__).resolve().parent),
    )
    wall["python -m ... bench headline"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"bench headline: {proc.stderr[-2000:]}")
    cli_line = json.loads(proc.stdout.strip().splitlines()[-1])
    check(set(cli_line) == {"metric", "value", "unit", "vs_baseline"}
          and cli_line["metric"] == "jpeg_forward_throughput_2048_b256_cuda",
          f"bench headline printed {cli_line}")
    print(f"phase 20: python -m lz4jpeg_tpu_torch bench headline: {cli_line}")
    print("phase 20: wall s " + ", ".join(f"{k} {v:.2f}" for k, v in wall.items())
          + f"; phase {time.perf_counter() - t_phase:.2f} s")
    return {
        "name": "stream_copy",
        "route": "cuda",
        "source": COPY_SOURCE,
        "replaces": COPY_REPLACES,
        "launches": copy_launches,
        "max_abs_err": 0.0,
        "ms": t["kernel"],
        "plain_ms": t["plain"],
        "bound_ms": copy_bound[0],
        "bound_by": copy_bound[1],
        "library_ms": t["library"],
        "registers": attrs["registers"],
        "ctas_per_sm": attrs["ctas_per_sm"],
    }, ceiling


def candidates_phase(dev):
    """Phase 21: the kernel candidates of ``lz4jpeg_tpu_torch/profiles/``
    against their plain versions on the card, their times at the A/B shapes,
    and both A/Bs at their defaults; returns the four kernel records."""
    import gc
    import tempfile

    import torch

    from lz4jpeg_tpu_torch.ops.quantize import (
        CHROMINANCE_QUANTIZATION_TABLE as CHR,
        LUMINANCE_QUANTIZATION_TABLE as LUM,
        scale_table,
    )
    from lz4jpeg_tpu_torch.ops.fused import _table_key, inverse_basis
    from lz4jpeg_tpu_torch.profiles import mcu, sass_loops, timing
    from lz4jpeg_tpu_torch.profiles.candidates_ab import run_candidates_ab
    from lz4jpeg_tpu_torch.profiles.mcu import (
        fused_forward_candidate,
        fused_forward_candidate_ref,
        fused_inverse_candidate,
        fused_inverse_candidate_ref,
    )
    from lz4jpeg_tpu_torch.profiles.plane_color import (
        plane_color,
        plane_color_ref,
        run_plane_color_ab,
    )
    from lz4jpeg_tpu_torch.profiles.rle import (
        rle_encode_candidate,
        rle_encode_candidate_ref,
    )
    from lz4jpeg_tpu_torch.utils.inputs import crafted_rle_rows, smooth_tiles
    from lz4jpeg_tpu_torch.utils.parity import transform_flips

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    rng = np.random.default_rng(SEED + 21)

    # -- the MCU transforms: identical up to one-step flips at ties ----------
    # The inverse also on |z| ≥ 256 with a fraction (mid and lo parts; most
    # pixels clamp), on fractions (every branch of its vote), on the
    # coefficients of smooth tiles under the quality-100 table (|z| past 256
    # with pixels in range), and with the DC set so that every sum lies near
    # -1.2e7, where the epilogue's 32-bit floor would wrap to 255.
    def wide(zz, table, width):
        return zz * 8.0 + torch.sign(zz) * 256.0 + 0.1, table

    def fractions(zz, table, width):
        return zz + torch.rand(zz.shape, generator=gen, device=dev) - 0.5, table

    def quality_100(zz, table, width):
        top = scale_table(table, 100)
        smooth = torch.from_numpy(smooth_tiles(zz.shape[0], width, rng)).to(dev)
        return fused_forward_candidate_ref(smooth, top, width, 8), top

    def far_below_zero(zz, table, width):
        far = zz.clone()
        far[:, 0] = -1.2e7 / float(inverse_basis(width, 8,
                                                 _table_key(table))[0, 0])
        return far, table

    variants = {"inverse": lambda zz, table, width: (zz, table),
                "inverse |z| >= 256": wide, "inverse fractions": fractions,
                "inverse quality 100": quality_100,
                "inverse far below zero": far_below_zero}
    counts = {k: [0, 0, 0] for k in ("forward", *variants)}
    # flips, outputs, outputs at 0 or 255
    for width, table in ((8, LUM), (4, CHR)):
        for n in CAND_TILES:
            tiles = torch.randint(0, 256, (n, 8, width), generator=gen,
                                  device=dev, dtype=torch.uint8)
            zz = fused_forward_candidate_ref(tiles, table, width, 8)
            fwd = fused_forward_candidate(tiles, table, width, 8)
            torch.cuda.synchronize()
            f = transform_flips("forward", tiles, fwd, zz, table, width, 8)
            counts["forward"][0] += f
            counts["forward"][1] += fwd.numel()
            line = f"forward {f}"
            for kind, make in variants.items():
                z, t = make(zz, table, width)
                inv = fused_inverse_candidate(z, t, width, 8)
                inv_ref = fused_inverse_candidate_ref(z, t, width, 8)
                torch.cuda.synchronize()
                i = transform_flips("inverse", z, inv, inv_ref, t, width, 8)
                counts[kind][0] += i
                counts[kind][1] += inv.numel()
                counts[kind][2] += int(((inv_ref == 0) | (inv_ref == 255)).sum())
                line += f", {kind} {i}"
                if kind == "inverse far below zero":
                    check(bool((inv == 0).all()),
                          f"mcu HW {8 * width} N {n}: a sum near -1.2e7 "
                          f"did not give the byte 0")
                del z, inv, inv_ref
            print(f"phase 21: mcu HW {8 * width} N {n}: flips {line} in "
                  f"{fwd.numel()} outputs each")
            del tiles, zz, fwd
    for kind, (flips, total, clamped) in counts.items():
        check(flips <= MAX_FLIP_SHARE * total,
              f"mcu {kind}: {flips} flips in {total} outputs")
        at_edge = ("" if kind == "forward" else
                   f"; {clamped / total:.1%} of the pixels at 0 or 255")
        print(f"phase 21: mcu {kind}: {flips} admissible flips in {total} "
              f"outputs ({flips / total:.3g}, at most {MAX_FLIP_SHARE})"
              f"{at_edge}")
    mcu_err = {"forward": float(counts["forward"][0] > 0),
               "inverse": float(any(v[0] for k, v in counts.items()
                                    if k.startswith("inverse")))}
    n_ab = CAND_AB.get("n_blocks", 2 * 1024 * 1024)
    for kind in mcu.KINDS:
        for hw in (64, 32):
            attrs = mcu.attributes(kind, hw, dev)
            line = f"phase 21: mcu {kind} HW {hw}: {attrs}"
            if attrs["ctas_per_sm"] is not None:  # the C plan, its mirror
                plan = mcu.launch_plan(kind, hw, n_ab, dev)
                check(plan == mcu.chunk_plan(n_ab, plan.resident, kind, hw),
                      f"mcu {kind} HW {hw}: plan {plan} is not its mirror's")
                line += f"; {plan}"
            print(line)
    for kernel, spilled in sass_loops.spill_stores(
            "mcu_transform_kernel").items():
        print(f"phase 21: {kernel}: {spilled} bytes of spill stores")

    # -- the RLE compaction: identical ----------------------------------------
    for length in CAND_SEGS:
        for n in CAND_ROWS:
            x = torch.from_numpy(crafted_rle_rows(n, length, rng)).to(dev)
            views = [("int16", x)]
            if n == 4099:
                views += [("int32", x.to(torch.int32)),
                          ("offset view", offset_view(x))]
            for label, v in views:
                got = rle_encode_candidate(v)
                want = rle_encode_candidate_ref(v)
                torch.cuda.synchronize()
                same = torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                    want[1])
                print(f"phase 21: rle L {length} rows {n} {label}: "
                      f"{'identical' if same else 'DIFFERS'} "
                      f"({int(got[1].sum()) // 2} runs)")
                check(same, f"rle kernel differs at L {length}, {n} rows, {label}")
            del x, views, got, want

    # -- the plane colour merge: identical ------------------------------------
    for n, w in CAND_PLANES:
        y = torch.randint(0, 256, (n, w), generator=gen, device=dev,
                          dtype=torch.uint8)
        cr, cb = (torch.randint(0, 256, (n, w // 2), generator=gen, device=dev,
                                dtype=torch.uint8) for _ in range(2))
        y[0], cr[0], cb[0] = 255, 255, 0  # both clamps
        got, want = plane_color(y, cr, cb), plane_color_ref(y, cr, cb)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"phase 21: plane colour {n}x{w}: "
              f"{'identical' if same else 'DIFFERS'}")
        check(same, f"plane colour kernel differs at {n}x{w}")
        del y, cr, cb, got, want

    # -- kernel against plain at the A/B shapes (phase 4's method) -----------
    n = CAND_AB.get("n_blocks", 2 * 1024 * 1024)
    tiles = torch.randint(0, 256, (n, 8, 8), generator=gen, device=dev,
                          dtype=torch.uint8)
    zz = fused_forward_candidate_ref(tiles, LUM, 8, 8)
    key = _table_key(LUM)
    pixels = tiles.reshape(n, 64).float()
    m = mcu._forward_basis_on(8, 8, key, dev)[1]
    minv = mcu._inverse_basis_on(8, 8, key, dev)[1]
    times = {}
    with timing.no_tf32():
        times["mcu_forward"] = time_versions(
            f"phase 21: mcu forward {n} x 64",
            {"plain": lambda x: fused_forward_candidate_ref(x, LUM, 8, 8),
             "kernel": lambda x: fused_forward_candidate(x, LUM, 8, 8),
             "library": lambda x: pixels @ m.t()},
            tiles, identical=False)
        del pixels
        times["mcu_inverse"] = time_versions(
            f"phase 21: mcu inverse {n} x 64",
            {"plain": lambda z: fused_inverse_candidate_ref(z, LUM, 8, 8),
             "kernel": lambda z: fused_inverse_candidate(z, LUM, 8, 8),
             "library": lambda z: z @ minv.t()},
            zz, identical=False)
        # The inverse's worst case: fractions need all nine part products.
        frac, _ = fractions(zz, LUM, 8)
        worst = time_versions(
            f"phase 21: mcu inverse {n} x 64, fractions",
            {"plain": lambda z: fused_inverse_candidate_ref(z, LUM, 8, 8),
             "kernel": lambda z: fused_inverse_candidate(z, LUM, 8, 8)},
            frac, identical=False)
    inv_flops = {"codec": mcu.inverse_products(zz) * MCU_FLOP_PER_PRODUCT,
                 "fractions": mcu.inverse_products(frac) * MCU_FLOP_PER_PRODUCT}
    b_ms, by = bound(n * (4 * 64 + 64), inv_flops["fractions"])
    print(f"phase 21: mcu inverse on fractions: kernel {worst['kernel']:.4f} "
          f"ms, plain {worst['plain']:.4f} ms; bound {b_ms:.4f} ms ({by}; "
          f"{inv_flops['fractions'] / 1e9:.1f} GFLOP of part products), "
          f"{b_ms / worst['kernel']:.1%} of it")
    del frac
    zz16 = zz.to(torch.int16)
    times["rle_compact"] = time_versions(
        f"phase 21: rle {n} x 64 int16",
        {"plain": rle_encode_candidate_ref, "kernel": rle_encode_candidate},
        zz16)
    del tiles, zz, zz16
    w = COLOR_AB.get("size", 2048)
    h = COLOR_AB.get("batch", 64) * w
    planes = (torch.randint(0, 256, (h, w), generator=gen, device=dev,
                            dtype=torch.uint8),
              *(torch.randint(0, 256, (h, w // 2), generator=gen, device=dev,
                              dtype=torch.uint8) for _ in range(2)))
    times["plane_color"] = time_versions(
        f"phase 21: plane colour {h}x{w}",
        {"plain": lambda p: plane_color_ref(*p),
         "kernel": lambda p: plane_color(*p)}, planes)
    del planes
    bounds = {
        "mcu_forward": bound(n * (64 + 4 * 64), n * MCU_FWD_FLOP_PER_TILE),
        "mcu_inverse": bound(n * (4 * 64 + 64), inv_flops["codec"]),
        "rle_compact": bound(n * 64 * 2 + n * (128 * 2 + 4)),
        "plane_color": bound(h * w * 2 + h * w * 3),
    }
    for name, (b_ms, by) in bounds.items():
        t = times[name]
        print(f"phase 21: {name}: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms ({t['plain'] / t['kernel']:.1f}x); bound "
              f"{b_ms:.4f} ms ({by}), {b_ms / t['kernel']:.1%} of it")

    # -- both A/Bs at their defaults: the path these kernels serve -----------
    gc.collect()
    torch.cuda.empty_cache()
    wrappers = {"mcu_forward": fused_forward_candidate,
                "mcu_inverse": fused_inverse_candidate,
                "rle_compact": rle_encode_candidate,
                "plane_color": plane_color}
    launches, wall = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        ab = run_candidates_ab(**CAND_AB, device=dev,
                               output=str(tmp / "candidates_ab.json"))
        wall["candidates_ab"] = time.perf_counter() - t0
        for name in ("mcu_forward", "mcu_inverse", "rle_compact"):
            launches[name] = wrappers[name].launches
        plane_color.launches = 0
        t0 = time.perf_counter()
        pc = run_plane_color_ab(**COLOR_AB, device=dev,
                                output=str(tmp / "plane_color_ab.json"))
        wall["plane_color_ab"] = time.perf_counter() - t0
        launches["plane_color"] = plane_color.launches
        for path in sorted(tmp.iterdir()):
            art = json.loads(path.read_text())
            check(art.get("device") == str(dev) and art.get("card"),
                  f"{path.name} does not name the card")
    for name, count in launches.items():
        check(count > 0, f"the A/B never launched {name}")
    for op, r in ab["ops"].items():
        shipped = next(v for k, v in r.items() if k.startswith("torch_"))
        print(f"phase 21: A/B {op}: torch {shipped * 1e3:.4f} ms, kernel "
              f"{r['kernel_s'] * 1e3:.4f} ms, fence floor "
              f"{r['fence_floor_s'] * 1e3:.4f} ms per iteration "
              f"({r['speedup']:.2f}x)")
    print(f"phase 21: A/B gates {ab['gates']}; verdict: {ab['verdict']}")
    op = pc["ops"]["plane_color"]
    print(f"phase 21: colour A/B: kernel {op['kernel_planar_s'] * 1e3:.4f} ms "
          f"({op['kernel_mpix_s']:.1f} MPix/s), torch "
          f"{op['torch_interleaved_s'] * 1e3:.4f} ms ({op['torch_mpix_s']:.1f} "
          f"MPix/s), fence floor {op['fence_floor_s'] * 1e3:.4f} ms; verdict: "
          f"{pc['verdict']}")
    print(f"phase 21: launches per A/B call {launches}; wall s "
          + ", ".join(f"{k} {v:.2f}" for k, v in wall.items())
          + f"; phase {time.perf_counter() - t_phase:.2f} s")

    sources = {"mcu_forward": (MCU_SOURCE, "profiles/pallas_mcu.py:36"),
               "mcu_inverse": (MCU_SOURCE, "profiles/pallas_mcu.py:48"),
               "rle_compact": (RLE_SOURCE, "profiles/pallas_rle.py:52"),
               "plane_color": (COLOR_SOURCE,
                               "profiles/profile_plane_color_kernel.py:27")}
    errors = {"mcu_forward": mcu_err["forward"],
              "mcu_inverse": mcu_err["inverse"],
              "rle_compact": 0.0, "plane_color": 0.0}
    return [{
        "name": name,
        "route": "cuda",
        "source": sources[name][0],
        "replaces": sources[name][1],
        "launches": launches[name],
        "max_abs_err": errors[name],
        "ms": times[name]["kernel"],
        "plain_ms": times[name]["plain"],
        "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1],
        "library_ms": times[name].get("library"),
    } for name in wrappers]


def probes_phase(dev):
    """Phase 22: the forward megakernel's attribution variants
    (``profiles/megakernel.py``) against their plain versions and K1 on the
    card, then the ablation and the ladder at their defaults; returns the
    two kernel records."""
    import gc
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from lz4jpeg_tpu_torch.ops.fwd_megakernel import forward_combined
    from lz4jpeg_tpu_torch.ops.quantize import (
        CHROMINANCE_QUANTIZATION_TABLE as CHR,
        LUMINANCE_QUANTIZATION_TABLE as LUM,
    )
    from lz4jpeg_tpu_torch.profiles import megakernel as mk
    from lz4jpeg_tpu_torch.profiles.megakernel_ablate import (
        run_megakernel_ablation,
    )
    from lz4jpeg_tpu_torch.profiles.megakernel_dma import run_megakernel_ladder

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    pool = ThreadPoolExecutor(2)  # nvcc beside the card's work
    counted = (pool.submit(mk.band_sass_counts, None, mk.BAND_ROWS),
               pool.submit(mk.probe_ptxas))
    pool.shutdown(wait=False)

    # -- every variant against its plain version; the K1 rows against K1 ----
    flips = {v.name: [0, 0] for v in mk.RGB_VARIANTS}  # flips, outputs
    for frames, h, w in (*PROBE_CHECKS, PROBE_RAGGED):
        x = mk.noise_batch(frames, h, w, SEED + 22).to(dev)
        k1 = forward_combined(x, LUM, CHR)
        for v in mk.RGB_VARIANTS:
            got = mk.megakernel_variant(x, v.name, LUM, CHR)
            want = mk.megakernel_variant_ref(x, v.name, LUM, CHR)
            torch.cuda.synchronize()
            f = mk.variant_flips(x, got, want, v.name, LUM, CHR)
            flips[v.name][0] += f
            flips[v.name][1] += got.numel()
            line = f"{f} flips against plain in {got.numel()} outputs"
            if v.name in mk.SAME_AS_K1:
                same = torch.equal(got, k1)
                line += f"; {'identical' if same else 'DIFFERS'} to K1"
                check(same, f"phase 22: {v.name} differs from forward_combined "
                            f"at {frames}x{h}x{w}")
            if (frames, h, w) == max(PROBE_CHECKS) and v.name in mk.BAND_ROWS:
                same = 1 + sum(  # a race shows sometimes
                    torch.equal(mk.megakernel_variant(x, v.name, LUM, CHR), got)
                    for _ in range(PROBE_REPEATS - 1))
                line += (f"; {same} of {PROBE_REPEATS} launches identical "
                         "to the first")
                check(same == PROBE_REPEATS, f"phase 22: {v.name}: "
                      f"{PROBE_REPEATS - same} launches differ")
            print(f"phase 22: {v.name} {frames}x{h}x{w}: {line}")
            del got, want
        del x, k1
    for name, (f, total) in flips.items():
        check(f <= mk.flip_limit(name) * total,
              f"phase 22: {name}: {f} flips in {total} outputs")
    print("phase 22: every variant held to its plain version (flips "
          + ", ".join(f"{k} {f} ({f / n:.3g})" for k, (f, n) in flips.items()
                      if f)
          + f"; at most {mk.MAX_FLIP_SHARE} of the outputs, "
          f"{mk.RAW_FLIP_SHARE} for raw samples)")

    # -- each band row's build: groups, slots, registers, spills, SASS -------
    sass, usage = (job.result() for job in counted)
    builds = {}
    for name in mk.BAND_ROWS:
        f, c, u = mk.rgb_frame(name), sass[name], usage[name]
        a = mk.variant_attributes(name, dev)
        builds[name] = {"groups": c["groups"], "slots": f["slots"],
                        "spill_stores": u["spill_stores"],
                        "sass_per_tile": c["per_tile"]}
        print(f"phase 22: {name}: {c['groups']} groups of {f['group_warps']} "
              f"warps, {f['slots']} ring slots, {a['registers']} registers "
              f"({u['registers']} by ptxas), {u['spill_stores']} B spill "
              f"stores, {a['shared_bytes']} B shared memory, "
              f"{a['ctas_per_sm']} CTAs an SM; {c['per_tile']:.2f} warp "
              f"instructions a tile in its SASS (a band: {c['consumer']} a "
              f"consumer warp x {c['warps']}, {c['segments']} between "
              f"barriers; producer {c['producer']})")
        check(u["spill_stores"] == 0, f"phase 22: {name} spills")
        check(c["groups"] == f["groups"] and a["shared_bytes"] == f["smem"],
              f"phase 22: {name}'s build is not its frame's mirror")

    # -- both probes at their defaults, each count zeroed before its run ----
    runs = {"megakernel_ablate": run_megakernel_ablation,
            "megakernel_dma": run_megakernel_ladder}
    results, launches = probe_runs("phase 22", runs, PROBE_RUN, dev, t_phase)
    records = probe_records(results, launches, flips, PROBE_REPLACES)
    for record in records:
        for row in record["variants"]:
            row.update(builds.get(row["variant"], {}))
    return records


def probe_runs(phase, runs, params, dev, t_phase):
    """Run each of ``runs`` ({record name: runner}) on ``dev`` with
    ``params``, the variants' launch count set to 0 just before each run
    and read just after; check that each artifact names the card and that
    each run launched a variant; return the results and the counts."""
    import gc
    import tempfile

    import torch

    from lz4jpeg_tpu_torch.profiles import megakernel as mk

    results, launches, wall = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, run in runs.items():
            gc.collect()
            torch.cuda.empty_cache()
            mk.megakernel_variant.launches = 0
            t0 = time.perf_counter()
            results[key] = run(dev, **params, output=str(Path(tmp) / key))
            wall[key] = time.perf_counter() - t0
            launches[key] = mk.megakernel_variant.launches
            art = json.loads((Path(tmp) / key).read_text())
            check(art.get("device") == str(dev) and art.get("card"),
                  f"{key}'s artifact does not name the card")
    for key, count in launches.items():
        check(count > 0, f"{phase}: {key} never launched a variant")
    print(f"{phase}: launches per run {launches}; wall s "
          + ", ".join(f"{k} {v:.2f}" for k, v in wall.items())
          + f"; phase {time.perf_counter() - t_phase:.2f} s")
    return results, launches


def probe_records(results, launches, flips, replaces):
    """The kernel records of probe runs: the baseline row's time, bound
    and plain time, the launches of the whole run, the largest error of
    its variants (1 where one flipped, by ``flips``: {variant: (flips,
    outputs)}, which must hold every variant of the rows; the other steps,
    K1, stage A and the plain chain, are checked on their own) and every
    row."""
    from lz4jpeg_tpu_torch.profiles import megakernel as mk

    records = []
    for key, res in results.items():
        base = next(r for r in res["rows"] if r["row"] == res["baseline"])
        names = {r["variant"].split("+")[-1] for r in res["rows"]}
        names = {n for n in names if n in mk.BY_NAME}
        records.append({
            "name": key,
            "route": "cuda",
            "source": PROBE_SOURCE,
            "replaces": replaces[key],
            "launches": launches[key],
            "max_abs_err": max(1.0 if flips[n][0] else 0.0 for n in names),
            "ms": base["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": base["bound_ms"],
            "bound_by": base["bound_by"],
            "library_ms": None,
            "library": None,
            "variants": [{k: r[k] for k in (
                "row", "variant", "ms", "chain_ms", "vs_baseline_ms",
                "registers", "shared_bytes", "ctas_per_sm", "bound_ms",
                "bound_by", "share", "same_as")} for r in res["rows"]],
        })
    return records


def layouts_phase(dev):
    """Phase 23: the megakernel's KT layout variants (``profiles/
    megakernel.py``) against their plain versions and K1 on the card, a
    ragged and a refused N, repeated launches, each build's counts (the
    toolkit's, beside the card's work), then the three layout runners at
    their defaults; returns the three kernel records."""
    import ctypes
    import gc
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from lz4jpeg_tpu_torch.ops.fwd_megakernel import forward_combined, rgb_to_kt
    from lz4jpeg_tpu_torch.ops.quantize import (
        CHROMINANCE_QUANTIZATION_TABLE as CHR,
        LUMINANCE_QUANTIZATION_TABLE as LUM,
    )
    from lz4jpeg_tpu_torch.profiles import megakernel as mk
    from lz4jpeg_tpu_torch.profiles.megakernel_kt import run_megakernel_kt
    from lz4jpeg_tpu_torch.profiles.megakernel_t import run_megakernel_t
    from lz4jpeg_tpu_torch.profiles.megakernel_v2 import run_megakernel_v2

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    names = [v.name for v in mk.KT_VARIANTS]
    pool = ThreadPoolExecutor(2)  # nvcc beside the card's work
    counted = (pool.submit(mk.band_sass_counts, None, names),
               pool.submit(mk.probe_ptxas))
    pool.shutdown(wait=False)

    def identical(a, b):
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        return all(torch.equal(p, q) for p, q in zip(a, b))

    def held(kt, v, label):
        got = mk.megakernel_variant(kt, v.name, LUM, CHR)
        want = mk.megakernel_variant_ref(kt, v.name, LUM, CHR)
        torch.cuda.synchronize()
        f = mk.variant_flips(kt, got, want, v.name, LUM, CHR)
        n = mk.combined(got).numel()
        flips[v.name][0] += f
        flips[v.name][1] += n
        return got, f"{label}: {f} flips against plain in {n} outputs"

    # -- every KT variant against its plain version and K1 ------------------
    flips = {v.name: [0, 0] for v in mk.KT_VARIANTS}  # flips, outputs
    for frames, h, w in PROBE_CHECKS:
        x = mk.noise_batch(frames, h, w, SEED + 23, runs=True).to(dev)
        kt = rgb_to_kt(x)
        k1 = forward_combined(x, LUM, CHR)
        for v in mk.KT_VARIANTS:
            got, line = held(kt, v, f"{v.name} {frames}x{h}x{w}")
            if v.deltas:
                same = torch.equal(mk.combined(got), k1)
                line += f"; {'identical' if same else 'NOT identical'} to K1"
                check(same or v.name not in mk.KT_SAME_AS_K1,
                      f"phase 23: {v.name} differs from forward_combined at "
                      f"{frames}x{h}x{w}")
            if (frames, h, w) == max(PROBE_CHECKS):  # a race shows sometimes
                same = 1 + sum(
                    identical(mk.megakernel_variant(kt, v.name, LUM, CHR), got)
                    for _ in range(LAYOUT_REPEATS - 1))
                line += (f"; {same} of {LAYOUT_REPEATS} launches identical "
                         "to the first")
                check(same == LAYOUT_REPEATS, f"phase 23: {v.name}: "
                      f"{LAYOUT_REPEATS - same} launches differ")
            print(f"phase 23: {line}")
            del got
        del x, kt, k1
    # -- a ragged N, and one the route refuses -------------------------------
    kt = mk.noise_kt(LAYOUT_RAGGED_N, SEED + 23).to(dev)
    for v in mk.KT_VARIANTS:
        last = LAYOUT_RAGGED_N % v.tiles
        print("phase 23: " + held(kt, v, f"{v.name} ragged N {LAYOUT_RAGGED_N} "
                                  f"(last band {last} of {v.tiles} tiles)")[1])
    for name, (f, total) in flips.items():
        check(f <= mk.flip_limit(name) * total,
              f"phase 23: {name}: {f} flips in {total} outputs")
    kt = mk.noise_kt(LAYOUT_REFUSED_N, SEED).to(dev)
    try:
        mk.megakernel_variant(kt, "kt_full", LUM, CHR)
        refused = False
    except ValueError:
        refused = True
    check(refused, f"phase 23: the wrapper took N = {LAYOUT_REFUSED_N}")
    out = torch.empty((LAYOUT_REFUSED_N, 128), dtype=torch.int16, device=dev)
    lib = mk.load_kernel()
    rc = lib.fwd_probe_kt_launch(
        mk.VARIANTS.index(mk.BY_NAME["kt_full"]), kt.data_ptr(),
        (ctypes.c_void_p * 1)(out.data_ptr()), 0, LAYOUT_REFUSED_N,
        torch.cuda.current_stream(dev).cuda_stream)
    check(rc != 0, f"phase 23: the KT entry point took N = {LAYOUT_REFUSED_N}")
    torch.cuda.synchronize()
    del kt, out
    print("phase 23: every KT variant held to its plain version (flips "
          + ", ".join(f"{k} {f} ({f / n:.3g})" for k, (f, n) in flips.items()
                      if f)
          + f"; at most {mk.MAX_FLIP_SHARE} of the outputs); N = "
          f"{LAYOUT_REFUSED_N} refused by the wrapper and the entry point "
          f"({lib.fwd_probe_error_string(rc).decode()})")

    # -- each build: groups, registers, spills, SASS a tile -----------------
    sass, usage = (job.result() for job in counted)
    builds = {}
    for name in names:
        c, u = sass[name], usage[name]
        a = mk.variant_attributes(name, dev)
        roles = ", ".join(f"{role} {r['count']} x {r['warps']}"
                          for role, r in c.items() if isinstance(r, dict))
        builds[name] = {"groups": c["groups"], "spill_stores": u["spill_stores"],
                        "sass_per_tile": c["per_tile"]}
        print(f"phase 23: {name}: {c['groups']} groups, {a['registers']} "
              f"registers at launch ({u['registers']} by ptxas), "
              f"{u['spill_stores']} B spill stores, {a['shared_bytes']} B "
              f"shared memory, {a['ctas_per_sm']} CTAs an SM; "
              f"{c['per_tile']:.2f} warp instructions a tile in its SASS (a "
              f"band: {roles})")
        check(u["spill_stores"] == 0, f"phase 23: {name} spills")

    # -- the three runners at their defaults, each count zeroed before -----
    runs = {"megakernel_kt": run_megakernel_kt,
            "megakernel_t": run_megakernel_t,
            "megakernel_v2": run_megakernel_v2}
    results, launches = probe_runs("phase 23", runs, LAYOUT_RUN, dev, t_phase)
    records = probe_records(results, launches, flips, LAYOUT_REPLACES)
    for record in records:
        for row in record["variants"]:
            row.update(builds.get(row["variant"].split("+")[-1], {}))
    return records

def matcher_phase(dev, p10_words, k2_ms):
    """Phase 24: the matcher sorts (``profiles/bitonic_sort.py``,
    ``profiles/bucket_partition.py``) and the membership decode
    (``profiles/rle_decode.py``) against their plain versions on the card,
    then their three runners at their defaults; returns the four kernel
    records.  ``p10_words`` holds phase 10's luma and Cr packed16 words and
    lengths (numpy), ``k2_ms`` phase 8's K2 time."""
    import gc

    import torch

    from lz4jpeg_tpu_torch.ops import pack16
    from lz4jpeg_tpu_torch.profiles import bitonic_sort as bs
    from lz4jpeg_tpu_torch.profiles import bucket_partition as bp
    from lz4jpeg_tpu_torch.profiles import rle_decode as rd
    from lz4jpeg_tpu_torch.utils.inputs import crafted_packed16_rows

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    err = {"bitonic_sort": 0, "concentration_stages": 0,
           "compare_exchange_stages": 0, "rle_membership": 0}

    def held(name, label, got, want):
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        d = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
                for a, b in zip(got, want))
        err[name] = max(err[name], d)
        print(f"phase 24: {label}: {'identical' if same else 'DIFFERS'}")
        check(same, f"phase 24: {label} differs (max |d| {d})")

    # -- the sort: plain version, torch.sort + gather, the replay -----------
    keys_np, pay_np = bs.probe_blocks(max(SORT_BLOCKS), SEED + 24)
    pos = np.arange(bs.SLOTS, dtype=np.int64)
    crafted = {
        "sorted": (np.arange(bs.SLOTS, dtype=np.int64) << bs.LOG_SLOTS) | pos,
        "reversed": (np.arange(bs.SLOTS, dtype=np.int64)[::-1] << bs.LOG_SLOTS)
        | pos,
        "all-same-bucket": (np.full(bs.SLOTS, 12345, dtype=np.int64)
                            << bs.LOG_SLOTS) | pos[::-1],
    }
    cases = [(f"{n} blocks", keys_np[:n], pay_np[:n]) for n in SORT_BLOCKS]
    cases += [(f"crafted {name} block", k[None].astype(np.int32), pay_np[:1])
              for name, k in crafted.items()]
    for label, k_np, p_np in cases:
        k = torch.from_numpy(np.ascontiguousarray(k_np)).to(dev)
        p = torch.from_numpy(np.ascontiguousarray(p_np)).to(dev)
        want = bs.sort_gather(k, p)
        got = bs.bitonic_sort_blocks(k, p)
        held("bitonic_sort", f"sort {label} vs plain", got,
             bs.bitonic_sort_blocks_ref(k, p))
        held("bitonic_sort", f"sort {label} vs torch.sort + gather", got, want)
        tiles = bs.bitonic_sort_blocks(k.view(-1, bs.ROWS, bs.LANES),
                                       p.view(-1, bs.ROWS, bs.LANES),
                                       record_masks=True)
        held("bitonic_sort", f"replay {label}: sorted keys, input payload",
             tuple(t.reshape(k.shape) for t in tiles), (want[0], p))
        del k, p, want, got, tiles
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    dup_pay = torch.from_numpy(pay_np[:4]).to(dev)
    dup = torch.randint(0, 7, dup_pay.shape, dtype=torch.int32, device=dev,
                        generator=gen)
    for record in (False, True):
        held("bitonic_sort", f"duplicate keys (record_masks={record}) vs plain",
             bs.bitonic_sort_blocks(dup, dup_pay, record),
             bs.bitonic_sort_blocks_ref(dup, dup_pay, record))
    del dup, dup_pay

    # -- the largest sort launched again and again: a missing wait between
    # threads shows only sometimes --------------------------------------
    k = torch.from_numpy(keys_np).to(dev)
    p = torch.from_numpy(pay_np).to(dev)
    for record in (False, True):
        want = bs.bitonic_sort_blocks_ref(k, p, record)
        same = 0
        for _ in range(SORT_REPEATS):
            got = bs.bitonic_sort_blocks(k, p, record)
            same += torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        print(f"phase 24: sort {k.shape[0]} blocks (record_masks={record}) "
              f"{same} of {SORT_REPEATS} launches identical to plain")
        check(same == SORT_REPEATS, f"phase 24: {SORT_REPEATS - same} of "
              f"{SORT_REPEATS} sorts (record_masks={record}) differ")
    del keys_np, pay_np, k, p, want, got

    # -- both stage kernels, also on a view off a 16-byte boundary, at the
    # concentration's wave edges, on crafted rows, and launched again and
    # again ---------------------------------------------------------------
    for n in (*STAGE_BLOCKS, *STAGE_EDGES):
        x = bp.probe_tiles(n, SEED + 24).to(dev)
        views = [(f"{n} blocks", x)] + ([("offset view", offset_view(x))]
                                        if n == min(STAGE_BLOCKS) else [])
        for label, v in views:
            for name, (_, fn, ref, _) in bp.KERNELS.items():
                held(name, f"{name} {label} vs plain", fn(v), ref(v))
        del x, views
    x = bp.crafted_tiles().to(dev)
    for name, (_, fn, ref, _) in bp.KERNELS.items():
        held(name, f"{name} crafted rows vs plain", fn(x), ref(x))
    x = bp.probe_tiles(max(STAGE_BLOCKS), SEED + 25).to(dev)
    for name, (_, fn, ref, _) in bp.KERNELS.items():
        want = ref(x)
        same = sum(torch.equal(fn(x), want) for _ in range(STAGE_REPEATS))
        print(f"phase 24: {name} {x.shape[0]} blocks {same} of "
              f"{STAGE_REPEATS} launches identical to plain")
        check(same == STAGE_REPEATS, f"phase 24: {STAGE_REPEATS - same} of "
              f"{STAGE_REPEATS} launches of {name} differ")
    del x, want

    # -- the membership decode: K6 and plain, crafted rows, refusals --------
    for c, (w_np, l_np) in p10_words.items():
        w = torch.from_numpy(w_np).to(dev)
        lens = torch.from_numpy(l_np).to(dev)
        k = w.shape[1]
        got = rd.rle_decode_membership(w, lens, k)
        held("rle_membership", f"membership phase 10 {c} {tuple(w.shape)} vs K6",
             got, pack16.pack16_decode(w, lens, k))
        held("rle_membership", f"membership phase 10 {c} vs plain", got,
             rd.rle_decode_membership_ref(w, lens, k))
        del w, lens, got
    rng = np.random.default_rng(SEED + 24)
    for k in rd.SEGMENTS:
        tile = rd.WARPS * rd.membership_thread_map(k)[0]  # rows a CTA pass
        for n in (*MEMBER_ROWS, tile - 1, tile, tile + 1):
            w_np, l_np = crafted_packed16_rows(k, rng, n_random=max(0, n - 12))
            w = torch.from_numpy(w_np[:n]).to(dev)
            lens = torch.from_numpy(l_np[:n]).to(dev)
            for out_size in (k, k // 2 + 3):
                got = rd.rle_decode_membership(w, lens, out_size)
                label = f"membership crafted L {k} rows {n} out {out_size}"
                held("rle_membership", f"{label} vs K6", got,
                     pack16.pack16_decode(w, lens, out_size))
                held("rle_membership", f"{label} vs plain", got,
                     rd.rle_decode_membership_ref(w, lens, out_size))
    lib = rd.load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for k, out_size in MEMBER_REFUSED:
        w = torch.zeros((5, k), dtype=torch.int16, device=dev)
        lens = torch.zeros((5,), dtype=torch.int32, device=dev)
        out = torch.empty((5, out_size), dtype=torch.int32, device=dev)
        try:
            rd.rle_decode_membership(w, lens, out_size)
            refused = False
        except ValueError:
            refused = True
        rc = lib.rle_membership_launch(w.data_ptr(), lens.data_ptr(),
                                       out.data_ptr(), 5, k, out_size, stream)
        print(f"phase 24: membership L {k} out {out_size}: wrapper "
              f"{'refused' if refused else 'TOOK IT'}, entry point "
              f"{lib.rle_membership_error_string(rc).decode() if rc else 'TOOK IT'}")
        check(refused and rc != 0,
              f"phase 24: L {k}, out_size {out_size} was not refused")
    torch.cuda.synchronize()

    # -- resources and spills ----------------------------------------------
    from lz4jpeg_tpu_torch.profiles import sass_loops

    for label, attrs in (("sort", bs.sort_attributes(False, dev)),
                         ("sort + replay", bs.sort_attributes(True, dev)),
                         ("membership L 64", rd.membership_attributes(64, dev)),
                         ("membership L 32", rd.membership_attributes(32, dev)),
                         ("concentration stages",
                          bp.stage_attributes(bp.CONCENTRATION, dev)),
                         ("compare-exchange stages",
                          bp.stage_attributes(bp.COMPARE_EXCHANGE, dev))):
        print(f"phase 24: {label}: {attrs['registers']} registers, "
              f"{attrs['shared_bytes']} B of shared memory, "
              f"{attrs['ctas_per_sm']} CTAs an SM")
    for source in ("bitonic_sort_kernel", "rle_membership_kernel",
                   "stage_rate_kernel"):
        for kernel, spilled in sass_loops.spill_stores(source).items():
            print(f"phase 24: {kernel}: {spilled} bytes of spill stores")
    sass_counts = bp.stage_sass_counts()
    for kind, name in ((bp.CONCENTRATION, "concentration_stages"),
                       (bp.COMPARE_EXCHANGE, "compare_exchange_stages")):
        check(kind in sass_counts and sass_counts[kind] > 0,
              f"phase 24: {name}'s SASS loop was not counted")
        print(f"phase 24: {name}: {sass_counts[kind]:.4f} lane instructions "
              f"per stage-element in its SASS loop (the runner's SASS floor "
              f"takes this count)")
    print(f"phase 24: checks in {time.perf_counter() - t_phase:.2f} s; max "
          f"|kernel - plain| {err}")

    # -- the three runners at their defaults, each count zeroed before -----
    runners = {"bitonic_sort": (bs.run_bitonic_sort, SORT_RUN,
                                (bs.bitonic_sort_blocks,)),
               "bucket_partition": (bp.run_bucket_partition,
                                    {**STAGE_RUN, "sass_counts": sass_counts},
                                    (bp.concentration_stages,
                                     bp.compare_exchange_stages)),
               "rle_decode": (rd.run_rle_decode_ab, RLE_RUN,
                              (rd.rle_decode_membership,))}
    results, by_run = probe_runner_runs(24, runners, dev, t_phase)
    launches = {name: count for counts in by_run.values()
                for name, count in counts.items()}

    sort = {r["row"]: r for r in results["bitonic_sort"]["rows"]}
    s_ms = sort["bitonic sort 2-op"]["ms"]
    print(f"phase 24: sort {s_ms:.4f} ms, with replay "
          f"{sort['bitonic sort 2-op + reverse replay']['ms']:.4f}, torch.sort "
          f"{sort['torch.sort keys only']['ms']:.4f}, + gather "
          f"{sort['torch.sort + torch.gather']['ms']:.4f}; K2 (keys only, "
          f"with its candidates, phase 8) {k2_ms:.4f} ms")
    stages = results["bucket_partition"]["sizes"][-1]
    rle = results["rle_decode"]
    print(f"phase 24: at {stages['blocks']} blocks concentration / "
          f"compare-exchange per stage "
          f"{stages['concentration_over_compare_exchange']:.3f}; a 16-bit radix "
          f"partition {stages['radix_over_bitonic_time']:.2f}x the bitonic "
          f"network's stage time")

    res = results["bitonic_sort"]
    records = [{
        "name": "bitonic_sort", "route": "cuda", "source": SORT_SOURCE,
        "replaces": "profiles/profile_pallas_sort.py:35",
        "launches": launches["bitonic_sort_blocks"],
        "max_abs_err": float(err["bitonic_sort"]), "ms": s_ms,
        "plain_ms": sort["plain version (torch ops)"]["ms"],
        "bound_ms": res["bytes_bound_ms"], "bound_by": "bytes",
        "library_ms": sort["torch.sort keys only"]["ms"],
        "library": "torch.sort (keys only, stable)",
        "issue_bound_ms": res["issue_bound_ms"],
        "replay_ms": sort["bitonic sort 2-op + reverse replay"]["ms"],
        "replay_issue_bound_ms": res["replay_issue_bound_ms"],
        "issue_counts": res["issue_counts"],
    }]
    for name, line in (("concentration_stages", 45),
                       ("compare_exchange_stages", 59)):
        r = stages["kernels"][name]
        records.append({
            "name": name, "route": "cuda", "source": STAGE_SOURCE,
            "replaces": f"profiles/probe_bucket_partition.py:{line}",
            "launches": launches[name], "max_abs_err": float(err[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bytes_bound_ms"], "bound_by": "bytes",
            "library_ms": None, "issue_bound_ms": r["issue_bound_ms"],
            "issue_counts": r["issue_counts"],
            "sass_issue_bound_ms": r["sass_issue_bound_ms"],
            "sass_counts": r["sass_counts"],
            "blocks": stages["blocks"],
            "ps_per_stage_elem": r["ps_per_stage_elem"],
        })
    v = rle["versions"]
    records.append({
        "name": "rle_membership", "route": "cuda", "source": MEMBERSHIP_SOURCE,
        "replaces": "profiles/pallas_rle_decode.py:26",
        "launches": launches["rle_decode_membership"],
        "max_abs_err": float(err["rle_membership"]),
        "ms": v["membership kernel"]["ms"],
        "plain_ms": v["plain pack16_decode_ref"]["ms"],
        "bound_ms": rle["bytes_bound_ms"], "bound_by": "bytes",
        "library_ms": None, "issue_bound_ms": rle["issue_bound_ms"],
        "issue_counts": rle["issue_counts"],
        "k6_ms": v["K6 pack16_decode"]["ms"],
        "k8_ms": v["K8 pack16_decode_wide"]["ms"],
    })
    return records


def expand_phase(dev, p10_words):
    """Phase 25: K7's phase split (``profiles/rle_expand.py``): the three
    copies and the phases (the full one K7) against their plain versions on
    the card, refusals, then both runners at their
    defaults; returns the five kernel records.  ``p10_words`` holds phase
    10's luma and Cr packed16 words and lengths (numpy)."""
    import gc

    import torch

    from lz4jpeg_tpu_torch.ops import pack16
    from lz4jpeg_tpu_torch.ops.rle import rle_encode_packed16
    from lz4jpeg_tpu_torch.profiles import rle_expand as rx
    from lz4jpeg_tpu_torch.profiles.rle_expand_ablate import (
        run_rle_expand_ablate,
    )
    from lz4jpeg_tpu_torch.profiles.rle_expand_rm import run_rle_expand_rm
    from lz4jpeg_tpu_torch.utils.inputs import crafted_packed16_rows

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    copies = {"copy_rm": rx.copy_rm, "copy_t_contig": rx.copy_t_contig,
              "copy_t_slab": rx.copy_t_slab}
    err = dict.fromkeys([*copies, "expand_plane_phase"], 0)

    def held(name, label, got, want):
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        d = int((got.long() - want.long()).abs().max()) if (
            got.shape == want.shape and got.numel()) else (0 if same else -1)
        err[name] = max(err[name], d)
        print(f"phase 25: {label}: {'identical' if same else 'DIFFERS'}")
        check(same, f"phase 25: {label} differs (max |d| {d})")

    def rm_held(label, x):
        got = rx.copy_rm(x)
        copy_ctas(f"phase 25: {label} launch", x.data_ptr(), got.data_ptr(),
                  x.numel() * 2)
        held("copy_rm", label, got, rx.copy_rm_ref(x))

    # -- the copies: the probe's shapes, ragged ones, views ----------------
    rng = np.random.default_rng(SEED + 25)
    for rows, k in EXPAND_RM_EDGES:
        p = torch.from_numpy(rx.stream_values(rows, k, rng)).to(dev)
        views = [("", p), (" offset view", offset_view(p))]
        if rows * k % 128 == 0:
            views.append((" wide view", p.view(-1, 128)))
        for tag, x in views:
            rm_held(f"copy_rm ({rows}, {k}){tag}", x)
        del p, views
    for rows, k, bw in EXPAND_COPIES:
        p = torch.from_numpy(rx.stream_values(rows, k, rng)).to(dev)
        views = [("", p), (" offset view", offset_view(p))]
        if rows * k % 128 == 0:
            views.append((" wide view", p.view(-1, 128)))
        for tag, x in views:
            label = f"({rows}, {k}) bw {bw}{tag}"
            rm_held(f"copy_rm {label}", x)
            if "wide" in tag:
                continue
            held("copy_t_contig", f"copy_t_contig {label}", rx.copy_t_contig(x),
                 rx.copy_t_contig_ref(x))
            held("copy_t_slab", f"copy_t_slab {label}", rx.copy_t_slab(x, bw),
                 rx.copy_t_slab_ref(x, bw))
        del p, views

    # -- the phases: the probe's words, phase 10's, crafted rows -----------
    def phases_held(label, w, lens, bw):
        for phase in rx.PHASES:
            got = rx.expand_plane_phase(w, lens, bw, phase)
            held("expand_plane_phase", f"{phase} {label} vs plain", got,
                 rx.expand_plane_phase_ref(w, lens, bw, phase))
        held("expand_plane_phase", f"full (K7) {label} vs "
             "pack16_decode_plane_ref", got,
             pack16.pack16_decode_plane_ref(w, lens, bw))

    for k, bw in ((64, SIDE // 8), (32, SIDE // 16)):
        vals = torch.from_numpy(
            rx.ablate_symbols(EXPAND_PROBE_BH * bw, k, rng)).to(dev)
        w, lens = rle_encode_packed16(vals)
        phases_held(f"probe words ({w.shape[0]}, {k}) bw {bw}", w, lens, bw)
        del vals, w, lens
    for c, (w_np, l_np) in p10_words.items():
        w = torch.from_numpy(w_np).to(dev)
        lens = torch.from_numpy(l_np).to(dev)
        phases_held(f"phase 10 {c} {tuple(w.shape)} bw {SIDE // 8}", w, lens,
                    SIDE // 8)
        del w, lens
    for k in rx.PHASE_SEGMENTS:
        for rows, bw in EXPAND_CRAFTED:
            w_np, l_np = crafted_packed16_rows(k, rng, n_random=max(0, rows - 12))
            w = torch.from_numpy(w_np[:rows]).to(dev)
            lens = torch.from_numpy(l_np[:rows]).to(dev)
            phases_held(f"crafted K {k} rows {rows} bw {bw}", w, lens, bw)
            if rows == max(r for r, _ in EXPAND_CRAFTED):
                phases_held(f"crafted K {k} offset view", offset_view(w), lens,
                            bw)

    # -- refusals, by the wrappers and by the C entry points ---------------
    copy_lib, phase_lib = rx.load_copy_kernels(), rx.load_phase_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    x12 = torch.zeros((16, 12), dtype=torch.int16, device=dev)
    x64 = torch.zeros((1000, 64), dtype=torch.int16, device=dev)
    w16 = torch.zeros((16, 16), dtype=torch.int16, device=dev)
    l16 = torch.zeros((16,), dtype=torch.int32, device=dev)
    sink = torch.empty(64_000, dtype=torch.int16, device=dev)
    refusals = (
        ("copy_rm K 12", lambda: rx.copy_rm(x12),
         lambda: copy_lib.rle_expand_copy_rm_launch(
             x12.data_ptr(), sink.data_ptr(), 16, 12, stream),
         copy_lib.rle_expand_copy_error_string),
        ("copy_t_slab rows 1000 bw 256", lambda: rx.copy_t_slab(x64, 256),
         lambda: copy_lib.rle_expand_copy_t_slab_launch(
             x64.data_ptr(), sink.data_ptr(), 1000, 64, 256, stream),
         copy_lib.rle_expand_copy_error_string),
        ("phase dist K 16", lambda: rx.expand_plane_phase(w16, l16, 8, "dist"),
         lambda: phase_lib.expand16_probe_launch(
             rx.ABLATED.index("dist"), w16.data_ptr(), l16.data_ptr(),
             sink.data_ptr(), 2, 8, 16, stream),
         phase_lib.expand16_probe_error_string),
    )
    for label, wrapper, entry, error_string in refusals:
        refused_by_both(25, label, wrapper, entry, error_string)
    torch.cuda.synchronize()
    print(f"phase 25: checks in {time.perf_counter() - t_phase:.2f} s; max "
          f"|kernel - plain| {err}")

    # -- both runners at their defaults, each count zeroed before ----------
    runners = {"rm": (run_rle_expand_rm, EXPAND_RM_RUN,
                      (rx.copy_rm, rx.copy_t_contig, rx.copy_t_slab)),
               "ablate": (run_rle_expand_ablate, EXPAND_ABLATE_RUN,
                          (rx.expand_plane_phase, rx.copy_t_slab,
                           pack16.pack16_decode_plane))}
    results, launches = probe_runner_runs(25, runners, dev, t_phase)
    rm = results["rm"]["copies"]
    check(rm[0]["launches"] + rm[1]["launches"] == launches["rm"]["copy_rm"],
          "phase 25: copy_rm's rows do not add up to its count")
    ab = results["ablate"]["channels"]

    records = []
    for r, name, line, counter in (
            (rm[0], "rle_expand_copy_rm", 50, "copy_rm"),
            (rm[1], "rle_expand_copy_rm_wide", 95, "copy_rm"),
            (rm[2], "rle_expand_copy_t_contig", 53, "copy_t_contig"),
            (rm[3], "rle_expand_copy_t_slab", 56, "copy_t_slab")):
        records.append({
            "name": name, "route": "cuda", "source": COPIES_SOURCE,
            "replaces": f"profiles/profile_rle_expand_rm.py:{line}",
            "launches": (r["launches"] if counter == "copy_rm" else
                         launches["rm"][counter]
                         + launches["ablate"].get(counter, 0)),
            "max_abs_err": float(err[counter]), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bytes_bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"],
            "library": r["library"], "shape": r["shape"],
        })
    lum_dist = next(p for p in ab["lum"]["phases"] if p["phase"] == "dist")
    records.append({
        "name": "expand16_phases", "route": "cuda", "source": PHASES_SOURCE,
        "replaces": "profiles/profile_rle_expand_ablate.py:38",
        "launches": launches["ablate"]["expand_plane_phase"],
        "max_abs_err": float(err["expand_plane_phase"]), "row": "lum dist",
        "ms": lum_dist["ms"], "plain_ms": lum_dist["plain_ms"],
        "bound_ms": ab["lum"]["bytes_bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "variants": [
            {"channel": tag, "phase": p["phase"], "ms": p["ms"],
             "plain_ms": p["plain_ms"], "delta_ms": p["delta_ms"],
             "launches": p["launches"],
             "bound_ms": c["bytes_bound_ms"], "share": p["share"],
             "registers": p["registers"], "shared_bytes": p["shared_bytes"],
             "ctas_per_sm": p["ctas_per_sm"],
             **({"copy_t_slab_ms": p["copy_t_slab_ms"]}
                if "copy_t_slab_ms" in p else {})}
            for tag, c in ab.items() for p in c["phases"]],
    })
    return records


def gates_phase(dev):
    """Phase 26: the sublane RLE, the casts and the fused-DCT gates
    (``profiles/sublane_rle.py``, ``casts.py``, ``dct_gates.py``) against
    their plain versions on the card, refusals, then the four runners at
    their defaults; returns the six kernel records."""
    import gc

    import torch

    from lz4jpeg_tpu_torch.ops import pack16
    from lz4jpeg_tpu_torch.ops.stream import stream_copy
    from lz4jpeg_tpu_torch.profiles import casts
    from lz4jpeg_tpu_torch.profiles import dct_gates as dg
    from lz4jpeg_tpu_torch.profiles import sublane_rle as sr
    from lz4jpeg_tpu_torch.profiles.plane_exact import run_plane_exact
    from lz4jpeg_tpu_torch.profiles.sublane_butterfly import (
        run_sublane_butterfly,
    )

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    err = dict.fromkeys(["sublane_rle", "cast", "basis_dot", "minor_transpose",
                         "lane_split"], 0.0)

    def held(name, label, same, d=0.0):
        err[name] = max(err[name], d)
        print(f"phase 26: {label}: {'identical' if same else 'DIFFERS'}")
        check(same, f"phase 26: {label} differs")

    # -- the sublane RLE: probe values, ragged widths, views, int16 --------
    rng = np.random.default_rng(SEED + 26)
    for seg in sr.SEGMENTS:
        for cols in SUBLANE_COLS:
            x = (sr.uniform_values(seg, cols, dev, SEED + seg)
                 if cols > 100_000 else
                 torch.from_numpy(sr.probe_values(seg, cols, rng)).to(dev))
            for tag, v in (("int32", x), ("int16", x.to(torch.int16)),
                           ("int32 offset view", offset_view(x))):
                packed, runs = sr.sublane_rle(v)
                want_p, want_r = sr.sublane_rle_ref(v)
                torch.cuda.synchronize()
                held("sublane_rle", f"sublane SEG {seg} ({seg}, {cols}) {tag}",
                     torch.equal(packed, want_p) and torch.equal(runs, want_r))
            del x, packed, runs, want_p, want_r

    # -- the casts: the probe's tile, the whole range, views, ragged, the ---
    # -- chunk edges (1, a vector - 1, a chunk ± 1), 2^31 bytes out --------
    for pair, (src, dst) in enumerate(casts.PAIRS):
        full = casts.full_range(src, rng).to(dev)
        plan = casts.cast_plan(pair, 0)
        chunk = plan.vec_elems * plan.threads
        edges = sorted({1, max(plan.vec_elems - 1, 1), chunk - 1, chunk,
                        chunk + 1})
        cases = [("probe tile", casts.probe_values(src, rng).to(dev)),
                 ("whole range", full), ("offset view", offset_view(full)),
                 (f"{CAST_RAGGED} random",
                  casts.random_values(src, CAST_RAGGED, dev, pair))]
        cases += [(f"{n} random (chunk edge)",
                   casts.random_values(src, n, dev, n)) for n in edges]
        for tag, x in cases:
            got = casts.cast(x, dst)
            torch.cuda.synchronize()
            name = f"cast {casts.pair_name(pair)} {tag}"
            cast_ctas(f"phase 26: {name} launch", pair, x.numel())
            held("cast", name, casts.same(got, casts.cast_ref(x, dst)))
    x = casts.random_values(torch.uint8, CAST_BIG, dev, 29)
    got = casts.cast(x, torch.int32)
    torch.cuda.synchronize()
    check(got.numel() * 4 > 1 << 31, "phase 26: the big cast is under 2^31 B")
    cast_ctas(f"phase 26: cast uint8->int32 {CAST_BIG} launch", 2, CAST_BIG)
    held("cast", f"cast uint8->int32 {CAST_BIG} ({CAST_BIG * 4} bytes out)",
         torch.equal(got, x.to(torch.int32)))
    del x, got, full, cases

    # -- the basis product: within its bound; against cuBLAS; at the ring's
    # -- edges: one tile short of and past a full ring a CTA (ragged) ------
    m = dg.luma_basis(dev)
    ulps = {}
    resident = dg.dot_launch_plan(1 << 30, dev).resident
    ring = resident * dg.DOT_STAGES * dg.DOT_TILE_ROWS
    ring_rows = (ring - dg.DOT_TILE_ROWS - 3, ring + dg.DOT_TILE_ROWS - 3)
    for rows in (*DOT_ROWS, *ring_rows, "offset view"):
        x = dg.probe_pixels(4099 if rows == "offset view" else rows, rng).to(dev)
        if rows == "offset view":
            x = offset_view(x)
        dot_ctas(f"phase 26: basis product {rows} rows launch", x.shape[0],
                 dev, resident)
        got = dg.basis_dot(x, m)
        plain = dg.basis_dot_ref(x, m)
        torch.cuda.synchronize()
        e, p_e = dg.dot_error(got, x, m), dg.dot_error(plain, x, m)
        ulps[str(rows)] = dg.ulp_compare(got, plain)
        d = float((got - plain).abs().max())
        print(f"phase 26: basis product {rows} rows: {ulps[str(rows)]['differ']}"
              f"/{ulps[str(rows)]['outputs']} outputs differ from cuBLAS (max "
              f"{ulps[str(rows)]['max_ulp']} ulp, max |d| {d}); kernel error "
              f"{e['max_err_over_bound']:.3g}, cuBLAS "
              f"{p_e['max_err_over_bound']:.3g} of 64·2^-24·Σ|x·m|")
        held("basis_dot", f"basis product {rows} rows within the bound",
             e["within"] and p_e["within"], d)
        del x, got, plain

    # -- the transpose on both routes, and the split ------------------------
    routes_before = dict(dg.minor_transpose.routes)
    want_routes = dict.fromkeys(dg.ROUTES, 0)
    offsets = {"offset view": (6, 131, 8), "offset view bw 132": (6, 132, 8)}
    for shape in (*TRANSPOSE_SHAPES, *TRANSPOSE_ROUTES, *offsets):
        x = dg.device_pixels(offsets.get(shape, shape), dev, SEED)
        if shape in offsets:
            x = offset_view(x)
        got = dg.minor_transpose(x)
        torch.cuda.synchronize()
        route = dg.transpose_route(*x.shape, x.data_ptr(), got.data_ptr())
        want_routes[route] += 1
        held("minor_transpose", f"transpose {shape} ({route} route)",
             torch.equal(got, dg.minor_transpose_ref(x)))
        del x, got
    routes = {r: dg.minor_transpose.routes[r] - routes_before[r]
              for r in dg.ROUTES}
    print(f"phase 26: transpose launches by route {routes}")
    check(routes == want_routes and all(routes.values()),
          f"phase 26: transpose routes {routes}, want {want_routes}")
    for shape, tw in SPLIT_SHAPES:
        x = dg.device_pixels(shape, dev, SEED)
        for tag, v in (("", x), (" offset view", offset_view(x))):
            before = stream_copy.launches
            got = dg.lane_split(v, tw)
            torch.cuda.synchronize()
            copy_ctas(f"phase 26: lane split {shape} tw {tw}{tag} launch",
                      v.data_ptr(), got.data_ptr(), v.numel() * 4)
            check(stream_copy.launches == before + 1,
                  "phase 26: the split did not launch the copy kernel")
            held("lane_split", f"lane split {shape} tw {tw}{tag}",
                 torch.equal(got, dg.lane_split_ref(v, tw)))
        del x, got

    # -- refusals, by the wrappers and by the C entry points ---------------
    stream = torch.cuda.current_stream(dev).cuda_stream
    s_lib, c_lib, g_lib = sr.load_kernel(), casts.load_kernel(), dg.load_kernel()
    i16 = torch.zeros((16, 128), dtype=torch.int32, device=dev)
    f64 = torch.zeros((64, 64), dtype=torch.float32, device=dev)
    sink = torch.empty(1 << 16, dtype=torch.int32, device=dev)
    refusals = (
        ("sublane SEG 16", lambda: sr.sublane_rle(i16),
         lambda: s_lib.sublane_rle_launch(i16.data_ptr(), 4, sink.data_ptr(),
                                          sink.data_ptr(), 16, 128, stream),
         s_lib.sublane_rle_error_string),
        ("sublane 3-D input", lambda: sr.sublane_rle(i16.view(2, 8, 128)),
         lambda: s_lib.sublane_rle_launch(i16.data_ptr(), 8, sink.data_ptr(),
                                          sink.data_ptr(), 64, 128, stream),
         s_lib.sublane_rle_error_string),
        ("cast int32 -> int16", lambda: casts.cast(i16, torch.int16),
         lambda: c_lib.cast_launch(7, i16.data_ptr(), sink.data_ptr(), 16,
                                   stream),
         c_lib.cast_error_string),
        ("basis product width 32", lambda: dg.basis_dot(f64[:, :32].contiguous(),
                                                        f64),
         lambda: g_lib.basis_dot_launch(f64.data_ptr(), f64.data_ptr(),
                                        sink.data_ptr(), 64, 32, 64, stream),
         g_lib.dct_gate_error_string),
        ("transpose tw 0",
         lambda: dg.minor_transpose(torch.zeros((8, 256, 0), device=dev)),
         lambda: g_lib.minor_transpose_launch(f64.data_ptr(), sink.data_ptr(),
                                              8, 256, 0, stream),
         g_lib.dct_gate_error_string),
    )
    for label, wrapper, entry, error_string in refusals:
        refused_by_both(26, label, wrapper, entry, error_string)
    torch.cuda.synchronize()
    del i16, f64, sink
    attrs = {f"sublane SEG {seg} {b}-byte": sr.attributes(seg, b, dev)
             for seg in sr.SEGMENTS for b in (2, 4)}
    attrs.update({f"cast {casts.pair_name(p)}": casts.attributes(p, dev)
                  for p in range(len(casts.PAIRS))})
    attrs["basis_dot"] = dg.attributes(dg.DOT, device=dev)
    attrs.update({f"transpose tw {tw}": dg.attributes(dg.TRANSPOSE, tw, dev)
                  for tw in (8, 4)})
    attrs.update({f"transpose vector route tw {tw}":
                  dg.attributes(dg.TRANSPOSE_VEC, tw, dev)
                  for tw in dg.VECTOR_TW})
    for name, a in attrs.items():
        print(f"phase 26: {name}: regs {a['registers']}, smem "
              f"{a['shared_bytes']} B, CTAs/SM {a['ctas_per_sm']}")
    print(f"phase 26: checks in {time.perf_counter() - t_phase:.2f} s; max "
          f"|kernel - plain| {err}")

    # -- the four runners at their defaults, each count zeroed before ------
    runners = {
        "butterfly": (run_sublane_butterfly, BUTTERFLY_RUN,
                      (sr.sublane_rle, pack16.pack16_encode_kt,
                       pack16.pack16_encode)),
        "plane_exact": (run_plane_exact, PLANE_EXACT_RUN, (sr.sublane_rle,)),
        "casts": (casts.run_casts, CASTS_RUN, (casts.cast,)),
        "gates": (dg.run_dct_gates, GATES_RUN,
                  (dg.basis_dot, dg.minor_transpose, stream_copy)),
    }
    dg.minor_transpose.routes = dict.fromkeys(dg.ROUTES, 0)  # only the gates
    results, launches = probe_runner_runs(26, runners, dev, t_phase)  # call it
    run_routes = dict(dg.minor_transpose.routes)
    print(f"phase 26: the gates runner's transposes by route {run_routes}")
    check(run_routes["vector"] > 0,
          "phase 26: the gates runner's bands missed the vector route")

    bfly, plane = results["butterfly"], results["plane_exact"]
    by_pair = {r["pair"]: r for r in results["casts"]["pairs"]}
    widest = by_pair[casts.pair_name(1)]  # int32 -> float32, the most bytes
    timed = results["gates"]["timed"]
    record = {"route": "cuda", "library_ms": None}
    return [
        {**record, "name": "sublane_rle", "source": SUBLANE_SOURCE,
         "replaces": "profiles/profile_sublane_butterfly.py:24",
         "launches": launches["butterfly"]["sublane_rle"],
         "max_abs_err": err["sublane_rle"], "shape": [bfly["seg"], bfly["cols"]],
         "ms": bfly["ms"], "plain_ms": bfly["plain_ms"],
         "bound_ms": bfly["bytes_bound_ms"], "bound_by": "bytes",
         "relayout_ms": bfly["relayout_ms"], "ways": bfly["ways"],
         "registers": bfly["registers"], "shared_bytes": bfly["shared_bytes"],
         "ctas_per_sm": bfly["ctas_per_sm"]},
        {**record, "name": "sublane_rle_seg", "source": SUBLANE_SOURCE,
         "replaces": "profiles/profile_plane_exact.py:63",
         "launches": launches["plane_exact"]["sublane_rle"],
         "max_abs_err": err["sublane_rle"], "shape": [plane["seg"],
                                                      plane["cols"]],
         "ms": plane["ms"], "plain_ms": plane["plain_ms"],
         "bound_ms": plane["bytes_bound_ms"], "bound_by": "bytes",
         "einsum_mismatches": plane["total_mismatches"],
         "registers": plane["registers"], "shared_bytes": plane["shared_bytes"],
         "ctas_per_sm": plane["ctas_per_sm"]},
        {"name": "cast", "route": "cuda", "source": CAST_SOURCE,
         "replaces": "profiles/profile_mosaic_casts.py:15",
         "launches": launches["casts"]["cast"], "max_abs_err": err["cast"],
         "row": widest["pair"], "ms": widest["ms"],
         "plain_ms": widest["plain_ms"], "bound_ms": widest["bytes_bound_ms"],
         "bound_by": "bytes", "library_ms": widest["library_ms"],
         "library": "x.to(dst)",
         "variants": [{k: r[k] for k in ("pair", "ms", "library_ms", "launches",
                                         "bytes_bound_ms", "share", "registers",
                                         "shared_bytes", "ctas_per_sm")}
                      for r in results["casts"]["pairs"]]},
        {"name": "basis_dot", "route": "cuda", "source": GATE_SOURCE,
         "replaces": "profiles/profile_fused_dct_gates.py:26",
         "launches": launches["gates"]["basis_dot"],
         "max_abs_err": err["basis_dot"], "shape": timed[0]["shape"],
         "ms": timed[0]["ms"], "plain_ms": timed[0]["plain_ms"],
         "bound_ms": timed[0]["bound_ms"], "bound_by": timed[0]["bound_by"],
         "flops_bound_ms": timed[0]["flops_bound_ms"],
         "library_ms": timed[0]["library_ms"], "library": timed[0]["library"],
         "cublas_ulps": ulps, "registers": timed[0]["registers"],
         "shared_bytes": timed[0]["shared_bytes"],
         "ctas_per_sm": timed[0]["ctas_per_sm"]},
        {"name": "minor_transpose", "route": "cuda", "source": GATE_SOURCE,
         "replaces": "profiles/profile_fused_dct_gates.py:50",
         "launches": launches["gates"]["minor_transpose"],
         "max_abs_err": err["minor_transpose"], "shape": timed[1]["shape"],
         "ms": timed[1]["ms"], "plain_ms": timed[1]["plain_ms"],
         "bound_ms": timed[1]["bound_ms"], "bound_by": "bytes",
         "library_ms": timed[1]["library_ms"], "library": timed[1]["library"],
         "route": timed[1]["route"], "routes": run_routes,
         "variants": [{k: r[k] for k in ("shape", "route", "ms", "plain_ms",
                                         "bound_ms", "share", "registers",
                                         "shared_bytes", "ctas_per_sm")}
                      for r in timed[1:3]]},
        {"name": "lane_split", "route": "cuda", "source": COPY_SOURCE,
         "replaces": "profiles/profile_fused_dct_gates.py:70",
         "launches": launches["gates"]["stream_copy"],
         "max_abs_err": err["lane_split"], "shape": timed[3]["shape"],
         "ms": timed[3]["ms"], "plain_ms": timed[3]["plain_ms"],
         "bound_ms": timed[3]["bound_ms"], "bound_by": "bytes",
         "library_ms": timed[3]["library_ms"], "library": timed[3]["library"]},
    ]


def refused_by_both(phase: int, label: str, wrapper, entry, error_string):
    """Check that ``wrapper()`` raises ``ValueError`` and ``entry()`` (a C
    entry point) returns an error code."""
    try:
        wrapper()
        refused = False
    except ValueError:
        refused = True
    rc = entry()
    print(f"phase {phase}: {label}: wrapper {'refused' if refused else 'TOOK IT'}"
          f", entry point {error_string(rc).decode() if rc else 'TOOK IT'}")
    check(refused and rc != 0, f"phase {phase}: {label} was not refused")


def colour_phase(dev):
    """Phase 27: the colour probe and the MCU relayout
    (``profiles/pallas_color.py``, ``mcu_relayout.py``) against their plain
    versions on the card, refusals, attributes, then both runners at their
    defaults; returns the two kernel records."""
    import gc

    import torch

    from lz4jpeg_tpu_torch.ops.color import split_mcus
    from lz4jpeg_tpu_torch.ops.stream import stream_copy
    from lz4jpeg_tpu_torch.profiles import mcu_relayout as mr
    from lz4jpeg_tpu_torch.profiles import pallas_color as pc
    from lz4jpeg_tpu_torch.profiles.colorsplit3 import run_colorsplit3

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    err = {"color_probe": 0, "mcu_relayout": 0}

    def held(name, label, got, want):
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        d = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
                for a, b in zip(got, want))
        err[name] = max(err[name], d)
        print(f"phase 27: {label}: {'identical' if same else 'DIFFERS'}")
        check(same, f"phase 27: {label} differs (max |d| {d})")

    # -- the colour probe: the probe's case, the whole cube, ragged, views --
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    cases = [("probe case", pc.probe_case(SEED).to(dev)),
             *((f"cube shifted {s}", pc.colour_cube(s, dev)) for s in (0, 1)),
             *((str(shape), torch.randint(0, 256, shape, dtype=torch.uint8,
                                          device=dev, generator=gen))
               for shape in COLOR_SHAPES)]
    cases.append(("offset view", offset_view(cases[3][1])))
    for label, x in cases:
        got = pc.color_probe(x)
        held("color_probe", f"colour {label}", tuple(got),
             tuple(pc.color_probe_ref(x)))
        if label.startswith(("probe", "cube")):
            print(f"phase 27: colour {label}: against rgb_to_ycbcr "
                  f"{pc.mismatches(got, x)}")
    del cases, got

    # -- the relayout: the timed planes (also against split_mcus), ragged ---
    for shape, tw in RELAYOUT_SHAPES:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=gen)
        for tag, v in (("", x), (" offset view", offset_view(x))):
            got = mr.mcu_relayout(v, tw)
            held("mcu_relayout", f"relayout {shape} tw {tw}{tag}", got,
                 mr.mcu_relayout_ref(v, tw))
        if shape[-2:] == (2048, 2048):
            held("mcu_relayout", f"relayout {shape} against split_mcus", got,
                 split_mcus(x, x[..., :1024], x[..., :1024])[0]
                 .reshape(got.shape))
        elif shape[-2:] == (2048, 1024):
            held("mcu_relayout", f"relayout {shape} against split_mcus", got,
                 split_mcus(x.repeat(1, 1, 2), x, x)[1].reshape(got.shape))
        del x, got

    # -- refusals, by the wrappers and by the C entry points ---------------
    stream = torch.cuda.current_stream(dev).cuda_stream
    c_lib, r_lib = pc.load_kernel(), mr.load_kernel()
    rgb = torch.zeros((4, 6, 3), dtype=torch.uint8, device=dev)
    plane = torch.zeros((8, 40), dtype=torch.uint8, device=dev)
    sink = torch.empty(1 << 12, dtype=torch.int32, device=dev)
    for label, wrapper, entry, error_string in (
            ("colour width 3", lambda: pc.color_probe(rgb[:, :3].contiguous()),
             lambda: c_lib.rgb_color_launch(rgb.data_ptr(), sink.data_ptr(),
                                            sink.data_ptr(), sink.data_ptr(),
                                            4, 3, stream),
             c_lib.rgb_color_error_string),
            ("relayout tw 5", lambda: mr.mcu_relayout(plane, 5),
             lambda: r_lib.mcu_relayout_launch(plane.data_ptr(),
                                               sink.data_ptr(), 1, 40, 5,
                                               stream),
             r_lib.mcu_relayout_error_string),
            ("relayout Wp 36 at tw 8", lambda: mr.mcu_relayout(plane[:, :36], 8),
             lambda: r_lib.mcu_relayout_launch(plane.data_ptr(),
                                               sink.data_ptr(), 1, 36, 8,
                                               stream),
             r_lib.mcu_relayout_error_string)):
        refused_by_both(27, label, wrapper, entry, error_string)
    torch.cuda.synchronize()
    del rgb, plane, sink
    attrs = {"colour": pc.attributes(dev)}
    attrs.update({f"relayout tw {tw}": mr.attributes(tw, dev)
                  for tw in mr.WIDTHS})
    for name, a in attrs.items():
        print(f"phase 27: {name}: regs {a['registers']}, smem "
              f"{a['shared_bytes']} B, CTAs/SM {a['ctas_per_sm']}")
    print(f"phase 27: checks in {time.perf_counter() - t_phase:.2f} s")

    # -- both runners at their defaults, each count zeroed before ----------
    runners = {"colour": (pc.run_pallas_color, COLOR_PROBE_RUN,
                          (pc.color_probe,)),
               "colorsplit3": (run_colorsplit3, COLORSPLIT_RUN,
                               (mr.mcu_relayout, stream_copy))}
    results, launches = probe_runner_runs(27, runners, dev, t_phase)
    colour, split = results["colour"], results["colorsplit3"]
    row = colour["timed"]
    luma = split["relayout"][0]
    return [
        {"name": "rgb_color_probe", "route": "cuda", "source": RGB_SOURCE,
         "replaces": "profiles/profile_pallas_color.py:21",
         "launches": launches["colour"]["color_probe"],
         "max_abs_err": float(err["color_probe"]),
         "shape": row["shape"], "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": bound(row["bytes"])[0], "bound_by": bound(row["bytes"])[1],
         "library_ms": None, "chain_ms": row["chain_ms"],
         "k1_colour_share_ms": row["k1_colour_share_ms"],
         "cube_mismatches": colour["cube_mismatches"],
         "registers": row["registers"], "shared_bytes": row["shared_bytes"],
         "ctas_per_sm": row["ctas_per_sm"]},
        {"name": "mcu_relayout", "route": "cuda", "source": RELAYOUT_SOURCE,
         "replaces": "profiles/profile_colorsplit3.py:118",
         "launches": launches["colorsplit3"]["mcu_relayout"],
         "max_abs_err": float(err["mcu_relayout"]), "shape": luma["shape"],
         "ms": luma["ms"], "plain_ms": luma["plain_ms"],
         "bound_ms": bound(luma["bytes"])[0],
         "bound_by": bound(luma["bytes"])[1],
         "library_ms": luma["library_ms"], "library": luma["library"],
         "copy_ms": luma["copy_ms"], "probe_rows": split["rows"],
         "coefficient_checks": split["checks"],
         "variants": [{k: r[k] for k in ("row", "shape", "ms", "plain_ms",
                                         "library_ms", "library", "copy_ms",
                                         "bytes_bound_ms", "share",
                                         "registers", "shared_bytes",
                                         "ctas_per_sm")}
                      for r in split["relayout"]]},
    ]


def probe_runner_runs(phase: int, runners, dev, t_phase):
    """Each runner ``key: (run, params, wrappers)`` at ``params`` with every
    wrapper's count set to 0 just before and read just after (each must
    have launched); the artifacts in a temporary directory, each naming the
    card.  Returns the results and the counts."""
    import gc
    import tempfile

    import torch

    results, launches, wall = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, (run, params, wrappers) in runners.items():
            gc.collect()
            torch.cuda.empty_cache()
            for fn in wrappers:
                fn.launches = 0
            t0 = time.perf_counter()
            results[key] = run(dev, **params, output=str(Path(tmp) / key))
            wall[key] = time.perf_counter() - t0
            launches[key] = {fn.__name__: fn.launches for fn in wrappers}
            art = json.loads((Path(tmp) / key).read_text())
            check(art.get("device") == str(dev) and art.get("card"),
                  f"{key}'s artifact does not name the card")
    for key, counts in launches.items():
        for name, count in counts.items():
            check(count > 0, f"phase {phase}: the {key} runner never "
                             f"launched {name}")
    for result in results.values():
        if "verdict" in result:
            print(f"phase {phase}: {result['verdict']}")
    print(f"phase {phase}: launches per run {launches}; wall s "
          + ", ".join(f"{k} {v:.2f}" for k, v in wall.items())
          + f"; phase {time.perf_counter() - t_phase:.2f} s")
    return results, launches


def gather_phase(dev):
    """Phase 28: the one-hot gather template (``profiles/onehot_gather.py``)
    against its plain version on synthetic roots, refusals, attributes,
    then the runner of the four probes' ten rows at its defaults; returns
    one kernel record per probe site."""
    import gc

    import torch

    from lz4jpeg_tpu_torch.ops.lz4t_decode import resolve_rooted
    from lz4jpeg_tpu_torch.profiles import onehot_gather as og
    from lz4jpeg_tpu_torch.profiles.lz4t_mxu_gather import run_lz4t_mxu_gather

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()

    # -- every instantiation on synthetic roots, some outside [0, P) -------
    err = {k.name: 0 for k in og.KERNELS}
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    for blocks, p in GATHER_SYNTHETIC:
        root = torch.randint(-300, p + 300, (blocks, p), dtype=torch.int32,
                             device=dev, generator=gen)
        lit = torch.randint(0, 256, (blocks, p), dtype=torch.uint8,
                            device=dev, generator=gen)
        for k in og.KERNELS:
            if p % k.step:
                continue
            for tag, r in (("", root), (" offset roots", offset_view(root))):
                got = og.onehot_gather(r, lit, k.name)
                want = og.onehot_gather_ref(r, lit, k.name)
                torch.cuda.synchronize()
                same = torch.equal(got, want)
                d = int((got.long() - want.long()).abs().max())
                err[k.name] = max(err[k.name], d)
                print(f"phase 28: {k.name} ({blocks}, {p}){tag}: "
                      f"{'identical' if same else 'DIFFERS'}")
                check(same, f"phase 28: {k.name} ({blocks}, {p}) differs "
                            f"(max |d| {d})")
        del root, lit, got, want

    # -- refusals, by the wrapper and by the C entry point -----------------
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = og.load_kernel()
    root = torch.zeros((1, 3072), dtype=torch.int32, device=dev)
    lit = torch.zeros((1, 3072), dtype=torch.uint8, device=dev)
    for label, wrapper, args in (
            ("P 3,072", lambda: og.onehot_gather(root, lit, og.KERNELS[1].name),
             (1, root.data_ptr(), lit.data_ptr(), root.data_ptr(), 1, 3072)),
            ("P 2,048 at step 4,096", lambda: og.onehot_gather(
                root[:, :2048].contiguous(), lit[:, :2048].contiguous(),
                og.KERNELS[6].name),
             (6, root.data_ptr(), lit.data_ptr(), root.data_ptr(), 1, 2048)),
            ("an unknown kernel", lambda: og.onehot_gather(root, lit, "g5"),
             (len(og.KERNELS), root.data_ptr(), lit.data_ptr(),
              root.data_ptr(), 1, 2048))):
        refused_by_both(28, label, wrapper,
                        lambda a=args: lib.onehot_gather_launch(*a, stream),
                        lib.onehot_gather_error_string)
    torch.cuda.synchronize()
    del root, lit
    for k in og.KERNELS:
        a = og.attributes(k.name, dev)
        print(f"phase 28: {k.name}: regs {a['registers']}, smem "
              f"{a['shared_bytes']} B, CTAs/SM {a['ctas_per_sm']}")
    print(f"phase 28: checks in {time.perf_counter() - t_phase:.2f} s")

    # -- the runner at its defaults, the counts zeroed before --------------
    results, launches = probe_runner_runs(
        28, {"gathers": (run_lz4t_mxu_gather, MXU_GATHER_RUN,
                         (og.onehot_gather, resolve_rooted))}, dev, t_phase)
    res = results["gathers"]
    comp = res["comparisons"]
    by_row = {r["row"]: r for r in res["rows"]}
    records = []
    for site, head in (("probe_lz4t_mxu_gather.py:66", "g1"),
                       ("probe_lz4t_mxu_gather2.py:47", "g2 full"),
                       ("probe_lz4t_mxu_gather3.py:51", "g3 T=512"),
                       ("probe_lz4t_mxu_gather4.py:53", "g4 R=32 bf16")):
        rows = [r for r in res["rows"] if r["site"] == site]
        r = by_row[head]
        spec = og.BY_NAME[r["kernel"]]
        ops = {"int8_ops" if spec.elem == torch.int8 else "flops":
               r["operations"]}
        b_ms, b_by = bound(r["bytes"], **ops)
        records.append({
            "name": f"onehot_gather_{head.split()[0]}", "route": "cuda",
            "source": ONEHOT_SOURCE, "replaces": f"profiles/{site}",
            "launches": sum(x["launches"] + x["check_launches"] for x in rows),
            "max_abs_err": float(max(err[x["kernel"]] for x in rows)),
            "row": head, "kernel": r["kernel"],
            "ms": r["ms"], "kernel_ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": comp["gather_ms"],
            "library": "torch.gather on int64 roots", "k3_ms": comp["k3_ms"],
            "doubling_ms": comp["doubling_ms"],
            "variants": [{k: x.get(k) for k in (
                "row", "kernel", "ms", "kernel_ms", "plain_ms", "launches",
                "bound_ms", "bound_by", "issue_bound_ms", "share",
                "kernel_share", "registers", "shared_bytes", "ctas_per_sm")}
                for x in rows]})
    for x in res["rows"]:
        alone = x["kernel_ms"]
        print(f"phase 28: {x['row']}: row {x['ms']:.4f} ms (its torch code "
              f"included), kernel alone "
              + ("not measured" if alone is None else f"{alone:.4f} ms"))
    print(f"phase 28: K3 {comp['k3_ms']:.4f} ms, torch.gather "
          f"{comp['gather_ms']:.4f}, pointer doubling {comp['doubling_ms']:.4f}"
          f"; launches {launches}")
    return records


def inverse_phase(dev, main_launches: int):
    """Phase 29: the inverse megakernel K9 (``ops/inv_megakernel.py``)
    against its plain version on ``INV_CASES`` (K1's buffers of noise
    frames) and on crafted words, each launch's plan held to the mirror,
    its tie-pass count printed, every differing pixel explained by plane
    flips (``decode_flips``, at most ``INV_MAX_FLIPS`` of the pixels) and
    every decode within the envelope; K9 and plain timed at 2048² b64 and
    K9 at b256; returns K9's record, ``launches`` the main path's (phase
    3's ``decode_batch``)."""
    import gc

    import torch

    from lz4jpeg_tpu_torch.models.jpeg import scaled_tables
    from lz4jpeg_tpu_torch.ops import inv_megakernel as inv
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import forward_combined
    from lz4jpeg_tpu_torch.profiles.sass_loops import source_loops, spill_stores
    from lz4jpeg_tpu_torch.utils.parity import decode_flips

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)

    def encoded(b, h, w, tables):
        x = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device=dev,
                          generator=gen)
        return forward_combined(x, tables["lum"], tables["r"]).reshape(
            b, -1, 128)

    err, n_pix, n_flips, n_ties, n_values = 0, 0, 0, 0, 0
    for label, (b, h, w), quality in INV_CASES:
        tables = scaled_tables(quality)
        bpc, bpr = -(-h // 8), -(-w // 8)
        comb = encoded(b, h, w, tables)
        if "unaligned" in label:
            comb = offset_view(comb)
        ties = torch.zeros(1, dtype=torch.int64, device=dev)
        got = inv.inverse_combined(comb, tables, bpc, bpr, h, w, ties=ties)
        want = inv.inverse_combined_ref(comb, tables, bpc, bpr, h, w)
        torch.cuda.synchronize()
        plan = inv.launch_plan(b, bpc, bpr, h, w, comb.data_ptr(),
                               got.data_ptr())
        mirror = inv.inverse_plan(b, bpc, bpr, h, w, comb.data_ptr() % 16,
                                  got.data_ptr() % 16, plan.resident)
        check(plan == mirror, f"phase 29: {label}: the C plan {plan} is not "
                              f"the mirror's {mirror}")
        flips = decode_flips(comb, got, want, tables, bpc, bpr)
        diff = (got.int() - want.int()).abs()
        d = int(diff.max()) if diff.numel() else 0
        share = flips / (b * h * w)
        values = b * bpc * bpr * 192
        err = max(err, d)
        n_pix += b * h * w
        n_flips += flips
        n_ties += int(ties[0])
        n_values += values
        print(f"phase 29: {label}: K9 vs plain "
              f"{'identical' if flips == 0 else f'{flips} pixels at plane flips'}"
              f" (max |d| {d}, share {share:.3g}); tie pass {int(ties[0])} of "
              f"{values} plane values ({int(ties[0]) / values:.3%}); "
              f"{plan.units} units in {plan.chunks} chunks on {plan.ctas} "
              f"CTAs, input {'bulk copies' if plan.vec_in else 'words'}, "
              f"stores {'16-byte' if plan.vec_out else 'byte'}")
        check(d <= 3 and share <= 2e-3,
              f"phase 29: {label}: max |d| {d}, share {share:.3g}")
        check(flips <= INV_MAX_FLIPS * b * h * w,
              f"phase 29: {label}: {flips} flips in {b * h * w} pixels")
        del comb, got, want, diff
    tables = scaled_tables(None)
    for word in INV_WORDS:
        comb = torch.full((2, 5 * 7, 128), word, dtype=torch.int16, device=dev)
        same = torch.equal(inv.inverse_combined(comb, tables, 5, 7, 37, 53),
                           inv.inverse_combined_ref(comb, tables, 5, 7, 37, 53))
        print(f"phase 29: word {word} at every lane: "
              f"{'identical' if same else 'DIFFERS'}")
        check(same, f"phase 29: word {word} differs from the plain version")
    attrs = inv.kernel_attributes(dev)
    spills = spill_stores("inv_megakernel")
    (inner,) = source_loops("inv_megakernel").values()
    (every,) = source_loops("inv_megakernel", innermost=False).values()
    print("phase 29: K9's innermost SASS loops: " + "; ".join(
        f"{lp['length']} instructions (HMMA {lp['HMMA']}, FFMA "
        f"{lp['mix'].get('FFMA', 0)}, LDSM {lp['LDSM']}, LDS {lp['LDS']}, "
        f"STS {lp['STS']})" for lp in inner))
    mma = [lp for lp in every if lp["HMMA"]]
    check(bool(mma), "phase 29: no SASS loop of K9 holds an HMMA")
    unit = min(mma, key=lambda lp: lp["length"])
    print(f"phase 29: K9's innermost SASS loop holding HMMA (the chunk "
          f"loop): {unit['length']} instructions (HMMA {unit['HMMA']}, LDSM "
          f"{unit['LDSM']}, FFMA {unit['mix'].get('FFMA', 0)}, LDS "
          f"{unit['LDS']}, STS {unit['STS']})")
    print(f"phase 29: K9 {attrs['registers']} registers, "
          f"{attrs['shared_bytes']} B shared memory, {attrs['ctas_per_sm']} "
          f"CTAs an SM, spill stores {spills}; {n_flips} flips in {n_pix} "
          f"pixels; tie pass {n_ties} of {n_values} plane values")
    check(set(spills.values()) == {0}, f"phase 29: K9 spills {spills}")

    # -- times: K9 against plain at b64, K9 alone at b256 ----------------------
    comb = encoded(INV_TIME_FRAMES[0], SIDE, SIDE, tables)
    nb = SIDE // 8

    def kernel(x):
        return inv.inverse_combined(x, tables, nb, nb, SIDE, SIDE)

    def plain(x):
        return inv.inverse_combined_ref(x, tables, nb, nb, SIDE, SIDE)

    def bounds(x):
        """(bound, by) of this input's work, the larger of its bytes (its
        words read once, the RGB written once) and the bf16 tensor work of
        the part products its warps' fragments issue
        (``inv.part_products``); and each alone, with the FMA bounds of
        the parent's design (fp32 outside the tensor cores: the non-zero
        deltas' FMA, and every FMA)."""
        nz = (x != 0).sum(dim=(0, 1))
        ffma = 64 * int(nz[:64].sum()) + 32 * int(nz[64:].sum())
        n_tiles = x.shape[0] * x.shape[1]
        n_bytes = x.numel() * 2 + x.shape[0] * SIDE * SIDE * 3
        by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        by_tensor = inv.part_products(x, nb, nb) / BF16_FLOP_PER_S * 1e3
        top = (by_bytes, "bytes") if by_bytes >= by_tensor else (
            by_tensor, "operations")
        return {"top": top, "bytes": by_bytes, "tensor": by_tensor,
                "ffma_nonzero": ffma / FFMA_PER_S * 1e3,
                "ffma": n_tiles * (64 * 64 + 2 * 32 * 32) / FFMA_PER_S * 1e3}

    times = {}
    t = time_versions(f"phase 29: inverse {SIDE}x{SIDE} b{INV_TIME_FRAMES[0]}",
                      {"plain": plain, "kernel": kernel}, comb, identical=False)
    times[INV_TIME_FRAMES[0]] = t
    b64 = bounds(comb)
    big = comb.repeat(INV_TIME_FRAMES[1] // INV_TIME_FRAMES[0], 1, 1)
    del comb
    gc.collect()
    torch.cuda.empty_cache()
    times[INV_TIME_FRAMES[1]] = time_versions(
        f"phase 29: inverse {SIDE}x{SIDE} b{INV_TIME_FRAMES[1]}",
        {"kernel": kernel}, big, identical=False)
    b256 = bounds(big)
    del big
    for frames, bd in zip(INV_TIME_FRAMES, (b64, b256)):
        ms = times[frames]["kernel"]
        mpix = frames * SIDE * SIDE / 1e6
        plain_ms = times[frames].get("plain")
        print(f"phase 29: K9 {SIDE}x{SIDE} b{frames}: {ms:.4f} ms "
              f"({mpix / ms * 1e3:.1f} MPix/s)"
              + (f", plain {plain_ms:.4f} ms ({plain_ms / ms:.2f}x)"
                 if plain_ms else "")
              + f"; bytes bound {bd['bytes']:.4f} ms ({bd['bytes'] / ms:.1%}),"
              f" tensor work of the part products issued {bd['tensor']:.4f} "
              f"ms ({bd['tensor'] / ms:.1%}); the parent's FFMA bounds: the "
              f"non-zero deltas {bd['ffma_nonzero']:.4f} ms, every FFMA "
              f"{bd['ffma']:.4f} ms; bound {bd['top'][0]:.4f} ms "
              f"({bd['top'][1]})")
    print(f"phase 29: {time.perf_counter() - t_phase:.2f} s")
    return {
        "name": "inv_megakernel",
        "route": "cuda",
        "source": INV_SOURCE,
        "replaces": INV_REPLACES,
        "launches": main_launches,
        "max_abs_err": float(err),
        "ms": times[INV_TIME_FRAMES[0]]["kernel"],
        "plain_ms": times[INV_TIME_FRAMES[0]]["plain"],
        "bound_ms": b64["top"][0],
        "bound_by": b64["top"][1],
        "library_ms": None,
        "bytes_bound_ms": b64["bytes"],
        "tensor_bound_ms": b64["tensor"],
        "ffma_bound_ms": b64["ffma"],
        "ms_b256": times[INV_TIME_FRAMES[1]]["kernel"],
        "flips": n_flips,
        "tie_share": n_ties / n_values,
        "registers": attrs["registers"],
        "ctas_per_sm": attrs["ctas_per_sm"],
    }


def parse_phase(dev, k10_launches: int, k11_launches: int):
    """Phase 30: LZ4's greedy parses, K10 and K11 (``csrc/lz4_parse_kernel.
    cu``), against their plain versions, bit for bit, and timed; returns
    their three records (K10's launches from phase 6's encode, K11's from
    phase 17's largest frame, the field entry's from this phase's
    sort-matcher encode)."""
    import torch

    from lz4jpeg_tpu_torch import LZ4Codec, LZ4Config
    from lz4jpeg_tpu_torch.ops import lz4_fast, lz4_parse
    from lz4jpeg_tpu_torch.ops.fused_match import match_candidates
    from lz4jpeg_tpu_torch.ops.lz4_fast import fast_match_blocks, pad_blocks_fast
    from lz4jpeg_tpu_torch.ops.match import pad_blocks
    from lz4jpeg_tpu_torch.profiles import timing
    from lz4jpeg_tpu_torch.utils.inputs import (
        crafted_match_blocks,
        crafted_parity_bytes,
        generate_text,
        segment_end_candidates,
    )

    t_phase = time.perf_counter()

    def err(got, want):
        """The largest |kernel − plain| over the fields; checks dtypes."""
        check(all(g.dtype == w.dtype and g.shape == w.shape
                  for g, w in zip(got, want)), "dtypes or shapes differ")
        return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                   for g, w in zip(got, want))

    def held(label, got, want, errs):
        torch.cuda.synchronize()
        e = err(got, want)
        errs.append(e)
        print(f"phase 30: {label}: {'identical' if e == 0 else 'DIFFERENT'} "
              f"(max |d| {e})")
        check(e == 0, f"phase 30: {label} differs from its plain version")

    rng = np.random.default_rng(SEED + 30)
    text = generate_text(MATCH_BLOCKS * 16384 - 7000, rng)
    padded, lengths = pad_blocks_fast(text)
    x = torch.from_numpy(padded.astype(np.uint8)).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    b, p = x.shape

    # ---- K10, candidate entry ------------------------------------------
    k10_errs = []
    for stride in (1, 2, 4):
        for words in (2, 4):
            packed = match_candidates(x, lens, stride, words)
            cases = ((512, 65535),) + (PARSE_SEGMENTS if words == 4 else ())
            for seg, max_dist in cases:
                held(f"K10 {b}x16KiB stride {stride} lcp {words} seg {seg} "
                     f"max_dist {max_dist}",
                     lz4_parse.parse_candidates(packed, lens, p, max_dist,
                                                stride, seg),
                     lz4_parse.parse_candidates_ref(packed, lens, p, max_dist,
                                                    stride, seg), k10_errs)
        crafted, c_lens = crafted_match_blocks(p, np.random.default_rng(SEED + 31))
        cx, cl = torch.from_numpy(crafted).to(dev), torch.from_numpy(c_lens).to(dev)
        packed = match_candidates(cx, cl, stride, 4)
        held(f"K10 crafted blocks stride {stride}",
             lz4_parse.parse_candidates(packed, cl, p, 65535, stride),
             lz4_parse.parse_candidates_ref(packed, cl, p, 65535, stride),
             k10_errs)
        ends, e_lens = segment_end_candidates(p, stride,
                                              np.random.default_rng(SEED + 32))
        ends, e_lens = torch.from_numpy(ends).to(dev), torch.from_numpy(e_lens).to(dev)
        for max_dist in (65535, 3000, 4 * stride):
            got = lz4_parse.parse_candidates(ends, e_lens, p, max_dist, stride)
            held(f"K10 segment-end candidates stride {stride} max_dist "
                 f"{max_dist}", got,
                 lz4_parse.parse_candidates_ref(ends, e_lens, p, max_dist,
                                                stride), k10_errs)
        starts = torch.nonzero(got[0][0]).flatten()
        on_end = int(((starts + got[1][0][starts]) % 512 == 0).sum())
        check(on_end == p // 512, f"phase 30: {on_end} matches end on a "
              f"segment end at stride {stride}, not {p // 512}")
    del cx, cl, ends, e_lens

    # ---- K10, field entry (the sort matcher's parse) ---------------------
    fields_errs = []
    captured = []
    real = lz4_fast.greedy_parse
    try:
        lz4_fast.greedy_parse = lambda *a, **k: captured.append(a) or real(*a, **k)
        kernel_fields = fast_match_blocks(x, lens, lcp_words=4)
        lz4_fast.greedy_parse = lz4_parse.greedy_parse_ref
        plain_fields = fast_match_blocks(x, lens, lcp_words=4)
    finally:
        lz4_fast.greedy_parse = real
    held(f"K10 field entry in the sort matcher, {b}x16KiB lcp 4", kernel_fields,
         plain_fields, fields_errs)
    sort_len, sort_dist, sort_seg = captured[0]
    del kernel_fields, plain_fields, captured
    frng = np.random.default_rng(SEED + 33)
    for dtype in (torch.int32, torch.int64):
        for seg, stride in FIELD_CASES:
            cols = p - p % seg
            ml = frng.integers(-5, 600, (64, cols))
            ml[0, 5], ml[1, 7] = torch.iinfo(dtype).max, torch.iinfo(dtype).max - 1
            ml = torch.from_numpy(ml).to(dtype).to(dev)
            md = torch.from_numpy(frng.integers(0, 1 << 20, (64, cols))).to(dtype).to(dev)
            held(f"K10 field entry {str(dtype)[6:]} seg {seg} stride {stride}",
                 lz4_parse.greedy_parse(ml, md, seg, stride),
                 lz4_parse.greedy_parse_ref(ml, md, seg, stride), fields_errs)
    data = text[:SORT_ENCODE_BYTES]
    sort_cfg = LZ4Config(mode="fast", matcher="sort")
    lz4_parse.greedy_parse.launches = 0
    frame = LZ4Codec(sort_cfg, dev).encode(data, engine="device")
    torch.cuda.synchronize()
    fields_launches = lz4_parse.greedy_parse.launches
    check(fields_launches == 1, f"phase 30: the sort matcher's encode launched "
          f"K10's field entry {fields_launches} times, not once")
    check(frame == LZ4Codec(sort_cfg, "cpu").encode(data, engine="device"),
          "phase 30: the sort matcher's frame differs from the CPU codec's")
    print(f"phase 30: LZ4T sort-matcher encode of {len(data)} B: K10 field "
          f"entry launched {fields_launches} time; frame byte-identical to "
          "the CPU codec's")

    # ---- K11 ---------------------------------------------------------------
    k11_errs = []
    parity_inputs = {}
    for n, block_length in PARITY_CASES:
        pb, _ = pad_blocks(text[:n], block_length)
        parity_inputs[n, block_length] = torch.from_numpy(pb).to(dev)
    crng = np.random.default_rng(SEED + 34)
    crafted = {
        "all-equal 3x2000": np.full((3, 2000), 97, np.int32),
        "random 255x300": crng.integers(0, 256, (255, 300)).astype(np.int32),
        "truncation and ties P 1024": pad_blocks(crafted_parity_bytes(1024),
                                                 1024)[0],
        "truncation and ties P 300": pad_blocks(crafted_parity_bytes(300),
                                                300)[0],
    }
    cases = [(f"text {n} B ({t.shape[0]} x {bl})", t)
             for (n, bl), t in parity_inputs.items()]
    cases += [(k, torch.from_numpy(v).to(dev)) for k, v in crafted.items()]
    for label, xb in cases:
        for max_match in PARITY_MAX_MATCH:
            held(f"K11 {label} max_match {max_match} (with the tables)",
                 lz4_parse.parity_tables(xb, max_match),
                 lz4_parse.parity_tables_ref(xb, max_match), k11_errs)

    # ---- times ---------------------------------------------------------------
    packed = match_candidates(x, lens, 1, 4)
    t = time_versions(
        f"phase 30: K10 {b}x16KiB stride 1 lcp 4",
        {"plain": lambda a: lz4_parse.parse_candidates_ref(a[0], a[1], p),
         "kernel": lambda a: lz4_parse.parse_candidates(a[0], a[1], p)},
        (packed, lens))
    k10_ms, k10_plain = t["kernel"], t["plain"]
    k10_bound = bound(packed.numel() * 4 + b * 4 + 3 * b * p * 4)
    t = time_versions(
        f"phase 30: K10 field entry {b}x16KiB (the sort matcher's, int64)",
        {"plain": lambda a: lz4_parse.greedy_parse_ref(*a, sort_seg),
         "kernel": lambda a: lz4_parse.greedy_parse(*a, sort_seg)},
        (sort_len, sort_dist))
    fields_ms, fields_plain = t["kernel"], t["plain"]
    fields_bound = bound(sort_len.numel() * (8 + 8 + 3 * 4))
    del packed, sort_len, sort_dist, x, lens
    torch.cuda.empty_cache()
    k11 = {}
    for (n, block_length), xb in parity_inputs.items():
        if block_length > 1024:
            continue
        fns = {"plain": lz4_parse.parity_parse_ref,
               "kernel": lz4_parse.parity_parse}
        ms = {}
        for name in [*fns, *reversed(list(fns))]:  # plain, kernel, kernel, plain
            kernel = lz4_parse.parity_parse if name == "kernel" else None
            ms.setdefault(name, []).append(timing.time_ms(
                fns[name], xb, dev, kernel=kernel))
        mean = {k: sum(v) / 2 for k, v in ms.items()}
        k11_bound = bound(xb.numel() * (4 + 1 + 4 + 4))
        print(f"phase 30: K11 {n} B ({xb.shape[0]} x {block_length}): kernel "
              f"{ms['kernel'][0]:.4f}, {ms['kernel'][1]:.4f} ms, plain "
              f"{ms['plain'][0]:.4f}, {ms['plain'][1]:.4f} ms (queued, best of "
              f"4 runs of 8); bound {k11_bound[0]:.6f} ms ({k11_bound[1]})")
        k11[n, block_length] = (mean["kernel"], mean["plain"], k11_bound)
    k11_ms, k11_plain, k11_bound = k11[76_500, 300]
    print(f"phase 30: K10 {k10_ms:.4f} ms against plain {k10_plain:.4f} "
          f"({k10_plain / k10_ms:.1f}x); bound {k10_bound[0]:.4f} ms "
          f"({k10_bound[1]}), {k10_bound[0] / k10_ms:.1%} of it; field entry "
          f"{fields_ms:.4f} against {fields_plain:.4f}, bound "
          f"{fields_bound[0]:.4f}, {fields_bound[0] / fields_ms:.1%}; K11 "
          f"{k11_ms:.4f} against {k11_plain:.4f} at 255 x 300; launches on "
          f"their paths K10 {k10_launches}, field entry {fields_launches}, "
          f"K11 {k11_launches}; {time.perf_counter() - t_phase:.1f} s")

    def record(name, replaces, launches, errs, ms, plain, bnd):
        return {"name": name, "route": "cuda", "source": PARSE_SOURCE,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(errs), "ms": ms, "plain_ms": plain,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    return [record("lz4_parse_candidates", PARSE_REPLACES, k10_launches,
                   k10_errs, k10_ms, k10_plain, k10_bound),
            record("lz4_parse_fields", FIELDS_REPLACES, fields_launches,
                   fields_errs, fields_ms, fields_plain, fields_bound),
            record("parity_parse", PARITY_REPLACES, k11_launches, k11_errs,
                   k11_ms, k11_plain, k11_bound)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if sys.argv[1:2] == ["--rank"]:  # one rank of phase 19's two
        return rank_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
    from lz4jpeg_tpu_torch.formats.jpeg_container import (
        pack_container,
        unpack_container,
    )
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import (
        forward_combined,
        forward_combined_ref,
    )
    from lz4jpeg_tpu_torch.ops.inv_megakernel import inverse_combined
    from lz4jpeg_tpu_torch.ops.quantize import (
        CHROMINANCE_QUANTIZATION_TABLE as CHR,
        LUMINANCE_QUANTIZATION_TABLE as LUM,
        scale_table,
    )
    from lz4jpeg_tpu_torch.utils.inputs import generate_noise_image
    from lz4jpeg_tpu_torch.utils.parity import sum_order_flips

    # ---- phase 1: card, versions, builds --------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    secs = build_all()
    print(f"phase 1: builds in parallel, {time.perf_counter() - t0:.2f} s in "
          f"all: " + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)

    # ---- phase 2: kernel against plain, on the card ---------------------
    q50, q75 = (LUM, CHR), (scale_table(LUM, 75), scale_table(CHR, 75))
    cases = [
        ("2048x2048 b8 runs", noise(8, 2048, 2048, rng, runs=True), q50),
        ("2047x1531", noise(1, 2047, 1531, rng), q50),
        ("37x53", noise(1, 37, 53, rng), q50),
        ("8x8", noise(1, 8, 8, rng), q50),
    ]
    band_rng = np.random.default_rng(SEED + 2)
    cases += [
        ("2x512x1040 banded, last band 2 tiles", noise(2, 512, 1040, band_rng), q50),
        ("1x61x1040 banded, rows past H", noise(1, 61, 1040, band_rng), q50),
        ("2x1023x512 banded, rows past H", noise(2, 1023, 512, band_rng), q50),
        ("4x48x528 quality 75", noise(4, 48, 528, band_rng), q75),
        ("256x256 unaligned view", noise(1, 256, 256, band_rng), q50),
    ]
    n_coeffs = n_flips = 0
    for name, rgb, (lum, chroma) in cases:
        x = torch.from_numpy(rgb).to(dev)
        if "unaligned" in name:  # one byte in: the direct-read route
            buf = torch.empty(x.numel() + 1, dtype=torch.uint8, device=dev)
            x = buf[1:].copy_(x.reshape(-1)).view(x.shape)
            check(x.data_ptr() % 16 != 0, "the view is 16-byte aligned")
        got = forward_combined(x, lum, chroma)
        want = forward_combined_ref(x, lum, chroma)
        torch.cuda.synchronize()
        g, w = got.cpu().numpy(), want.cpu().numpy()
        flips = sum_order_flips(rgb, g, w, lum, chroma)
        n_coeffs += g.size
        n_flips += flips
        verdict = "identical" if np.array_equal(g, w) else f"{flips} sum-order flips"
        print(f"phase 2: {name}: kernel vs plain {verdict} "
              f"({g.shape[0]} blocks, {g.size} coefficients)")
        del x, got, want
    share = n_flips / n_coeffs
    check(share <= MAX_FLIP_SHARE,
          f"flip share {share:.3g} exceeds {MAX_FLIP_SHARE}")
    max_abs_err = 1.0 if n_flips else 0.0
    print(f"phase 2: ok, {n_flips} admissible flips in {n_coeffs} coefficients "
          f"(max |coefficient error| {max_abs_err})")

    # ---- phase 3: the main path ------------------------------------------
    frames = np.stack([generate_noise_image(2048, 2048, rng) for _ in range(4)])
    forward_combined.launches = 0
    pipe = JPEGPipeline(JPEGConfig(), device="cuda")
    encs = pipe.encode_batch(frames)
    containers = [pack_container(e) for e in encs]
    unpacked = [unpack_container(c) for c in containers]
    inverse_combined.launches = 0
    decoded = pipe.decode_batch(unpacked)
    torch.cuda.synchronize()
    inv_launches = inverse_combined.launches
    del unpacked
    launches = forward_combined.launches
    check(launches > 0, "the main path never launched the forward kernel")
    check(inv_launches == 1,
          f"decode_batch launched K9 {inv_launches} times, not once")
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.backends.cudnn.allow_tf32 is False, "TF32 is on")
    for out in decoded:
        check(out.shape == (2048, 2048, 3) and out.dtype == np.uint8,
              f"decoded frame has shape {out.shape}, dtype {out.dtype}")

    cpu = JPEGPipeline(JPEGConfig(), device="cpu")
    cpu_encs = cpu.encode_batch(frames)
    path_flips = 0
    for i, (enc, cpu_enc) in enumerate(zip(encs, cpu_encs)):
        if containers[i] != pack_container(cpu_enc):
            path_flips += sum_order_flips(
                frames[i : i + 1], enc.rle_combined, cpu_enc.rle_combined,
                LUM, CHR,
            )
    check(path_flips <= MAX_FLIP_SHARE * 4 * 65536 * 128,
          f"{path_flips} flips between the card's and the CPU's containers")
    same = "byte-identical" if path_flips == 0 else (
        f"equal up to {path_flips} admissible flips")
    print(f"phase 3: launches K1 {launches}, K9 {inv_launches}; containers "
          f"{same} to the CPU path "
          f"({sum(map(len, containers))} bytes for 4 frames)")
    cpu_decoded = cpu.decode_batch([unpack_container(c) for c in containers])
    worst, differing = 0, 0.0
    for a, b in zip(decoded, cpu_decoded):
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        worst = max(worst, int(diff.max()))
        differing = max(differing, float((diff != 0).mean()))
    check(worst <= 3 and differing <= 2e-3,
          f"decode vs CPU decode: max |d| {worst}, share {differing:.3g}")
    mse = float(np.mean((np.stack(decoded).astype(np.float64) - frames) ** 2))
    psnr = 10 * np.log10(255.0 ** 2 / mse)
    print(f"phase 3: decode vs CPU decode max |d| {worst}, differing share "
          f"{differing:.3g}; PSNR vs input {psnr:.3f} dB (uniform noise)")
    del encs, cpu_decoded, cpu_encs

    # ---- phase 4: times on the card ---------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    big = torch.randint(0, 256, (64, 2048, 2048, 3), dtype=torch.uint8,
                        device=dev, generator=gen)
    mpix = 64 * 2048 * 2048 / 1e6

    def kernel(x):
        return forward_combined(x, LUM, CHR)

    def plain(x):
        return forward_combined_ref(x, LUM, CHR)

    # Sum-order flips (phase 2) may part the checksums: not checked.
    versions = {"plain": plain, "kernel": kernel}
    t = time_versions("phase 4: forward 2048x2048 b64", versions, big,
                      identical=False)
    kernel_ms, plain_ms = t["kernel"], t["plain"]
    n_tiles = 64 * 256 * 256
    k1_bound = bound(big.numel() + n_tiles * 128 * 2, n_tiles * K1_FLOP_PER_TILE)
    print(f"phase 4: forward 2048x2048 b64: kernel {kernel_ms:.4f} ms "
          f"({mpix / kernel_ms * 1e3:.1f} MPix/s), plain {plain_ms:.4f} ms "
          f"({mpix / plain_ms * 1e3:.1f} MPix/s); bound {k1_bound[0]:.4f} ms "
          f"({k1_bound[1]}), "
          f"{k1_bound[0] / kernel_ms:.1%} of it")
    # K1's build and its issue floor: the warp instructions a tile of its
    # band loop in its SASS (the toolkit) over every scheduler's issue.
    from lz4jpeg_tpu_torch.profiles import megakernel as mk
    from lz4jpeg_tpu_torch.profiles.timing import issue_bound_ms

    attrs = mk.k1_attributes(dev)
    count = mk.band_sass_counts(keys=("k1",))["k1"]
    issue = issue_bound_ms(32 * count["per_tile"] * n_tiles, dev)
    print(f"phase 4: K1 {attrs['registers']} registers, "
          f"{attrs['shared_bytes']} B shared memory, {attrs['ctas_per_sm']} "
          f"CTAs an SM; {count['per_tile']:.2f} warp instructions a tile "
          f"(band loop {count['segments']} a warp between barriers, "
          f"producer {count['producer']} a band): issue floor {issue:.4f} ms "
          f"at b64, {issue / kernel_ms:.1%} of the kernel's time, beside "
          f"the bytes bound {k1_bound[0]:.4f} ms")
    del big
    big = torch.randint(0, 256, (256, 2048, 2048, 3), dtype=torch.uint8,
                        device=dev, generator=gen)
    del versions["plain"]  # kernel only: the plain version's temporaries
    t = time_versions("phase 4: forward 2048x2048 b256", versions, big,
                      identical=False)
    b256_bound = bound(big.numel() + 4 * n_tiles * 128 * 2,
                       4 * n_tiles * K1_FLOP_PER_TILE)
    print(f"phase 4: forward 2048x2048 b256: kernel {t['kernel']:.4f} ms "
          f"({4 * mpix / t['kernel'] * 1e3:.1f} MPix/s); bound "
          f"{b256_bound[0]:.4f} ms ({b256_bound[1]}), "
          f"{b256_bound[0] / t['kernel']:.1%} of it; issue floor "
          f"{4 * issue:.4f} ms, {4 * issue / t['kernel']:.1%} of it")
    del big

    frame = frames[0]
    trips = []
    for _ in range(6):
        t = time.perf_counter()
        out = pipe.decode(unpack_container(pack_container(pipe.encode(frame))))
        trips.append((time.perf_counter() - t) * 1e3)
        check(out.shape == frame.shape, "round trip changed the shape")
    trips = sorted(trips[1:])
    print(f"phase 4: round trip encode->container->decode 2048x2048: median "
          f"{trips[len(trips) // 2]:.3f} ms, min {trips[0]:.3f} ms "
          f"(runs {[round(t, 3) for t in trips]})")

    lz4, lz4_data, lz4_frame, k10_launches = lz4_phases(dev)
    pairs, packed, p_decoded = pair_phases(dev, frames, containers, decoded)
    wide = wide_phase(dev, packed, p_decoded)
    p10_words = {c: (np.concatenate([e.rle[c] for e in packed]).view(np.int16),
                     np.concatenate([e.rle_lengths[c] for e in packed])
                     .astype(np.int32)) for c in ("lum", "r")}
    del packed, p_decoded
    exact_phase(dev, frames[0])
    per_block_phase(dev, frames[0])
    entry_phase(dev, frames[0])
    k11_launches = parity_phase(dev)
    cli_phase(dev)
    parallel_phase(dev, card, lz4_data, lz4_frame)
    del lz4_data, lz4_frame
    copy, ceiling = bench_phase(dev)
    candidates = candidates_phase(dev)
    probes = probes_phase(dev)
    layouts = layouts_phase(dev)
    k2_ms = next(r["ms"] for r in lz4 if r["name"] == "match_kernel")
    matchers = matcher_phase(dev, p10_words, k2_ms)
    expands = expand_phase(dev, p10_words)
    gates = gates_phase(dev)
    colours = colour_phase(dev)
    gathers = gather_phase(dev)
    inverse = inverse_phase(dev, inv_launches)
    parses = parse_phase(dev, k10_launches, k11_launches)

    records = [{
        "name": "fwd_megakernel",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
    }, *lz4, *pairs, wide, copy, *candidates, *probes, *layouts, *matchers,
       *expands, *gates, *colours, *gathers, inverse, *parses]
    for r in records:
        if r["bound_by"] == "bytes":  # the same bytes over the measured rate
            measured = r["bound_ms"] * HBM_BYTES_PER_S / (ceiling * 1e9)
            print(f"share of bound: {r['name']}: {r['bound_ms'] / r['ms']:.1%} "
                  f"of the data sheet's, {measured / r['ms']:.1%} of the "
                  f"measured ceiling's ({ceiling:.1f} GB/s)")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
