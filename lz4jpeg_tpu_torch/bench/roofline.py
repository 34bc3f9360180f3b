"""Per-stage roofline of the JPEG forward and inverse paths.

Port of ``lz4jpeg_tpu/bench/roofline.py``, on an explicit torch ``device``.
It answers "which stage limits the forward (or the decode), and how far is
it from the speed of light" with an artifact, against the NVIDIA H100 SXM
data sheet's peaks and against the stream ceiling measured on the device
by ``measure_hbm_stream_ceiling``.

Methodology
-----------
Each stage runs ``chain`` times in a row with a data-dependent carry (the
checksum of one iteration's full output perturbs the next iteration's
input), the carry stays on the device, and the host reads the final
checksum once; per-iteration time is the best of ``runs`` such chains
divided by ``chain``.  Per stage the *algorithmic* operations and device
memory bytes are stated (inputs read once + outputs written once; the
passes an implementation adds only lower the achieved fraction):

* memory: ``HBM_PEAK_GBS`` = 3,350 GB/s (H100 SXM data sheet);
* tensor cores: ``TENSOR_PEAK_TFLOPS`` = 989 dense bf16 TFLOP/s (data
  sheet); the float32 products run as several bf16 passes (K1) or in full
  float32, so the fraction against the bf16 peak is conservative.

``speed_of_light_s = max(bytes/BW_peak, flops/FLOP_peak)``,
``sol_fraction = speed_of_light_s / measured_s``, and
``sol_fraction_measured`` the same with the measured stream ceiling in
place of the data sheet's bandwidth.  These are the rates
``chip_smoke.py::bound`` uses.  A run on the CPU reports the CPU's times
against the same card peaks: no device metric comes from it.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record, sync
from lz4jpeg_tpu_torch.utils.profiling import device_checksum

HBM_PEAK_GBS = 3350.0  # H100 SXM HBM3, NVIDIA data sheet
TENSOR_PEAK_TFLOPS = 989.0  # H100 SXM dense bf16 tensor cores, data sheet
LANES_FOR_STREAM = 512  # row width of the elementwise stream arrays
COPY_COLUMNS = 2048  # row width of the copy arrays (the TPU probe's)
# Operations per pixel of the forward: colour (10), the luma product (a
# 64-deep dot per coefficient, one coefficient per pixel) and the two
# chroma products (32-deep dots, one coefficient per two pixels each).
FORWARD_FLOPS_PER_PIXEL = 10 + 2 * 64 + 2 * 32


def _chain_bench(
    body: Callable, data, chain: int, carry_dtype: torch.dtype,
    runs: int = 4, kernel=None,
) -> float:
    """Best per-iteration seconds of ``body(x, carry, acc) -> (carry',
    acc')`` chained ``chain`` times, the host reading ``acc`` once per
    chain.  ``kernel``, a kernel wrapper with a ``launches`` count, guards
    the timing: every timed chain must launch it ``chain`` times, or the
    stage did not run the kernel and its number would be hollow."""
    dev = (data if isinstance(data, torch.Tensor)
           else next(iter(data.values()))).device

    def run() -> float:
        c = torch.zeros((), dtype=carry_dtype, device=dev)
        s = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(chain):
            c, s = body(data, c, s)
        return float(s)

    run()  # warm
    best = 1e9
    for _ in range(runs):
        before = kernel.launches if kernel is not None else 0
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
        if kernel is not None and kernel.launches - before != chain:
            raise RuntimeError(
                f"launch guard: {kernel.__name__} launched "
                f"{kernel.launches - before} times in a chain of {chain}; "
                "the stage no longer runs the kernel and its number is hollow"
            )
    return best / chain


def _carry(s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The next carry from a checksum: 0 or 1, from the sum of every
    output element (not from one element)."""
    return torch.remainder(s, 2).to(dtype)


def measure_hbm_stream_ceiling(
    footprint_bytes: int = 512 << 20,
    chain: int = 32,
    runs: int = 4,
    device="cuda",
) -> Dict:
    """Measured achievable device-memory bandwidth at the footprint.

    The data sheet's 3,350 GB/s is not what a kernel sustains; every
    roofline fraction below also divides by this measured ceiling.  Each
    variant is a bare streaming loop whose array is its own carry, so every
    iteration reads its input and writes a new output, and one checksum
    read fences the chain:

    * ``stream_f32``:  c' = 0.5 + 1.000001·c   — read N + write N per iter
    * ``triad_f32``:   c' = c + (1 + i)·x      — read 2N + write N
    * ``stream_u8``:   c' = c + 1 (int8)       — read N + write N
    * ``copy_kernel_{u8,i16,f32}``: c' = ``ops/stream.py::stream_copy(c)``
      (the hand-written copy kernel on CUDA) on (rows, 2048) arrays
    * ``copy_{u8,i16,f32}``: ``Tensor.copy_`` between two such arrays (the
      library call)

    The ceiling is the largest achieved GB/s; one above 1.05 × the data
    sheet's peak means the fence collapsed, and raises."""
    from lz4jpeg_tpu_torch.ops.stream import stream_copy

    dev = bench_device(device)
    gen = torch.Generator(device=dev).manual_seed(7)
    n_f32 = footprint_bytes // 4
    rows = max(1, n_f32 // LANES_FOR_STREAM)
    x32 = torch.randn((rows, LANES_FOR_STREAM), generator=gen, device=dev)
    x8 = torch.randint(-100, 100, (4 * rows, LANES_FOR_STREAM),
                       generator=gen, device=dev, dtype=torch.int8)
    stream_bytes = x32.numel() * 4

    def bench(step, x0, nbytes_per_iter):
        def run() -> float:
            c = x0
            for i in range(chain):
                c = step(i, c)
            return float(device_checksum(c))

        run()  # warm
        best = 1e9
        for _ in range(runs):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        per_iter = best / chain
        return {
            "measured_s": per_iter,
            "bytes": nbytes_per_iter,
            "achieved_gbs": nbytes_per_iter / per_iter / 1e9,
        }

    half = torch.full((), 0.5, device=dev)
    out = {
        **device_record(dev),
        "footprint_bytes": footprint_bytes,
        "chain": chain,
        "variants": {},
    }
    variants = out["variants"]
    variants["stream_f32"] = bench(
        lambda i, c: torch.add(half, c, alpha=1.000001), x32,
        2 * stream_bytes,
    )
    variants["triad_f32"] = bench(
        lambda i, c: torch.add(c, x32, alpha=1.0 + i), x32, 3 * stream_bytes,
    )
    variants["stream_u8"] = bench(
        lambda i, c: torch.add(c, 1), x8, 2 * stream_bytes,
    )
    del x32, x8
    for name, dtype in (("u8", torch.uint8), ("i16", torch.int16),
                        ("f32", torch.float32)):
        itemsize = torch.empty((), dtype=dtype).element_size()
        copy_rows = max(1, footprint_bytes // (COPY_COLUMNS * itemsize))
        x = torch.randint(0, 100, (copy_rows, COPY_COLUMNS), generator=gen,
                          device=dev, dtype=dtype)
        nbytes = 2 * x.numel() * itemsize
        variants[f"copy_kernel_{name}"] = bench(
            lambda i, c: stream_copy(c), x, nbytes
        )
        spare = [torch.empty_like(x)]

        def library_copy(i, c, spare=spare):
            dst = spare.pop()
            dst.copy_(c)
            spare.append(c)
            return dst

        variants[f"copy_{name}"] = bench(library_copy, x, nbytes)
        del x, spare
    ceiling = max(v["achieved_gbs"] for v in variants.values())
    if ceiling > HBM_PEAK_GBS * 1.05:
        raise RuntimeError(
            f"stream probe reports {ceiling:.0f} GB/s > the data sheet's "
            f"{HBM_PEAK_GBS:.0f} — the fence collapsed; fix the probe"
        )
    out["ceiling_gbs"] = ceiling
    out["ceiling_variant"] = max(variants, key=lambda k: variants[k]["achieved_gbs"])
    return out


def _roofline(stages: Dict[str, Dict], measured_gbs: float,
              skip=("readback_d2h",)) -> None:
    """Achieved rates, speed of light and fractions of each stage, in
    place."""
    for name, st in stages.items():
        t = st["measured_s"]
        st["achieved_gbs"] = st["bytes"] / t / 1e9
        st["achieved_tflops"] = st["flops"] / t / 1e12
        if name in skip:
            st["speed_of_light_s"] = None
            st["sol_fraction"] = None
            continue
        by_bytes = st["bytes"] / (HBM_PEAK_GBS * 1e9)
        by_ops = st["flops"] / (TENSOR_PEAK_TFLOPS * 1e12)
        sol = max(by_bytes, by_ops)
        st["speed_of_light_s"] = sol
        st["sol_fraction"] = sol / t
        sol_m = max(st["bytes"] / (measured_gbs * 1e9), by_ops)
        st["sol_fraction_measured"] = sol_m / t
        st["bound"] = "memory" if by_bytes >= by_ops else "compute"


def _peaks(measured_gbs: float) -> Dict:
    return {
        "hbm_gbs": HBM_PEAK_GBS,
        "hbm_gbs_measured": measured_gbs,
        "tensor_bf16_tflops": TENSOR_PEAK_TFLOPS,
    }


def run_jpeg_forward_roofline(
    size: int = 2048,
    batch: int = 32,
    chain: int = 8,
    output: Optional[str] = None,
    device="cuda",
) -> Dict:
    """Stage-by-stage roofline of the sparse16 forward: ``megakernel``, K1
    (``forward_combined``; colour + 4:2:2 + DCT + sparse-delta RLE in one
    pass, reading RGB directly, so there is no transpose stage), the
    pipeline's device forward ``full_forward`` (``_forward_rle``), the
    plain version of the same function ``plain_chain``
    (``forward_combined_ref``: colour, subsample, tile split, basis
    product, sparse epilogue as torch ops), the device→host copy of the
    combined buffer and the fence's own cost.  On a CUDA device both K1
    stages are guarded: each timed chain must launch the kernel ``chain``
    times."""
    from lz4jpeg_tpu_torch.config import JPEGConfig
    from lz4jpeg_tpu_torch.models.jpeg import JPEGPipeline
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import (
        forward_combined,
        forward_combined_ref,
    )
    from lz4jpeg_tpu_torch.utils.inputs import generate_noise_image

    dev = bench_device(device)
    pipeline = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"), dev)
    if not pipeline.sparse16:
        raise RuntimeError("forward roofline measures the sparse16 path")
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(
        np.stack([generate_noise_image(size, size, rng) for _ in range(batch)])
    ).to(dev)
    npix = batch * size * size  # pixels per chain iteration
    lum_t, chr_t = pipeline._tables["lum"], pipeline._tables["r"]
    guard = forward_combined if dev.type == "cuda" else None

    def body_of(fn):
        def body(x, c, s):
            out = fn(x + c)
            # Full fence: the checksum reads every output byte once.
            s = s + device_checksum(out)
            return _carry(s, torch.uint8), s

        return body

    stages: Dict[str, Dict] = {}
    io_bytes = 3 * npix + 4 * npix  # RGB u8 in, combined 16-bit out
    flops = FORWARD_FLOPS_PER_PIXEL * npix

    print("timing megakernel ...", flush=True)
    stages["megakernel"] = {
        "measured_s": _chain_bench(
            body_of(lambda x: forward_combined(x, lum_t, chr_t)), imgs, chain,
            torch.uint8, kernel=guard,
        ),
        "flops": flops,
        "bytes": io_bytes,
    }

    print("timing full_forward ...", flush=True)
    stages["full_forward"] = {
        "measured_s": _chain_bench(
            body_of(pipeline._forward_rle), imgs, chain, torch.uint8,
            kernel=guard,
        ),
        "flops": flops,
        "bytes": io_bytes,
    }

    print("timing plain_chain ...", flush=True)
    stages["plain_chain"] = {
        "measured_s": _chain_bench(
            body_of(lambda x: forward_combined_ref(x, lum_t, chr_t)), imgs,
            chain, torch.uint8,
        ),
        "flops": flops,
        "bytes": io_bytes,
        "note": (
            "colour → 4:2:2 → tile split → basis product → sparse epilogue "
            "as torch ops: the plain version K1 is held against"
        ),
    }

    # -- device→host copy of the combined buffer --------------------------
    slim = pipeline._forward_rle(imgs)
    sync(dev)
    d2h_bytes = slim.numel() * 2
    t0 = time.perf_counter()
    slim.cpu()
    d2h_s = time.perf_counter() - t0
    del slim
    stages["readback_d2h"] = {
        "measured_s": d2h_s,
        "flops": 0,
        "bytes": d2h_bytes,
        "note": "device→host copy into pageable memory; not part of the device chain",
    }

    # -- fence floor: the perturb + checksum traffic every stage body pays
    print("timing fence_floor ...", flush=True)
    floor_s = _chain_bench(body_of(lambda x: x), imgs, chain, torch.uint8)

    print("timing hbm_stream ceiling ...", flush=True)
    hbm_probe = measure_hbm_stream_ceiling(
        footprint_bytes=min(512 << 20, 4 * npix), chain=16, device=dev
    )
    measured_gbs = hbm_probe["ceiling_gbs"]
    _roofline(stages, measured_gbs)

    device_stages = ("megakernel",)
    stage_sum = sum(stages[k]["measured_s"] for k in device_stages)
    limiter = max(device_stages, key=lambda k: stages[k]["measured_s"])
    result = {
        "size": size,
        "batch": batch,
        "chain": chain,
        "backend": dev.type,
        **device_record(dev),
        "formulation": "sparse16_megakernel",
        "peaks": _peaks(measured_gbs),
        "hbm_stream_ceiling": hbm_probe,
        "mpix_per_iter": npix / 1e6,
        "fence_floor": {
            "measured_s": floor_s,
            "note": (
                "per-iteration input perturb + checksum of the input; "
                "embedded in every stage's measured_s — subtract for "
                "kernel-marginal comparisons"
            ),
        },
        "fencing_note": (
            "every stage's checksum reads the stage's FULL output; on CUDA "
            "each timed chain of the K1 stages must launch K1 once per "
            "iteration (forward_combined.launches)"
        ),
        "stages": stages,
        "stage_sum_s": stage_sum,
        "fusion_gap_s": stages["full_forward"]["measured_s"] - stage_sum,
        "limiting_stage": limiter,
        "vs_plain_chain": stages["plain_chain"]["measured_s"]
        / stages["full_forward"]["measured_s"],
        "full_forward_mpix_s": npix / 1e6 / stages["full_forward"]["measured_s"],
    }

    print(f"\nJPEG forward roofline — {size}² × batch {batch} "
          f"({npix/1e6:.0f} MPix/iter) on {_where(result)}")
    print(f"measured stream ceiling: {measured_gbs:.0f} GB/s "
          f"({hbm_probe['ceiling_variant']}; data sheet {HBM_PEAK_GBS:.0f})")
    _print_stages(stages, ("megakernel", "full_forward", "plain_chain",
                           "readback_d2h"))
    print(f"limiting stage: {limiter}; "
          f"fusion gap {result['fusion_gap_s']*1e3:+.2f} ms; "
          f"{result['vs_plain_chain']:.2f}x the plain chain; "
          f"forward {result['full_forward_mpix_s']:.0f} MPix/s")

    if output:
        with open(output, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {output}")
    return result


def _where(result: Dict) -> str:
    return result.get("card", result["device"])


def _print_stages(stages: Dict[str, Dict], names) -> None:
    print(f"{'stage':18s} {'ms':>8s} {'GB/s':>7s} {'TFLOP/s':>8s} "
          f"{'SoL ms':>7s} {'SoL%':>6s} {'mSoL%':>6s}  bound")
    for name in names:
        st = stages[name]
        sol = st["speed_of_light_s"]
        sol_ms = f"{sol*1e3:7.2f}" if sol else "      -"
        sol_pc = f"{st['sol_fraction']*100:5.1f}%" if sol else "     -"
        msol_pc = (f"{st['sol_fraction_measured']*100:5.1f}%"
                   if st.get("sol_fraction_measured") else "     -")
        print(
            f"{name:18s} {st['measured_s']*1e3:8.2f} {st['achieved_gbs']:7.1f} "
            f"{st['achieved_tflops']:8.2f} {sol_ms} {sol_pc} {msol_pc}  "
            f"{st.get('bound', '-')}"
        )


def run_jpeg_inverse_roofline(
    size: int = 2048,
    batch: int = 64,
    chain: int = 8,
    output: Optional[str] = None,
    device="cuda",
) -> Dict:
    """Per-stage roofline of the device decode of the sparse16 buffer:
    per-channel delta extraction + KT relayout (``unbias_kt``) → the folded
    suffix-basis einsum (``folded_einsum``; the RLE prefix sum and the 4:2:2
    upsample ride the same product) → the plane YCbCr merge
    (``color_merge``), and the whole chain (``full_inverse``,
    ``JPEGPipeline._inverse_sparse``).  Every stage is data-oblivious, so
    the carry XOR-perturbs the input words.

    The inverse has no hand-written kernel and needs no guard: PyTorch runs
    each op as it is called and removes no work, and every stage's
    checksum reads its full output."""
    from lz4jpeg_tpu_torch.config import JPEGConfig
    from lz4jpeg_tpu_torch.models.jpeg import (
        _CHANNEL_SHAPES,
        CHANNELS,
        JPEGPipeline,
    )
    from lz4jpeg_tpu_torch.ops.color import ycbcr_planes_to_rgb
    from lz4jpeg_tpu_torch.ops.fused import fused_inverse_plane_sparse
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import CHANNEL_SLICES
    from lz4jpeg_tpu_torch.ops.rle import SPARSE16_DELTA_BIAS
    from lz4jpeg_tpu_torch.utils.inputs import generate_noise_image

    dev = bench_device(device)
    pipeline = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"), dev)
    if not pipeline.sparse16:
        raise RuntimeError("inverse roofline measures the sparse16 path")
    rng = np.random.default_rng(0)
    img = generate_noise_image(size, size, rng)
    slim = pipeline._forward_rle(pipeline._image(img))
    # One batch of real encoded streams, tiled: decode work does not depend
    # on the content.
    comb = slim.reshape(1, *slim.shape).expand(batch, -1, -1).contiguous()
    del slim
    bpc = bpr = size // 8
    npix = batch * size * size

    def unbias_all(cb):
        out = {}
        for name in CHANNELS:
            k = 8 * _CHANNEL_SHAPES[name][1]
            w16 = cb[..., CHANNEL_SLICES[name]].to(torch.int32)
            d = torch.where(w16 != 0, w16 - SPARSE16_DELTA_BIAS, 0)
            out[name] = d.reshape(batch * bpc, bpr, k).transpose(1, 2).contiguous()
        return out

    def checksum(tensors):
        return sum(device_checksum(t) for t in tensors)

    stages: Dict[str, Dict] = {}

    def unbias_body(cb, c, s):
        s = s + checksum(unbias_all(cb ^ c).values())
        return _carry(s, torch.int16), s

    print("timing unbias_kt ...", flush=True)
    stages["unbias_kt"] = {
        "measured_s": _chain_bench(unbias_body, comb, chain, torch.int16),
        "flops": 0,
        "bytes": 4 * npix + 8 * npix,  # 16-bit combined in, i32 kt deltas out
    }

    d0 = unbias_all(comb)

    def planes_all(d):
        return {
            name: fused_inverse_plane_sparse(
                d[name], pipeline._tables[name], _CHANNEL_SHAPES[name][1],
                upsample_cols=(name != "lum"),
            ).reshape(batch, 8 * bpc, 8 * bpr)
            for name in CHANNELS
        }

    def einsum_body(d, c, s):
        out = planes_all({k: v + c.to(torch.int32) for k, v in d.items()})
        s = s + checksum(out.values())
        return _carry(s, torch.int16), s

    print("timing folded_einsum ...", flush=True)
    stages["folded_einsum"] = {
        "measured_s": _chain_bench(einsum_body, d0, chain, torch.int16),
        # luma: npix outputs × 64-deep dots; chroma: 2 channels × npix
        # full-width outputs (upsample folded) × 32-deep dots.
        "flops": 2 * 64 * npix + 2 * 32 * 2 * npix,
        "bytes": 8 * npix + 3 * npix,  # i32 deltas in, u8 planes out
    }

    planes0 = planes_all(d0)
    del d0

    def merge_body(planes, c, s):
        rgb = ycbcr_planes_to_rgb(
            planes["lum"] + c.to(torch.uint8), planes["r"], planes["b"],
            size, size,
        )
        # Full-RGB fence: one channel alone would leave Cb unread.
        s = s + device_checksum(rgb)
        return _carry(s, torch.int16), s

    print("timing color_merge ...", flush=True)
    stages["color_merge"] = {
        "measured_s": _chain_bench(merge_body, planes0, chain, torch.int16),
        "flops": 10 * npix,
        "bytes": 3 * npix + 3 * npix,  # u8 planes in, RGB u8 out
    }
    del planes0

    def full_body(cb, c, s):
        rgb = pipeline._inverse_sparse(cb ^ c, bpc, bpr, size, size)
        s = s + device_checksum(rgb)
        return _carry(s, torch.int16), s

    print("timing full_inverse ...", flush=True)
    stages["full_inverse"] = {
        "measured_s": _chain_bench(full_body, comb, chain, torch.int16),
        "flops": sum(
            stages[k]["flops"]
            for k in ("unbias_kt", "folded_einsum", "color_merge")
        ),
        "bytes": 4 * npix + 3 * npix,  # combined 16-bit in, RGB u8 out
    }

    def floor_body(cb, c, s):
        s = s + device_checksum(cb ^ c)
        return _carry(s, torch.int16), s

    print("timing fence_floor ...", flush=True)
    floor_s = _chain_bench(floor_body, comb, chain, torch.int16)
    del comb

    print("timing hbm_stream ceiling ...", flush=True)
    hbm_probe = measure_hbm_stream_ceiling(
        footprint_bytes=min(512 << 20, 4 * npix), chain=16, device=dev
    )
    measured_gbs = hbm_probe["ceiling_gbs"]
    _roofline(stages, measured_gbs, skip=())

    device_stages = ("unbias_kt", "folded_einsum", "color_merge")
    stage_sum = sum(stages[k]["measured_s"] for k in device_stages)
    limiter = max(device_stages, key=lambda k: stages[k]["measured_s"])
    result = {
        "size": size,
        "batch": batch,
        "chain": chain,
        "backend": dev.type,
        **device_record(dev),
        "formulation": "sparse16_folded",
        "peaks": _peaks(measured_gbs),
        "hbm_stream_ceiling": hbm_probe,
        "mpix_per_iter": npix / 1e6,
        "fence_floor": {
            "measured_s": floor_s,
            "note": (
                "per-iteration xor-perturb + checksum of the combined "
                "buffer; embedded in every stage's measured_s — subtract "
                "for kernel-marginal comparisons"
            ),
        },
        "stages": stages,
        "stage_sum_s": stage_sum,
        "fusion_gap_s": stages["full_inverse"]["measured_s"] - stage_sum,
        "limiting_stage": limiter,
        "full_inverse_mpix_s": npix / 1e6 / stages["full_inverse"]["measured_s"],
    }

    print(f"\nJPEG inverse roofline — {size}² × batch {batch} "
          f"({npix/1e6:.0f} MPix/iter) on {_where(result)}")
    print(f"measured stream ceiling: {measured_gbs:.0f} GB/s "
          f"({hbm_probe['ceiling_variant']}; data sheet {HBM_PEAK_GBS:.0f})")
    _print_stages(stages, (*device_stages, "full_inverse"))
    print(f"limiting stage: {limiter}; "
          f"fusion gap {result['fusion_gap_s']*1e3:+.2f} ms; "
          f"inverse {result['full_inverse_mpix_s']:.0f} MPix/s")

    if output:
        with open(output, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {output}")
    return result
