"""Full experiment sweeps mirroring the reference harness (SURVEY.md §3.5).

Port of ``lz4jpeg_tpu/bench/experiments.py``: the same sweeps, names,
arguments, defaults, prints and JSON schema, on an explicit torch
``device`` (default ``"cuda"``; without a card a sweep raises).

* LZ4: text sizes {350, 500, 1k, 2k, 5k, 10k, 15k, 20k, 25k, 30k}
  (``Experiment/LZ4_sequential_experiment.c:60``), random passages of the
  corpus, 10 runs each, trimmed mean + median → JSON shaped like
  ``Experiment/results/LZ4_seq.exe_execution_times.json``.
* JPEG: square noise images 2^0 … 2^11 per side
  (``Experiment/JPEG_sequential_experiment.c:7-8``), full encode→decode
  round trip per run.

Unlike the reference, which timed whole child processes, these time the
library calls directly; the JSON keeps the reference's field names
(``text`` / ``image_size``, ``execution_times``, ``mean``, ``median``)
plus derived throughput, and every entry names its device
(``harness.device_record``).

The LZ4 sweeps read the reference's corpus (``utils/inputs.py::
load_corpus``) unless the caller passes ``corpus``: the repository
carries no corpus, so tests and ``chip_smoke.py`` pass generated text.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import (
    BenchResult,
    bench_device,
    device_record,
    run_timed,
)
from lz4jpeg_tpu_torch.utils.inputs import (
    extract_random_passage,
    generate_noise_image,
    load_corpus,
)
from lz4jpeg_tpu_torch.utils.profiling import checksum, device_checksum

LZ4_SIZES = [350, 500, 1000, 2000, 5000, 10000, 15000, 20000, 25000, 30000]
JPEG_SIZES = [2 ** i for i in range(12)]


def _corpus(corpus: Optional[bytes]) -> bytes:
    return load_corpus() if corpus is None else corpus


def run_lz4_experiment(
    sizes: Optional[List[int]] = None,
    runs: int = 10,
    mode: str = "parity",
    output: Optional[str] = None,
    seed: int = 0,
    corpus: Optional[bytes] = None,
    device="cuda",
) -> List[BenchResult]:
    from lz4jpeg_tpu_torch.config import LZ4Config
    from lz4jpeg_tpu_torch.models.lz4 import LZ4Codec

    dev = bench_device(device)
    corpus = _corpus(corpus)
    rng = np.random.default_rng(seed)
    codec = LZ4Codec(LZ4Config(mode=mode), device=dev)
    results = []
    for size in sizes or LZ4_SIZES:
        text = extract_random_passage(corpus, size, rng)

        def step():
            assert codec.decode(codec.encode(text)) == text

        r = run_timed(
            f"lz4_{mode}", step, scale=size, runs=runs,
            work=size / 1e6, work_unit="MB",
        )
        results.append(r)
        print(
            f"lz4 {mode} {size:>6} B: mean {r.mean_s*1e3:.2f} ms "
            f"({r.throughput:.2f} MB/s)"
        )
    if output:
        _write_reference_schema(output, results, "text", dev)
    return results


def run_jpeg_experiment(
    sizes: Optional[List[int]] = None,
    runs: int = 10,
    precision: str = "fast",
    output: Optional[str] = None,
    seed: int = 0,
    device="cuda",
) -> List[BenchResult]:
    from lz4jpeg_tpu_torch.config import JPEGConfig
    from lz4jpeg_tpu_torch.models.jpeg import JPEGPipeline

    dev = bench_device(device)
    rng = np.random.default_rng(seed)
    pipeline = JPEGPipeline(JPEGConfig(precision=precision, entropy="shared"), dev)
    results = []
    for size in sizes or JPEG_SIZES:
        img = generate_noise_image(size, size, rng)

        def step():
            pipeline.decode(pipeline.encode(img))

        r = run_timed(
            f"jpeg_{precision}", step, scale=size, runs=runs,
            work=size * size / 1e6, work_unit="MPix",
        )
        results.append(r)
        print(
            f"jpeg {precision} {size:>5}²: mean {r.mean_s*1e3:.2f} ms "
            f"({r.throughput:.3f} MPix/s)"
        )
    if output:
        _write_reference_schema(output, results, "image_size", dev)
    return results


def _write_reference_schema(
    path: str, results: List[BenchResult], scale_key: str, device
) -> None:
    """The reference's results-file shape
    (``Experiment/results/*.json``), one entry per scale, each with the
    device it ran on."""
    where = device_record(device)
    payload = [
        {
            "name": r.name,
            scale_key: r.scale,
            "runs": len(r.times_s),
            "mean_method": "trimmed (drop min+max)",
            "execution_times": r.times_s,
            "mean": r.mean_s,
            "median": r.median_s,
            "throughput": r.throughput,
            "throughput_unit": r.throughput_unit,
            **where,
        }
        for r in results
    ]
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def run_lz4_file_experiment(
    size_mb: int = 256,
    runs: int = 10,
    output: Optional[str] = None,
    corpus: Optional[bytes] = None,
    device="cuda",
) -> dict:
    """File-level streaming encode+decode throughput at ≥256 MB
    (``encode_file``/``decode_file``, chunk-granular native calls).

    Host-bound by design (the native C++ codec streams the file in chunks;
    ``device`` only hosts the codec object), so the number documents what
    the streaming layer itself sustains on this host."""
    import os
    import tempfile
    import time as _time

    from lz4jpeg_tpu_torch.config import LZ4Config
    from lz4jpeg_tpu_torch.models.lz4 import LZ4Codec

    dev = bench_device(device)
    corpus = _corpus(corpus)
    data = (corpus * (-(-(size_mb << 20) // len(corpus))))[: size_mb << 20]
    codec = LZ4Codec(LZ4Config(mode="fast"), device=dev)
    d = tempfile.mkdtemp(prefix="lz4file_")
    src = os.path.join(d, "in.bin")
    with open(src, "wb") as f:
        f.write(data)
    comp = os.path.join(d, "out.lz4t")
    dec = os.path.join(d, "dec.bin")
    enc_times, dec_times = [], []
    for _ in range(runs):
        t0 = _time.perf_counter()
        comp_size = codec.encode_file(src, comp)
        enc_times.append(_time.perf_counter() - t0)
        t0 = _time.perf_counter()
        raw = codec.decode_file(comp, dec)
        dec_times.append(_time.perf_counter() - t0)
        assert raw == len(data)
    with open(dec, "rb") as f:
        assert f.read(1 << 20) == data[: 1 << 20]
    mb = len(data) / 1e6
    result = {
        "size_mb": size_mb,
        "compressed_bytes": comp_size,
        "ratio": comp_size / len(data),
        "encode_times_s": enc_times,
        "decode_times_s": dec_times,
        "encode_mb_s": mb / min(enc_times),
        "decode_mb_s": mb / min(dec_times),
        "engine": "native (chunk-granular lz4t_encode_chunk/decode_chunk)",
        **device_record(dev),
    }
    print(
        f"lz4 file streaming {size_mb} MB: encode {result['encode_mb_s']:.1f} "
        f"MB/s, decode {result['decode_mb_s']:.1f} MB/s, ratio "
        f"{result['ratio']:.3f}"
    )
    for p in (src, comp, dec):
        os.unlink(p)
    os.rmdir(d)
    if output:
        with open(output, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {output}")
    return result


def run_jpeg_perblock_experiment(
    sizes: Optional[List[int]] = None,
    runs: int = 10,
    output: Optional[str] = None,
    seed: int = 0,
    device="cuda",
) -> List[BenchResult]:
    """Parity-mode (exact float64 + per-block Huffman) roundtrip at
    experiment scale — the reference's actual configuration, which rebuilds
    a Huffman tree for every MCU and channel (JPEG.c:844-1097, driven at
    :1242-1253).  torch float64 is float64 on every device: no switch.

    The entropy stage runs the native C++ oracle twin
    (``lz4core.cpp::huff_per_block_ascii``)."""
    import time as _time

    from lz4jpeg_tpu_torch.config import JPEGConfig
    from lz4jpeg_tpu_torch.models.jpeg import JPEGPipeline

    dev = bench_device(device)
    rng = np.random.default_rng(seed)
    pipeline = JPEGPipeline(
        JPEGConfig(precision="exact", entropy="per_block"), dev
    )
    results = []
    for size in sizes or [64, 128, 256, 512, 1024, 2048]:
        img = generate_noise_image(size, size, rng)
        entropy_s = {"t": 0.0}

        def step():
            enc = pipeline.encode(img, entropy=False)
            t0 = _time.perf_counter()
            pipeline.entropy_encode(enc)
            entropy_s["t"] = _time.perf_counter() - t0
            rec = pipeline.decode(enc)
            assert rec.shape == img.shape

        r = run_timed(
            "jpeg_perblock", step, scale=size, runs=runs, warmup=1,
            work=size * size / 1e6, work_unit="MPix",
        )
        results.append(r)
        print(
            f"jpeg per_block {size:>5}²: mean {r.mean_s*1e3:9.2f} ms "
            f"({r.throughput:.3f} MPix/s; entropy stage "
            f"{entropy_s['t']*1e3:.1f} ms)"
        )
    if output:
        _write_reference_schema(output, results, "image_size", dev)
    return results


def run_lz4t_decode_device_experiment(
    sizes_mb: Optional[List[int]] = None,
    runs: int = 10,
    output: Optional[str] = None,
    corpus: Optional[bytes] = None,
    device="cuda",
) -> List[BenchResult]:
    """Device-parallel LZ4T decode throughput.

    Two resolves of the copy program, each fenced by a checksum over its
    full output and checked against the input once: the pointer-doubling
    ``resolve_blocks`` (torch gathers) over the program built with the
    default depth cap, and the rooted resolve ``resolve_rooted`` (K3 on a
    CUDA device, one gather) over the fully rooted program
    (``depth_cap=1``), which is what the codec's device decode runs on a
    card.  Also the host parse of each program and the native decoder."""
    import time as _time

    from lz4jpeg_tpu_torch.native import native_backend
    from lz4jpeg_tpu_torch.ops.lz4t_decode import (
        _trim_rows,
        build_copy_program_fast,
        depth_to_steps,
        resolve_blocks,
        resolve_rooted,
        root_program,
    )

    dev = bench_device(device)
    corpus = _corpus(corpus)
    native = native_backend()
    results = []
    artifact = {**device_record(dev), "entries": []}
    for mb in sizes_mb or [1, 4, 16]:
        data = (corpus * (-(-mb * 1 << 20) // len(corpus) + 1))[: mb << 20]
        frame = native.encode_fast(data)  # the spec's frame, byte for byte
        t0 = _time.perf_counter()
        lit, src, raw_sizes, p, max_depth = build_copy_program_fast(frame)
        parse_s = _time.perf_counter() - t0
        steps = depth_to_steps(max_depth)
        lit_d = torch.from_numpy(lit).to(dev)
        src_d = torch.from_numpy(src).to(dev)
        doubled = resolve_blocks(lit_d, src_d, steps)
        if _trim_rows(doubled.cpu().numpy(), raw_sizes) != data:
            raise RuntimeError(f"pointer-doubling resolve of {mb} MB is wrong")
        del doubled

        r = run_timed(
            "lz4t_decode_device",
            lambda: checksum(resolve_blocks(lit_d, src_d, steps)),
            scale=mb, runs=runs, warmup=1,
            work=len(data) / 1e6, work_unit="MB",
        )
        results.append(r)

        t0 = _time.perf_counter()
        lit1, src1, _, _, _ = build_copy_program_fast(frame, depth_cap=1)
        rooted_parse_s = _time.perf_counter() - t0
        lit1_d = torch.from_numpy(lit1).to(dev)
        root1 = root_program(torch.from_numpy(src1).to(dev)).contiguous()
        if _trim_rows(resolve_rooted(lit1_d, root1).cpu().numpy(),
                      raw_sizes) != data:
            raise RuntimeError(f"rooted resolve of {mb} MB is wrong")
        r_rooted = run_timed(
            "lz4t_decode_device_rooted",
            lambda: checksum(resolve_rooted(lit1_d, root1)),
            scale=mb, runs=runs, warmup=1,
            work=len(data) / 1e6, work_unit="MB",
        )

        t0 = _time.perf_counter()
        native.decode_fast(frame, len(data))
        host_mb_s = len(data) / 1e6 / (_time.perf_counter() - t0)
        artifact["entries"].append(
            {
                "mb": mb,
                "blocks": int(lit.shape[0]),
                "max_depth": int(max_depth),
                "doubling_steps": steps,
                "host_parse_s": parse_s,
                "device_resolve_mean_s": r.mean_s,
                "device_resolve_mb_s": r.throughput,
                "rooted_parse_s": rooted_parse_s,
                "rooted_resolve_mean_s": r_rooted.mean_s,
                "rooted_resolve_mb_s": r_rooted.throughput,
                "end_to_end_mb_s": len(data) / 1e6
                / (r_rooted.mean_s + rooted_parse_s),
                "host_native_decode_mb_s": host_mb_s,
            }
        )
        print(
            f"lz4t device decode {mb:3d} MB: resolve {r.mean_s*1e3:8.1f} ms "
            f"({r.throughput:6.1f} MB/s), parse {parse_s*1e3:6.1f} ms, "
            f"depth {max_depth} -> {steps} steps; rooted resolve "
            f"{r_rooted.mean_s*1e3:8.2f} ms ({r_rooted.throughput:6.1f} MB/s), "
            f"parse {rooted_parse_s*1e3:6.1f} ms, host C++ {host_mb_s:.0f} MB/s"
        )
    if output:
        with open(output, "w") as f_:
            json.dump(artifact, f_, indent=1)
        print(f"wrote {output}")
    return results


def run_jpeg_inverse_device_experiment(
    sizes: Optional[List[int]] = None,
    runs: int = 10,
    seed: int = 0,
    output: Optional[str] = None,
    device="cuda",
) -> List[BenchResult]:
    """Batched device-side JPEG decode throughput: device-resident sparse16
    combined buffers → the folded inverse einsum → YCbCr→RGB
    (``JPEGPipeline._inverse_sparse``, as ``decode_batch`` runs it).

    The decode-side twin of the forward headline: per size up to 1 GiPix
    and at most 256 frames per dispatch, 4 chained dispatches per run with
    each dispatch's checksum (over its full RGB output) folded into the
    next; the carry stays on the device, so the host reads once per run.
    On CUDA it prints the peak device memory of each size."""
    from lz4jpeg_tpu_torch.config import JPEGConfig
    from lz4jpeg_tpu_torch.models.jpeg import JPEGPipeline

    dev = bench_device(device)
    rng = np.random.default_rng(seed)
    pipeline = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"), dev)
    if not pipeline.sparse16:
        raise RuntimeError("device inverse sweep measures the sparse16 chain")
    chain = 4
    results = []
    for size in sizes or [512, 1024, 2048]:
        batch = min(256, max(1, (1024 << 20) // (size * size)))
        if dev.type == "cuda":  # each size starts from an empty cache
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        img = generate_noise_image(size, size, rng)
        slim = pipeline._forward_rle(pipeline._image(img))
        bpc = bpr = -(-size // 8)
        comb = slim.reshape(1, *slim.shape).expand(batch, -1, -1).contiguous()
        del slim

        def inverse_fenced(comb, carry):
            # The FULL RGB output: channel 0 alone would skip the Cb chain
            # in a compiler that removes unused work.
            rgb = pipeline._inverse_sparse(comb, bpc, bpr, size, size)
            return carry + device_checksum(rgb)

        def step():
            s = torch.zeros((), dtype=torch.float32, device=dev)
            for _ in range(chain):
                s = inverse_fenced(comb, s)
            float(s)

        r = run_timed(
            f"jpeg_inverse_device_{size}", step, scale=size, runs=runs,
            warmup=2, work=chain * batch * size * size / 1e6,
            work_unit="MPix",
        )
        results.append(r)
        peak = (f"; peak device memory "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
                if dev.type == "cuda" else "")
        print(
            f"jpeg device inverse {size:>5}² b{batch}: mean "
            f"{r.mean_s*1e3:8.1f} ms ({r.throughput:7.1f} MPix/s fenced){peak}"
        )
        del comb
    if output:
        _write_reference_schema(output, results, "image_size", dev)
    return results


def run_lz4_device_experiment(
    batches: Optional[List[int]] = None,
    runs: int = 10,
    seed: int = 0,
    output: Optional[str] = None,
    lcp_words_list: Optional[List[int]] = None,
    corpus: Optional[bytes] = None,
    device="cuda",
) -> List[BenchResult]:
    """Device-resident LZ4 match+parse throughput (data already in device
    memory, parse fields staying there), fenced by a checksum of every
    parse field read back once per run.

    Series: the sort matcher ``fast_match_blocks`` (torch ops) at each of
    ``lcp_words_list`` (default 4 and 2), and, on a CUDA device, the fused
    matcher ``fast_match_blocks_fused`` (K2) at strides 1, 2, 4 (2 lcp
    words) and at stride 1 with 4 lcp words."""
    from lz4jpeg_tpu_torch.ops.fused_match import fast_match_blocks_fused
    from lz4jpeg_tpu_torch.ops.lz4_fast import fast_match_blocks

    dev = bench_device(device)
    corpus = _corpus(corpus)
    results = []
    chain = 4  # serialized iterations per run; the xor carry from each
    # iteration's checksum perturbs the next one's input

    def make_fn(matcher):
        def chained(b, l, c0):
            c = c0
            s = torch.zeros((), dtype=torch.float32, device=b.device)
            for _ in range(chain):
                outs = matcher(b ^ c, l)
                s = s + sum(device_checksum(o) for o in outs)
                # Bounded carry: mod the float before the integer cast.
                c = torch.remainder(s, 2).to(torch.uint8)
            return s

        return chained

    configs = [
        (f"lz4_device_match_lcp{lcp}",
         (lambda b, l, lcp=lcp: fast_match_blocks(b, l, lcp_words=lcp)))
        for lcp in (lcp_words_list or [4, 2])
    ]
    if dev.type == "cuda":
        configs += [
            (f"lz4_device_match_fused_s{s}",
             (lambda b, l, s=s: fast_match_blocks_fused(b, l, stride=s)))
            for s in (1, 2, 4)
        ] + [
            ("lz4_device_match_fused_s1_lcp4",
             lambda b, l: fast_match_blocks_fused(b, l, stride=1, lcp_words=4)),
        ]
    for name, matcher_fn in configs:
        fn = make_fn(matcher_fn)
        for nblocks in batches or [64, 256, 1024, 4096, 8192]:
            p = 16384
            reps = -(-nblocks * p // len(corpus))
            data = (corpus * reps)[: nblocks * p]
            blocks = torch.from_numpy(
                np.frombuffer(data, np.uint8).reshape(nblocks, p).copy()
            ).to(dev)
            lengths = torch.full((nblocks,), p, dtype=torch.int32, device=dev)
            zero = torch.zeros((), dtype=torch.uint8, device=dev)

            def step():
                float(fn(blocks, lengths, zero))

            mb = chain * nblocks * p / 1e6
            r = run_timed(
                name, step, scale=nblocks,
                runs=runs, work=mb, work_unit="MB",
            )
            results.append(r)
            print(
                f"{name} {mb:7.1f} MB/batch: mean "
                f"{r.mean_s*1e3:8.2f} ms ({r.throughput:7.1f} MB/s fenced)"
            )
    if output:
        _write_reference_schema(output, results, "batch_blocks", dev)
    return results
