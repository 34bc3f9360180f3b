#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lz4jpeg_tpu_torch) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one card.  At first use it builds the three Hopper kernels (one
nvcc per source, all started together, sm_90a) and the native runtime
(g++) into ``lz4jpeg_tpu_torch/_build/``, then runs eight phases and fails
(non-zero exit, no result line) if any of them fails:

1. the card's name and power limit, the torch and CUDA versions, and the
   build seconds;
2. the JPEG forward kernel against its plain torch version on the card, at
   2048×2048 (batch 8, duplicated columns for runs) and the ragged shapes
   2047×1531, 37×53 and 8×8.  Identity is expected; the only admissible
   difference is a sum-order flip (``lz4jpeg_tpu_torch/utils/parity.py``),
   at most 1e-5 of the coefficients;
3. the JPEG main path: ``JPEGPipeline(JPEGConfig(), device="cuda")``,
   ``encode_batch`` of four 2048² frames, ``pack_container``,
   ``unpack_container``, ``decode_batch``.  The kernel must have launched;
   the containers must equal the CPU path's byte for byte (or differ only
   by phase 2's flips); the decoded RGB must stay within the fast-path
   envelope of the CPU path's decode (max |Δ| ≤ 3 on ≤ 2e-3 of pixels);
4. JPEG times on the card: the forward at 2048², batch 64, kernel against
   plain (CUDA events, 2 warm-up runs, 10 runs with min and max dropped,
   each run fenced by a checksum over its full output), and the encode →
   container → decode round trip of one 2048² frame;
5. the LZ4 match kernel (K2) against its plain version on the card: 2048
   16 KiB blocks of generated text (the last one ragged) plus one block of
   uniform noise, strides 1, 2, 4 × lcp words 2, 4; the packed int32 words
   must be identical;
6. the LZ4T main path: ``LZ4Codec(LZ4Config(mode="fast"), device="cuda")``
   ``.encode(data, engine="device")`` of 32 MiB of generated text, then
   ``.decode(frame, engine="device")``.  Both kernels must have launched;
   the frame must equal the CPU codec's (plain K2) byte for byte; the
   device decode and the native decoder must return the input;
7. the rooted-resolve kernel (K3) against its plain version on the card:
   the fully rooted copy programs of 128 MiB of generated text encoded
   natively (64 KiB blocks) and of phase 6's frame (16 KiB blocks); the
   bytes must be identical;
8. LZ4T times on the card: K2 at 2048 × 16 KiB (stride 1, lcp 4) and K3 at
   128 MiB, kernel against plain as in phase 4; encode and decode MB/s of
   the main path, each with a staged split.

The line before the last is the kernels' JSON record; the last line is
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
MIB = 1 << 20
MATCH_BLOCKS = 2048  # 16 KiB blocks of text in phase 5 (the last ragged)
MAIN_BYTES = 32 * MIB  # the LZ4T main path's input (2048 × 16 KiB)
TEXT_BYTES = 128 * MIB  # the natively encoded input of phases 7-8


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def noise(b: int, h: int, w: int, rng: np.random.Generator, runs: bool = False):
    rgb = rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)
    if runs:  # duplicated columns make runs of equal coefficients
        rgb[:, :, 0 : 2 * (w // 2) : 2] = rgb[:, :, 1::2]
    return rgb


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
        sums.append(out.sum(dtype=torch.int64))
        events.append((start, end))
        del out
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in events]
    return ms, {int(s) for s in sums}


def trimmed_mean(ms):
    kept = sorted(ms)[1:-1]
    return sum(kept) / len(kept)


def kernel_vs_plain(label: str, kernel, plain, x, identical: bool):
    """Phase-4 method: plain, kernel, kernel, plain blocks of ``timed_runs``;
    returns (kernel ms, plain ms), each the mean of its two trimmed means,
    after checking that every run of a version gave one checksum (and, if
    ``identical``, the same checksum for both versions)."""
    blocks = {}
    for name, fn in (("plain", plain), ("kernel", kernel),
                     ("kernel", kernel), ("plain", plain)):
        ms, sums = timed_runs(fn, x)
        blocks.setdefault(name, []).append((trimmed_mean(ms), sums))
        print(f"{label} {name}: trimmed mean {trimmed_mean(ms):.4f} ms "
              f"(runs {[round(t, 4) for t in ms]})")
    checksums = {}
    for name, runs in blocks.items():
        sums = set().union(*(s for _, s in runs))
        check(len(sums) == 1, f"{label}: {name} output changed: {sums}")
        checksums[name] = sums.pop()
    print(f"{label}: output checksums {checksums}")
    check(not identical or checksums["kernel"] == checksums["plain"],
          f"{label}: kernel and plain checksums differ")
    return (sum(t for t, _ in blocks["kernel"]) / 2,
            sum(t for t, _ in blocks["plain"]) / 2)


def build_all():
    """Start every build at once (one nvcc per kernel source, g++ for the
    native runtime); return the seconds each took."""
    from concurrent.futures import ThreadPoolExecutor

    from lz4jpeg_tpu_torch.native import native_backend
    from lz4jpeg_tpu_torch.ops import fused_match, fwd_megakernel, lz4t_decode

    builds = {
        "nvcc fwd_megakernel": fwd_megakernel.load_kernel,
        "nvcc match_kernel": fused_match.load_kernel,
        "nvcc resolve_kernel": lz4t_decode.load_kernel,
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
    """Phases 5-8 (the LZ4T codec); returns the K2 and K3 kernel records."""
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
    from lz4jpeg_tpu_torch.utils.inputs import generate_text

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
    del x, lens, got, want

    # ---- phase 6: the LZ4T main path --------------------------------------
    data = text[:MAIN_BYTES]
    codec = LZ4Codec(LZ4Config(mode="fast"), device=dev)
    match_candidates.launches = 0
    resolve_rooted.launches = 0
    frame = codec.encode(data, engine="device")
    decoded = codec.decode(frame, engine="device")
    torch.cuda.synchronize()
    k2_launches = match_candidates.launches
    k3_launches = resolve_rooted.launches
    check(k2_launches > 0, "the LZ4T encode never launched the match kernel")
    check(k3_launches > 0, "the LZ4T decode never launched the resolve kernel")
    check(decoded == data, "device decode does not return the input")
    check(codec.decode(frame, engine="native") == data,
          "native decode does not return the input")
    t = time.perf_counter()
    cpu_frame = LZ4Codec(LZ4Config(mode="fast"), device="cpu").encode(
        data, engine="device")
    cpu_s = time.perf_counter() - t
    check(frame == cpu_frame, "the card's LZ4T frame differs from the CPU's")
    print(f"phase 6: launches K2 {k2_launches}, K3 {k3_launches}; frame "
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
    k2_ms, k2_plain_ms = kernel_vs_plain(
        "phase 8: K2 2048x16KiB stride 1 lcp 4",
        lambda t: match_candidates(t[0], t[1], 1, 4),
        lambda t: match_candidates_ref(t[0], t[1], 1, 4),
        main_in, identical=True,
    )
    mb = len(data) / 1e6
    print(f"phase 8: K2 2048x16KiB: kernel {k2_ms:.4f} ms "
          f"({mb / k2_ms * 1e3:.1f} MB/s), plain {k2_plain_ms:.4f} ms "
          f"({mb / k2_plain_ms * 1e3:.1f} MB/s)")
    k3_ms, k3_plain_ms = kernel_vs_plain(
        "phase 8: K3 128 MiB (2048x64KiB)",
        lambda t: resolve_rooted(*t), lambda t: resolve_rooted_ref(*t),
        (big_lit, root_big), identical=True,
    )
    big_mb = big_lit.numel() / 1e6
    print(f"phase 8: K3 128 MiB: kernel {k3_ms:.4f} ms "
          f"({big_mb / k3_ms * 1e3:.1f} MB/s), plain {k3_plain_ms:.4f} ms "
          f"({big_mb / k3_plain_ms * 1e3:.1f} MB/s)")
    del main_in, big_lit, root_big

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
    fields = parse_candidates(packed, lens_d, p)
    split.mark("parse scan")
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
    }, {
        "name": "resolve_kernel",
        "route": "cuda",
        "source": RESOLVE_SOURCE,
        "replaces": RESOLVE_REPLACES,
        "launches": k3_launches,
        "max_abs_err": k3_err,
        "ms": k3_ms,
        "plain_ms": k3_plain_ms,
    }]


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
    from lz4jpeg_tpu_torch.formats.jpeg_container import (
        pack_container,
        unpack_container,
    )
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import (
        forward_combined,
        forward_combined_ref,
    )
    from lz4jpeg_tpu_torch.ops.quantize import (
        CHROMINANCE_QUANTIZATION_TABLE as CHR,
        LUMINANCE_QUANTIZATION_TABLE as LUM,
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
    cases = [
        ("2048x2048 b8 runs", noise(8, 2048, 2048, rng, runs=True)),
        ("2047x1531", noise(1, 2047, 1531, rng)),
        ("37x53", noise(1, 37, 53, rng)),
        ("8x8", noise(1, 8, 8, rng)),
    ]
    n_coeffs = n_flips = 0
    for name, rgb in cases:
        x = torch.from_numpy(rgb).to(dev)
        got = forward_combined(x, LUM, CHR)
        want = forward_combined_ref(x, LUM, CHR)
        torch.cuda.synchronize()
        g, w = got.cpu().numpy(), want.cpu().numpy()
        flips = sum_order_flips(rgb, g, w, LUM, CHR)
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
    decoded = pipe.decode_batch([unpack_container(c) for c in containers])
    torch.cuda.synchronize()
    launches = forward_combined.launches
    check(launches > 0, "the main path never launched the forward kernel")
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
    print(f"phase 3: launches {launches}; containers {same} to the CPU path "
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
    del encs, decoded, cpu_decoded, cpu_encs

    # ---- phase 4: times on the card ---------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    big = torch.randint(0, 256, (64, 2048, 2048, 3), dtype=torch.uint8,
                        device=dev, generator=gen)
    mpix = 64 * 2048 * 2048 / 1e6

    def kernel(x):
        return forward_combined(x, LUM, CHR)

    def plain(x):
        return forward_combined_ref(x, LUM, CHR)

    # Sum-order flips (phase 2) may part the two checksums: not checked.
    kernel_ms, plain_ms = kernel_vs_plain(
        "phase 4: forward 2048x2048 b64", kernel, plain, big, identical=False
    )
    print(f"phase 4: forward 2048x2048 b64: kernel {kernel_ms:.4f} ms "
          f"({mpix / kernel_ms * 1e3:.1f} MPix/s), plain {plain_ms:.4f} ms "
          f"({mpix / plain_ms * 1e3:.1f} MPix/s)")
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

    lz4 = lz4_phases(dev)

    print(json.dumps({"kernels": [{
        "name": "fwd_megakernel",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, *lz4]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
