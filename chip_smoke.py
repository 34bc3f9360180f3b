#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lz4jpeg_tpu_torch) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one card.  At first use it builds the forward kernel (nvcc,
sm_90a) and the native entropy runtime (g++) into
``lz4jpeg_tpu_torch/_build/``, then runs four phases and fails (non-zero
exit, no result line) if any of them fails:

1. the card's name and power limit, the torch and CUDA versions, and the
   build seconds;
2. the Hopper kernel against its plain torch version on the card, at
   2048×2048 (batch 8, duplicated columns for runs) and the ragged shapes
   2047×1531, 37×53 and 8×8.  Identity is expected; the only admissible
   difference is a sum-order flip (``lz4jpeg_tpu_torch/utils/parity.py``),
   at most 1e-5 of the coefficients;
3. the main path: ``JPEGPipeline(JPEGConfig(), device="cuda")``,
   ``encode_batch`` of four 2048² frames, ``pack_container``,
   ``unpack_container``, ``decode_batch``.  The kernel must have launched;
   the containers must equal the CPU path's byte for byte (or differ only
   by phase 2's flips); the decoded RGB must stay within the fast-path
   envelope of the CPU path's decode (max |Δ| ≤ 3 on ≤ 2e-3 of pixels);
4. times on the card: the forward at 2048², batch 64, kernel against plain
   (CUDA events, 2 warm-up runs, 10 runs with min and max dropped, each run
   fenced by a checksum over its full output), and the encode → container
   → decode round trip of one 2048² frame.

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
    from lz4jpeg_tpu_torch.native import native_backend
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import (
        forward_combined,
        forward_combined_ref,
        load_kernel,
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
    load_kernel()
    t1 = time.perf_counter()
    native_backend()
    t2 = time.perf_counter()
    print(f"phase 1: build nvcc fwd_megakernel {t1 - t0:.2f} s, "
          f"g++ lz4core {t2 - t1:.2f} s")

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

    blocks = {}
    for label, fn in (("plain", plain), ("kernel", kernel),
                      ("kernel", kernel), ("plain", plain)):
        ms, sums = timed_runs(fn, big)
        blocks.setdefault(label, []).append((trimmed_mean(ms), sums))
        print(f"phase 4: forward 2048x2048 b64 {label}: trimmed mean "
              f"{trimmed_mean(ms):.4f} ms (runs {[round(t, 4) for t in ms]})")
    checksums = {}
    for label, runs in blocks.items():
        sums = set().union(*(s for _, s in runs))
        check(len(sums) == 1, f"{label} output changed between runs: {sums}")
        checksums[label] = sums.pop()
    kernel_ms = sum(t for t, _ in blocks["kernel"]) / 2
    plain_ms = sum(t for t, _ in blocks["plain"]) / 2
    print(f"phase 4: forward 2048x2048 b64: kernel {kernel_ms:.4f} ms "
          f"({mpix / kernel_ms * 1e3:.1f} MPix/s), plain {plain_ms:.4f} ms "
          f"({mpix / plain_ms * 1e3:.1f} MPix/s); output checksums {checksums}")
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

    print(json.dumps({"kernels": [{
        "name": "fwd_megakernel",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
