"""K9's tie window and its CTA shape on the card: what the window needs,
how far the tensor-core sums lie from the chain's, what the tie pass
costs, and how the warps a CTA move the time.

    python -m lz4jpeg_tpu_torch.profiles.inv_probe [--frames 8] [--output F.json]

Every variant is ``csrc/inv_megakernel.cu`` with some of its constants set
(``shaped_source``, ``BUILDS``), compiled with the toolkit (ptxas's
registers and spill bytes), all at once, and launched like
``inverse_combined``.

1. Windows.  On K1's buffers of 2048² noise frames at quality 50, 75, 90
   and 100 (``--frames`` each) and on stress buffers of uniform deltas
   (every word 1024 + U[−D, D], D = 32, 64, 128 and 256;
   ``STRESS_FRAMES``):
   - the pixels of K9's output that differ from the chain's bytes (the
     "chain" build, whose window 0.5 sends every value to the tie pass) at
     fixed windows 0 and 2⁻¹³ .. 2⁻⁶ (``kFixedWindow``: no row's sum
     widens it), and at the main path's windows with its tie count;
   - the largest |tensor-core sum − chain| of a value whose byte may step,
     over its row's window W at the main path's windows and over W's
     unscaled sum Σ_m |Δ_m| · max_p |S[p][m]| (the "distance" build,
     ``kDistance``), so the margin the window keeps (the source's argument
     wants under a quarter) and the row scale a quarter margin needs; the
     same at half the source's row scale (``HALF``), with its tie count.
2. Builds.  K9 at ``SHAPES`` (warps a CTA, ring slots; the source's first)
   and at half the row scale, timed in turns at 2048² b64 with the build
   at a fixed window of 0 (no tie pass) beside them (``timing.time_ms``,
   each build in the order given, then in reverse); every output but the
   last identical to the source's.

CUDA only: a run without a card raises.  Prints the card's name and power
limit and every count, distance and time; ``--output`` writes them as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import struct
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from lz4jpeg_tpu_torch.kernels.build import CSRC_DIR, NVCC_FLAGS, nvcc_path
from lz4jpeg_tpu_torch.ops import inv_megakernel as inv
from lz4jpeg_tpu_torch.profiles.timing import time_ms

QUALITIES = (None, 75, 90, 100)
STRESS = (32, 64, 128, 256)  # D of the uniform-delta buffers
STRESS_FRAMES = 2
WINDOWS = [0.0] + [2.0 ** -k for k in range(13, 5, -1)]
SHAPES = ((inv.WARPS, inv.STAGES), (inv.WARPS, 1), (7, 3))
SIDE = 2048
MARGIN = 0.25  # the largest distance the source's window argument allows
HALF = "half row scale"


def fixed(w: float) -> str:
    return f"fixed {w:g}"


def shape(warps: int, stages: int) -> str:
    return f"{warps} warps, {stages} slots"


# Each variant's constants, as C literals.
BUILDS = {
    "chain": {"kTieWindow": "0.5f"},
    "distance": {"kDistance": "true"},
    **{fixed(w): {"kFixedWindow": "true", "kTieWindow": f"{w!r}f"}
       for w in WINDOWS},
    **{shape(w, s): {"kWarps": str(w), "kStages": str(s)}
       for w, s in SHAPES},
    HALF: {"kRowScale": f"{inv.ROW_SCALE / 2!r}f"},
    f"distance, {HALF}": {"kRowScale": f"{inv.ROW_SCALE / 2!r}f",
                          "kDistance": "true"},
}


def shaped_source(text: str, **values: str) -> str:
    """``csrc/inv_megakernel.cu``'s text with each named constant set to
    its C literal; each must be defined once."""
    for name, value in values.items():
        text, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;",
                          lambda m: f"{m[1]}{value};", text)
        if n != 1:
            raise ValueError(f"{name} is not defined once in the source")
    return text


def build(name: str, values: dict, tmp: Path):
    """K9 with ``values`` set, as a loaded library, with ptxas's report:
    (lib, {"registers", "spill_stores"})."""
    stem = re.sub(r"\W+", "_", name)
    src = tmp / f"inv_{stem}.cu"
    src.write_text(shaped_source(
        (CSRC_DIR / "inv_megakernel.cu").read_text(), **values))
    lib_path = tmp / f"libinv_{stem}.so"
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC_DIR),
         "-o", str(lib_path), str(src)],
        capture_output=True, text=True, check=True)
    kernel = False
    use = {}
    for line in proc.stderr.splitlines():
        if "Function properties for" in line:
            kernel = "inv_megakernel" in line
        m = re.search(r"(\d+) bytes spill stores", line)
        if kernel and m:
            use["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if kernel and m:
            use["registers"] = int(m.group(1))
            kernel = False
    lib = ctypes.CDLL(str(lib_path))
    lib.inv_megakernel_launch.restype = ctypes.c_int
    lib.inv_megakernel_launch.argtypes = (
        inv.load_kernel().inv_megakernel_launch.argtypes)
    return lib, use


def launch(lib, comb, tables, ties=None):
    """``inverse_combined``'s launch of a 2048² buffer through ``lib``."""
    b, nb = comb.shape[0], SIDE // 8
    out = torch.empty((b, SIDE, SIDE, 3), dtype=torch.uint8,
                      device=comb.device)
    keys = inv.table_keys(tables)
    rc = lib.inv_megakernel_launch(
        comb.data_ptr(), out.data_ptr(),
        inv._device_parts(keys, comb.device).data_ptr(),
        inv._device_bases(keys, comb.device).data_ptr(), b, nb, nb, SIDE,
        SIDE, None if ties is None else ties.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"inv_megakernel_launch failed ({rc})")
    return out


def as_float(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _log2(x: float) -> str:
    return f"{math.log2(x):.2f}" if x > 0 else "-inf"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--output", help="write the counts and times as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("inv_probe needs a CUDA card")
    from lz4jpeg_tpu_torch.models.jpeg import scaled_tables
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import forward_combined

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    nb = SIDE // 8
    result = {"card": card, "windows": WINDOWS, "buffers": {}, "builds": {}}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    inv.load_kernel()  # the source's own build, before the variants
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        built = dict(zip(BUILDS, pool.map(lambda kv: build(*kv, tmp),
                                          BUILDS.items())))
    for name, (_, use) in built.items():
        result["builds"][name] = use
        print(f"K9 {name}: {use['registers']} registers, "
              f"{use['spill_stores']} B spill stores", flush=True)
    libs = {name: lib for name, (lib, _) in built.items()}

    def pixels_off(a, b):
        return int((a != b).any(dim=-1).sum())

    buffers = [(f"quality {q or 50} noise", q) for q in QUALITIES] + [
        (f"uniform deltas ±{d}", d) for d in STRESS]
    worst = {"of_window": 0.0, "of_sum": 0.0}
    for label, arg in buffers:
        if label.startswith("uniform"):
            tables = scaled_tables(None)
            comb = torch.randint(1024 - arg, 1025 + arg,
                                 (STRESS_FRAMES, nb * nb, 128),
                                 dtype=torch.int16, device=dev, generator=gen)
        else:
            tables = scaled_tables(arg)
            x = torch.randint(0, 256, (args.frames, SIDE, SIDE, 3),
                              dtype=torch.uint8, device=dev, generator=gen)
            comb = forward_combined(x, tables["lum"], tables["r"]).reshape(
                args.frames, -1, 128)
            del x
        chain = launch(libs["chain"], comb, tables)
        ties = torch.zeros(1, dtype=torch.int64, device=dev)
        main_path = inv.inverse_combined(comb, tables, nb, nb, SIDE, SIDE,
                                         ties=ties)
        rec = torch.zeros(3, dtype=torch.int64, device=dev)
        measured = launch(libs["distance"], comb, tables, rec)
        if not torch.equal(measured, main_path) or int(rec[0]) != int(ties[0]):
            raise AssertionError(f"{label}: the distance build's bytes or "
                                 "tie count differ from the source's")
        half = torch.zeros(3, dtype=torch.int64, device=dev)
        launch(libs[f"distance, {HALF}"], comb, tables, half)
        off = [pixels_off(launch(libs[fixed(w)], comb, tables), chain)
               for w in WINDOWS]
        values = comb.shape[0] * comb.shape[1] * 192
        row = {"pixels": comb.shape[0] * SIDE * SIDE, "values": values,
               "fixed_window_pixels_off": off,
               "main_path_pixels_off": pixels_off(main_path, chain),
               "ties": int(ties[0]),
               "distance_of_window": as_float(int(rec[1])),
               "distance_of_sum": as_float(int(rec[2])),
               "half_scale": {"ties": int(half[0]),
                              "distance_of_window": as_float(int(half[1]))}}
        for key in worst:
            worst[key] = max(worst[key], row[f"distance_{key}"])
        result["buffers"][label] = row
        print(f"{label}: pixels off the chain's bytes at fixed windows "
              + ", ".join(f"{w:g}: {n}" for w, n in zip(WINDOWS, off))
              + f"; at the main path's windows {row['main_path_pixels_off']}"
              f", tie pass {row['ties']} of {values} values "
              f"({row['ties'] / values:.3%}); largest |sum - chain| "
              f"{row['distance_of_window']:.4f} of its row's window, "
              f"{row['distance_of_sum']:.4g} of its unscaled sum "
              f"(2^{_log2(row['distance_of_sum'])}); at {HALF} tie pass "
              f"{row['half_scale']['ties'] / values:.3%}, largest "
              f"{row['half_scale']['distance_of_window']:.4f} of its row's "
              "window", flush=True)
        del comb, chain, main_path, measured
        torch.cuda.empty_cache()
    result["largest_distance"] = worst
    print(f"largest |sum - chain|: {worst['of_window']:.4f} of its row's "
          f"window (margin kept: under {MARGIN}: "
          f"{'yes' if worst['of_window'] < MARGIN else 'NO'}), "
          f"{worst['of_sum']:.4g} of its unscaled sum; a row scale of "
          f"{worst['of_sum'] / MARGIN:.4g} (2^{_log2(worst['of_sum'] / MARGIN)}"
          f") keeps the margin against the source's {inv.ROW_SCALE:g}")

    tables = scaled_tables(None)
    x = torch.randint(0, 256, (64, SIDE, SIDE, 3), dtype=torch.uint8,
                      device=dev, generator=gen)
    comb = forward_combined(x, tables["lum"], tables["r"]).reshape(64, -1, 128)
    del x
    names = [shape(w, s) for w, s in SHAPES] + [HALF, fixed(0.0)]
    fns = {n: (lambda lib: lambda c: launch(lib, c, tables))(libs[n])
           for n in names}
    want = inv.inverse_combined(comb, tables, nb, nb, SIDE, SIDE)
    for name in names[:-1]:
        if not torch.equal(fns[name](comb), want):
            raise AssertionError(f"K9 at {name} differs from the source's")
    runs = {n: [] for n in names}
    for name in [*names, *reversed(names)]:
        runs[name].append(time_ms(fns[name], comb, dev, reps=10))
    times = {n: sum(t) / len(t) for n, t in runs.items()}
    tmp_dir.cleanup()
    result["times_ms"] = times
    for name, ms in times.items():
        label = "no tie pass" if name == fixed(0.0) else name
        print(f"K9 {SIDE}x{SIDE} b64 {label}: {ms:.4f} ms "
              f"(turns {[round(t, 4) for t in runs[name]]})")
    if args.output:
        Path(args.output).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
