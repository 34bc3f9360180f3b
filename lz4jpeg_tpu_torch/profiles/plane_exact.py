"""Whether the plane-view fused einsum equals the tile product, and the
sublane RLE at SEG 32 and 64.

Port of ``profiles/profile_plane_exact.py``.  Part (a), which has no
Pallas kernel: on noise frames of side² (the probe's 256² and 512², from
``utils/inputs.py::generate_noise_image``), each channel (``lum``, ``r``,
``b``) through ``models/jpeg.py::forward_channel`` on its MCU tiles (the
fused float32 product) and through the plane-view einsum
``"krc,arbc->akb"`` on its 8-row bands (``ops/fused.py::
fused_forward_plane``: snap 1e-5, truncate), both IEEE float32 with TF32
off; the count of coefficients that differ, as the probe prints it, and
the count of those that ``utils/parity.py::transform_flips`` admits as
sum-order flips (any other difference raises).  Part (b): the sublane RLE
kernel (``profiles/sublane_rle.py``; the probe's ``make_kernel(SEG)``,
``pallas_call`` :107) at SEG 32 and 64: the probe's (SEG, 256)
run-structured values held identical to the plain version, then the kernel
and its plain version timed at (32, ``cols``) int32 uniform in [-511, 511]
(the probe's (32, 2,097,152)).  SEG 64 at (64, 2,097,152) is the same
kernel on the same input as ``profiles/sublane_butterfly.py``'s timing, so
it is timed there only.

Times: ``profiles/timing.py`` (best of ``runs`` runs of ``reps`` calls,
queued behind a spin on the card; each kernel run guarded by its wrapper's
launch count).  Run on the card from the repository root (on the CPU add
``--device cpu --sizes 64 --cols 1024``)::

    python -m lz4jpeg_tpu_torch.profiles.plane_exact --output p.json
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record
from lz4jpeg_tpu_torch.models.jpeg import (
    _CHANNEL_SHAPES,
    forward_channel,
    scaled_tables,
)
from lz4jpeg_tpu_torch.ops.color import (
    chroma_subsample_422,
    rgb_to_ycbcr,
    split_mcus,
)
from lz4jpeg_tpu_torch.ops.fused import fused_forward_plane
from lz4jpeg_tpu_torch.profiles import sublane_rle as sr
from lz4jpeg_tpu_torch.profiles import timing
from lz4jpeg_tpu_torch.profiles.sublane_butterfly import check_probe
from lz4jpeg_tpu_torch.utils.inputs import generate_noise_image
from lz4jpeg_tpu_torch.utils.parity import transform_flips

CHECK_COLS = 256  # the probe's check width (profile_plane_exact.py:113)
TIMED_SEG = 32  # SEG 64 is timed by profiles/sublane_butterfly.py


def plane_einsum(plane: torch.Tensor, name: str, tables) -> torch.Tensor:
    """(H, Wp) uint8 plane of channel ``name`` → (H/8 · ..., 8·tw, bw)
    float32 quantized zigzag coefficients in the KT layout, IEEE float32
    (the probe's ``plane_einsum``)."""
    tw = _CHANNEL_SHAPES[name][1]
    with timing.no_tf32():
        return fused_forward_plane(plane, tables[name], tw)


def plane_channels(img: torch.Tensor):
    """(name, MCU tiles, plane) of each channel of one (H, W, 3) frame, as
    the probe splits them."""
    y, cr, cb = rgb_to_ycbcr(img, torch.float32)
    crs, cbs = chroma_subsample_422(cr), chroma_subsample_422(cb)
    lum_t, r_t, b_t = split_mcus(y, crs, cbs)
    return (("lum", lum_t, y), ("r", r_t, crs), ("b", b_t, cbs))


def plane_mismatches(img: torch.Tensor, tables) -> Dict[str, Dict]:
    """Per channel: the coefficients of the plane einsum that differ from
    ``forward_channel``'s, of how many, and how many of them are admissible
    sum-order flips (``transform_flips`` raises on any other)."""
    out = {}
    for name, tiles, plane in plane_channels(img):
        with timing.no_tf32():
            zz_tile = forward_channel(tiles, name, tables, torch.float32, True)
        zz_plane = plane_einsum(plane, name, tables)
        k = zz_plane.shape[1]
        plane_nk = zz_plane.transpose(1, 2).reshape(-1, k)
        flips = transform_flips("forward", tiles, plane_nk, zz_tile,
                                tables[name], _CHANNEL_SHAPES[name][1], 8,
                                name=f"plane einsum {name}")
        out[name] = {"mismatches": int((plane_nk != zz_tile).sum()),
                     "coefficients": plane_nk.numel(), "flips": flips}
    return out


def run_plane_exact(device="cuda", sizes: Sequence[int] = (256, 512),
                    cols: int = 2_097_152, runs: int = 4, reps: int = 8,
                    output: Optional[str] = None, seed: int = 0) -> Dict:
    """Part (a) on noise frames of each side in ``sizes``, then part (b):
    the check at SEG 32 and 64 and the timing at SEG 32; returns the result
    and writes it to ``output`` if given."""
    dev = bench_device(device)
    cuda = dev.type == "cuda"
    key = timing.timer_key(dev)
    rng = np.random.default_rng(seed)
    tables = scaled_tables(None)
    einsum = {}
    for size in sizes:
        img = torch.from_numpy(generate_noise_image(size, size, rng)).to(dev)
        einsum[str(size)] = plane_mismatches(img, tables)
        for name, r in einsum[str(size)].items():
            print(f"{size}² {name}: mismatches {r['mismatches']}/"
                  f"{r['coefficients']} (sum-order flips {r['flips']})",
                  flush=True)
    total = sum(r["mismatches"] for s in einsum.values() for r in s.values())
    print(f"TOTAL mismatches: {total}", flush=True)

    checks = [{"seg": seg, **check_probe(seg, CHECK_COLS, rng, dev)}
              for seg in sr.SEGMENTS]
    for c in checks:
        print(f"SEG={c['seg']} sublane bit-identical on the probe's "
              f"{tuple(c['shape'])} values", flush=True)
    x = sr.uniform_values(TIMED_SEG, cols, dev, seed + TIMED_SEG)
    before = sr.sublane_rle.launches
    ms = timing.time_ms(sr.sublane_rle, x, dev, reps=reps, runs=runs,
                        kernel=sr.sublane_rle if cuda else None)
    launches = sr.sublane_rle.launches - before
    plain_ms = timing.time_ms(sr.sublane_rle_ref, x, dev, reps=reps, runs=runs)
    del x
    n_bytes = sr.rle_bytes(TIMED_SEG, cols)
    bound = timing.bytes_bound_ms(n_bytes)
    share = bound / ms if cuda else None
    attrs = sr.attributes(TIMED_SEG, 4, dev)
    print(f"SEG={TIMED_SEG} ({TIMED_SEG}, {cols}) int32 {ms:.4f} ms, plain "
          f"{plain_ms:.4f}"
          + ("" if share is None else
             f"  {share:.1%} of {bound:.4f}  regs {attrs['registers']}  smem "
             f"{attrs['shared_bytes']}  ctas/SM {attrs['ctas_per_sm']}"),
          flush=True)

    where = device_record(dev)
    verdict = (f"on {where.get('card', dev)}: the plane einsum differs from "
               f"the tile product in {total} coefficients (all sum-order "
               f"flips); the sublane RLE takes {ms:.4f} ms at SEG "
               f"{TIMED_SEG}")
    print(f"verdict: {verdict}")
    result = {
        "sizes": list(sizes), "seg": TIMED_SEG, "cols": cols, "runs": runs,
        "reps": reps, "seed": seed, "backend": dev.type,
        "timer": "cuda events" if cuda else "host clock", **where,
        "einsum": einsum, "total_mismatches": total,
        "site": "profile_plane_exact.py:107", "checks": checks, key: ms,
        f"plain_{key}": plain_ms, "launches": launches, "bytes": n_bytes,
        "bytes_bound_ms": bound, "share": share, **attrs, "verdict": verdict,
    }
    return timing.write_result(result, output)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4jpeg_tpu_torch.profiles.plane_exact",
        description="The plane einsum against the tile product, and the "
                    "sublane RLE kernel checked at SEG 32 and 64 and timed "
                    "at SEG 32.")
    ap.add_argument("--sizes", type=int, nargs="+", default=[256, 512])
    ap.add_argument("--cols", type=int, default=2_097_152)
    timing.add_arguments(ap)
    args = ap.parse_args(argv)
    run_plane_exact(args.device, args.sizes, args.cols, args.runs, args.reps,
                    args.output, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
