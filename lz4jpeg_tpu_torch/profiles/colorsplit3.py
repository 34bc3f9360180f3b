"""The colour → MCU split → fused forward prefix with the relayout kernel:
the run of ``profiles/profile_colorsplit3.py`` on the card.

The probe asked whether the 8 × 8 tiling relayout could be (B) absorbed
into the fused MCU product as a two-contracting-dim einsum straight off
the (bh, 8, bw, tw) plane view, or (C) done by a hand-written relayout
kernel, and timed both against (A) ``split_mcus`` + the fused product.
The rows here are the probe's, at its size (``frames`` noise frames of
``side``², ``utils/inputs.py::generate_noise_image``, seed 0):

* A: ``rgb_to_ycbcr``, ``split_mcus``, ``fused_forward`` a channel;
* B / B2: the plane-view einsum ``krc,arbc->abk`` / ``->akb`` (no final
  transpose), then the offset and the snap;
* C: ``mcu_relayout`` (the kernel, ``profiles/mcu_relayout.py``), then
  ``torch.matmul`` with the basis, the offset and the snap;
* "split only": colour and ``split_mcus``, or colour and the kernel.

The products run on cuBLAS in IEEE float32 (TF32 off), where the probe
asked for ``precision="highest"``; they and the einsums are torch calls,
as the probe left them to XLA.  B's and C's coefficients are compared
with A's as the probe did (:198-210).  Beside them the kernel alone on one
channel's planes (luma tw 8, Cr tw 4) against its plain version, which
is also the library call (``split_mcus``'s one transposing copy), and
``ops/stream.py::stream_copy`` of the same bytes.  Times: ``profiles/timing.py`` (the probe's rows one call a run,
best of ``runs``, as its ``timeit``; the kernel alone ``reps`` calls a
run); the kernel rows' bound: every byte read and written once over 3.35
TB/s.  Run on the card from the
repository root (on the CPU add ``--device cpu --frames 1 --side 64``)::

    python -m lz4jpeg_tpu_torch.profiles.colorsplit3 --output s.json
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record
from lz4jpeg_tpu_torch.models.jpeg import scaled_tables
from lz4jpeg_tpu_torch.ops.color import (
    _snap_trunc,
    chroma_subsample_422,
    rgb_to_ycbcr,
    split_mcus,
)
from lz4jpeg_tpu_torch.ops.fused import _table_key, forward_basis, fused_forward
from lz4jpeg_tpu_torch.ops.stream import stream_copy
from lz4jpeg_tpu_torch.profiles import timing
from lz4jpeg_tpu_torch.profiles.mcu_relayout import (
    attributes,
    mcu_relayout,
    mcu_relayout_ref,
)
from lz4jpeg_tpu_torch.utils.inputs import generate_noise_image

TABLES = scaled_tables(None)
CHANNELS = (("lum", 8), ("r", 4), ("b", 4))  # (table, tw) of the three planes
SNAP = 1e-5  # the probe's snap_trunc


def _planes(rgb: torch.Tensor):
    y, cr, cb = rgb_to_ycbcr(rgb, torch.float32)
    return y, chroma_subsample_422(cr), chroma_subsample_422(cb)


def _basis(name: str, tw: int, dev: torch.device):
    m, off = forward_basis(tw, 8, _table_key(TABLES[name]))
    return (torch.from_numpy(m.astype(np.float32)).to(dev),
            torch.from_numpy(off.astype(np.float32)).to(dev))


def baseline(rgb: torch.Tensor):
    """A: colour, ``split_mcus``, ``fused_forward`` a channel."""
    tiles = split_mcus(*_planes(rgb))
    return tuple(fused_forward(t, TABLES[name], tw, 8)
                 for t, (name, tw) in zip(tiles, CHANNELS))


def einsum_forward(plane: torch.Tensor, name: str, tw: int, order: str):
    """(frames, H, Wp) uint8 → the plane einsum's coefficients: (bh·bw,
    8·tw) for ``"abk"``, (bh, 8·tw, bw) for ``"akb"`` (no final
    transpose); frames stack as block rows."""
    wp = plane.shape[-1]
    bw = wp // tw
    x = plane.reshape(-1, 8, bw, tw).to(torch.float32)
    m, off = _basis(name, tw, plane.device)
    mt = m.reshape(8 * tw, 8, tw)
    if order == "abk":
        ratio = torch.einsum("krc,arbc->abk", mt, x) - off
        return _snap_trunc(ratio, SNAP).reshape(-1, 8 * tw)
    ratio = torch.einsum("krc,arbc->akb", mt, x) - off[:, None]
    return _snap_trunc(ratio, SNAP)


def variant_b(rgb: torch.Tensor, order: str = "abk"):
    return tuple(einsum_forward(p, name, tw, order)
                 for p, (name, tw) in zip(_planes(rgb), CHANNELS))


def variant_c(rgb: torch.Tensor):
    """C: colour, the relayout kernel, the basis product, offset, snap."""
    out = []
    for p, (name, tw) in zip(_planes(rgb), CHANNELS):
        m, off = _basis(name, tw, rgb.device)
        tiles = mcu_relayout(p, tw)
        out.append(_snap_trunc(tiles.to(torch.float32) @ m.t() - off, SNAP))
    return tuple(out)


def split_only_base(rgb: torch.Tensor):
    return split_mcus(*_planes(rgb))


def split_only_kernel(rgb: torch.Tensor):
    return tuple(mcu_relayout(p, tw)
                 for p, (_, tw) in zip(_planes(rgb), CHANNELS))


def coefficient_mismatches(got, want) -> Dict[str, int]:
    """The probe's ``report_mismatch``: outputs of ``got`` that differ from
    ``want``, over the three channels."""
    total = sum(w.numel() for w in want)
    mism = sum(int((g.reshape(w.shape) != w).sum()) for g, w in zip(got, want))
    return {"mismatches": mism, "coefficients": total}


def run_colorsplit3(device="cuda", frames: int = 32, side: int = 2048,
                    runs: int = 4, reps: int = 8, output: Optional[str] = None,
                    seed: int = 0) -> Dict:
    """The probe's rows and the kernel alone; returns the result and writes
    it to ``output`` if given."""
    dev = bench_device(device)
    cuda = dev.type == "cuda"
    key = timing.timer_key(dev)
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(np.stack(
        [generate_noise_image(side, side, rng) for _ in range(frames)])).to(dev)
    mpix = frames * side * side / 1e6

    with timing.no_tf32():
        base = baseline(imgs)
        # Identical tiles first: C's product then equals A's call for call.
        for got, want in zip(split_only_kernel(imgs), split_only_base(imgs)):
            if not torch.equal(got, want.reshape(got.shape)):
                raise AssertionError(f"mcu_relayout differs from split_mcus "
                                     f"on {tuple(want.shape)} tiles")
        checks = {"B (abk)": coefficient_mismatches(variant_b(imgs), base),
                  "C": coefficient_mismatches(variant_c(imgs), base)}
        for name, c in checks.items():
            print(f"{name}: {c['mismatches']}/{c['coefficients']} coefficient "
                  "mismatches vs baseline", flush=True)
        del base
        rows = []
        for label, fn, per_call in (
                ("A baseline split+matmul", baseline, 0),
                ("B einsum-from-plane (abk)", variant_b, 0),
                ("B2 einsum-from-plane (akb, no fin. T)",
                 lambda v: variant_b(v, "akb"), 0),
                ("C relayout kernel + matmul", variant_c, 3),
                ("split only: baseline", split_only_base, 0),
                ("split only: kernel", split_only_kernel, 3)):
            before = mcu_relayout.launches
            # one call a run, as the probe's timeit: a row takes ~25 ms
            ms = timing.time_ms(fn, imgs, dev, reps=1, runs=runs,
                                kernel=mcu_relayout if cuda and per_call
                                else None, per_call=per_call or 1)
            rows.append({"row": label, key: ms, "mpix_per_s": mpix / ms * 1e3,
                         "launches": mcu_relayout.launches - before})
            print(f"{label:40s} {ms:9.4f} ms  {mpix / ms * 1e3:10.1f} MPix/s",
                  flush=True)

    planes = [p.contiguous() for p in _planes(imgs)]
    del imgs
    alone = []
    for tag, plane, tw in (("luma", planes[0], 8), ("chroma Cr", planes[1], 4)):
        if not torch.equal(mcu_relayout(plane, tw), mcu_relayout_ref(plane, tw)):
            raise AssertionError(f"mcu_relayout differs on the {tag} planes")
        before = mcu_relayout.launches
        ms = timing.time_ms(lambda v, tw=tw: mcu_relayout(v, tw), plane, dev,
                            reps=reps, runs=runs,
                            kernel=mcu_relayout if cuda else None)
        launches = mcu_relayout.launches - before
        plain_ms = timing.time_ms(lambda v, tw=tw: mcu_relayout_ref(v, tw),
                                  plane, dev, reps=reps, runs=runs)
        copy_ms = timing.time_ms(stream_copy, plane, dev, reps=reps, runs=runs,
                                 kernel=stream_copy if cuda else None)
        bound = timing.bytes_bound_ms(2 * plane.numel())
        row = {"row": f"relayout {tag}", "shape": list(plane.shape), "tw": tw,
               "site": "profile_colorsplit3.py:118", key: ms,
               f"plain_{key}": plain_ms, f"copy_{key}": copy_ms,
               "library": "split_mcus's transposing copy (the plain version)",
               f"library_{key}": plain_ms, "launches": launches,
               "bytes": 2 * plane.numel(), "bytes_bound_ms": bound,
               "share": bound / ms if cuda else None,
               **attributes(tw, device=dev)}
        alone.append(row)
        print(f"relayout {tag} {tuple(plane.shape)} tw {tw}: {ms:9.4f} ms  "
              f"split_mcus {plain_ms:9.4f}  stream copy {copy_ms:9.4f}"
              + ("" if row["share"] is None else
                 f"  {row['share']:.1%} of {bound:.4f}  regs "
                 f"{row['registers']}  smem {row['shared_bytes']}  ctas/SM "
                 f"{row['ctas_per_sm']}"), flush=True)

    where = device_record(dev)
    t = {r["row"]: r[key] for r in rows}
    verdict = (f"on {where.get('card', dev)}: the relayout kernel equals "
               f"split_mcus; C {t['C relayout kernel + matmul']:.4f} ms "
               f"against A {t['A baseline split+matmul']:.4f} and B "
               f"{t['B einsum-from-plane (abk)']:.4f}; the kernel alone "
               f"{alone[0][key] / alone[0][f'plain_{key}']:.2f}x split_mcus and"
               f" {alone[0][key] / alone[0][f'copy_{key}']:.2f}x a copy on "
               "luma")
    print(f"verdict: {verdict}")
    result = {"frames": frames, "side": side, "runs": runs, "reps": reps,
              "seed": seed, "backend": dev.type,
              "timer": "cuda events" if cuda else "host clock", **where,
              "checks": checks, "rows": rows, "relayout": alone,
              "verdict": verdict}
    return timing.write_result(result, output)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4jpeg_tpu_torch.profiles.colorsplit3",
        description="The colour-split probe's rows with the MCU relayout "
                    "kernel.")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--side", type=int, default=2048)
    timing.add_arguments(ap)
    args = ap.parse_args(argv)
    run_colorsplit3(args.device, args.frames, args.side, args.runs, args.reps,
                    args.output, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
