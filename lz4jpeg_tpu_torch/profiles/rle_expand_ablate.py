"""Where K7's time goes: its plane decode cut after each phase, cumulatively.

Port of ``profiles/profile_rle_expand_ablate.py``, which ablated the TPU's
plane decode in the steps copyT, +unpack, +matmul (the prefix sum of the
counts), +dist (the distribute stages) and full.  Here each step is an
instantiation of K7's own template (``profiles/rle_expand.py::
expand_plane_phase``, ``csrc/expand16_plane.cuh``) and the full row is K7
itself (``ops/pack16.py::pack16_decode_plane``), so the step from one row to
the next is the cost of one phase of K7's code.  On the probe's data
(values uniform in [-511, 511], the even rows repeating a value in groups
of 8, packed by the port's ``ops/rle.py::rle_encode_packed16``): the luma
of ``frames`` frames of side² (K = 64, bw = side / 8) and their chroma (K =
32, bw = side / 16).  Each phase is first held identical to its plain
version, then timed beside it; the copyT row also shows ``copy_t_slab``
(the same movement with no ring of lengths) on the same words in the same
run.

Times: ``profiles/timing.py`` (best of ``runs`` runs of ``reps`` calls, the
plain version one call a run, queued behind a spin so that the card's work
is timed, not the host's issue of each call; each kernel run guarded by
its wrapper's launch count); share of the bytes bound (words and lengths
in, values out) and GB/s read + write on a card only.  Run on the card from the repository
root (on the CPU add ``--device cpu --frames 1 --side 64``)::

    python -m lz4jpeg_tpu_torch.profiles.rle_expand_ablate --output ablate.json
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record
from lz4jpeg_tpu_torch.ops import pack16
from lz4jpeg_tpu_torch.ops.rle import rle_encode_packed16
from lz4jpeg_tpu_torch.profiles import rle_expand as rx
from lz4jpeg_tpu_torch.profiles import timing


def channels(side: int):
    """(tag, K, bw, rows per frame) of the probe's two channels."""
    return (("lum", 64, side // 8, (side // 8) ** 2),
            ("chr", 32, side // 16, (side // 8) * (side // 16)))


def run_rle_expand_ablate(device="cuda", frames: int = 16, side: int = 2048,
                          runs: int = 4, reps: int = 8,
                          output: Optional[str] = None,
                          seed: int = 0) -> Dict:
    """Every phase at luma and chroma of ``frames`` frames of side²;
    returns the result and writes it to ``output`` if given."""
    dev = bench_device(device)
    cuda = dev.type == "cuda"
    key = timing.timer_key(dev)
    rng = np.random.default_rng(seed)
    out = {}
    for tag, k, bw, per_frame in channels(side):
        rows = frames * per_frame
        vals = torch.from_numpy(rx.ablate_symbols(rows, k, rng)).to(dev)
        words, lens = rle_encode_packed16(vals)
        del vals
        n_bytes = rx.phase_bytes(rows, k)
        bound = timing.bytes_bound_ms(n_bytes)
        x = (words, lens)
        phases, prev = [], None
        for phase in rx.PHASES:
            # the full phase is K7, which counts its own launches
            wrapper = (pack16.pack16_decode_plane if phase == "full"
                       else rx.expand_plane_phase)
            before = wrapper.launches
            got = rx.expand_plane_phase(words, lens, bw, phase)
            if not torch.equal(got, rx.expand_plane_phase_ref(words, lens, bw,
                                                              phase)):
                raise AssertionError(f"{tag} {phase}: the kernel differs from "
                                     "its plain version")
            del got
            ms = timing.time_ms(
                lambda a, ph=phase: rx.expand_plane_phase(*a, bw, ph), x, dev,
                reps=reps, runs=runs, kernel=wrapper if cuda else None)
            row = {"phase": phase, key: ms,
                   f"plain_{key}": timing.time_ms(
                       lambda a, ph=phase: rx.expand_plane_phase_ref(*a, bw, ph),
                       x, dev, reps=1, runs=runs),
                   f"delta_{key}": None if prev is None else ms - prev,
                   "launches": wrapper.launches - before,
                   "share": bound / ms if cuda else None,
                   "gb_per_s": n_bytes / ms / 1e6 if cuda else None,
                   **rx.phase_attributes(phase, k, dev)}
            if phase == "copyT":
                row[f"copy_t_slab_{key}"] = timing.time_ms(
                    lambda a: rx.copy_t_slab(a[0], bw), x, dev, reps=reps,
                    runs=runs, kernel=rx.copy_t_slab if cuda else None)
            phases.append(row)
            prev = ms
        del words, lens, x
        out[tag] = {"rows": rows, "K": k, "bw": bw, "bytes": n_bytes,
                    "bytes_bound_ms": bound, "phases": phases}

    where = device_record(dev)
    for tag, r in out.items():
        print(f"{tag}: {r['rows']} x {r['K']}, bw {r['bw']}, bytes bound "
              f"{r['bytes_bound_ms']:.4f} ms")
        for p in r["phases"]:
            slab = p.get(f"copy_t_slab_{key}")
            print(f"  {p['phase']:7s} {p[key]:9.4f} ms  plain "
                  f"{p[f'plain_{key}']:9.4f}"
                  + ("" if p[f"delta_{key}"] is None else
                     f"  delta {p[f'delta_{key}']:+.4f}")
                  + ("" if slab is None else f"  copy_t_slab {slab:.4f}")
                  + ("  (K7)" if p["phase"] == "full" else "")
                  + ("" if p["share"] is None else
                     f"  {p['share']:.1%} of bound  {p['gb_per_s']:7.1f} GB/s "
                     f"rd+wr  regs {p['registers']}  smem "
                     f"{p['shared_bytes']}  ctas/SM {p['ctas_per_sm']}"),
                  flush=True)
    lum = {p["phase"]: p[key] for p in out["lum"]["phases"]}
    steps = {ph: lum[ph] - lum[prev] for prev, ph in zip(rx.PHASES, rx.PHASES[1:])}
    biggest = max(steps, key=steps.get)
    verdict = (f"on {where.get('card', dev)}: luma copyT "
               f"{lum['copyT']:.4f} ms of full {lum['full']:.4f}; the largest "
               f"step is +{biggest} ({steps[biggest]:+.4f} ms)")
    print(f"verdict: {verdict}")
    result = {
        "frames": frames, "side": side, "runs": runs, "reps": reps,
        "seed": seed, "backend": dev.type,
        "timer": "cuda events" if cuda else "host clock", **where,
        "channels": out, "verdict": verdict,
    }
    return timing.write_result(result, output)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4jpeg_tpu_torch.profiles.rle_expand_ablate",
        description="Cumulative phase split of the packed16 plane decode (K7).")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--side", type=int, default=2048)
    timing.add_arguments(ap)
    args = ap.parse_args(argv)
    run_rle_expand_ablate(args.device, args.frames, args.side, args.runs,
                          args.reps, args.output, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
