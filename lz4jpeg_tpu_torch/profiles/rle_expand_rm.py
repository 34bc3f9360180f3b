"""The cost of K7's data movement, split: a row-major copy, the same copy on
the wide view, a contiguous transpose and a transpose into K7's plane
layout; then the plane inverse's einsum in both orientations.

Port of ``profiles/profile_rle_expand_rm.py``.  Part (a): the four copy
kernels of ``profiles/rle_expand.py`` on the probe's stream (the luma of
``frames`` frames of side², (rows, 64) int16, values in [1, 2^15)), each
first held identical to its plain version, then timed beside it and beside
the one PyTorch call for the same function (``Tensor.copy_`` for the
copy; for the transposes the plain version is that call).  Part (b): the
inverse ``torch.einsum`` on a (bh, 64, bw) zigzag operand (``akb``, what
K7 writes) and on its row-major transpose (``abk``), IEEE float32 with
TF32 off; whether the two agree, then both times.

Times: ``profiles/timing.py`` (best of ``runs`` runs of ``reps`` calls,
queued behind a spin so that the card's work is timed, not the host's
issue; each kernel run guarded by its wrapper's launch count); share of the
bytes bound and GB/s read + write on a card only.  Run on the card from the
repository root (on the CPU add ``--device cpu --frames 1 --side 64``)::

    python -m lz4jpeg_tpu_torch.profiles.rle_expand_rm --output rm.json
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record
from lz4jpeg_tpu_torch.profiles import rle_expand as rx
from lz4jpeg_tpu_torch.profiles import timing

K = 64


def copy_row(label: str, site: str, fn, counter, plain, library,
             library_name: str, x, n_bytes: int, attrs: Dict,
             dev: torch.device, runs: int, reps: int) -> Dict:
    """``fn`` (a call of the wrapper ``counter``) checked against its plain
    version, then ``fn``, the plain version and the library call (None: the
    plain version is that call) timed on ``x``."""
    cuda = dev.type == "cuda"
    key = timing.timer_key(dev)
    before = counter.launches
    if not torch.equal(fn(x), plain(x)):
        raise AssertionError(f"{label}: the kernel differs from its plain "
                             "version")
    ms = timing.time_ms(fn, x, dev, reps=reps, runs=runs,
                        kernel=counter if cuda else None)
    plain_ms = timing.time_ms(plain, x, dev, reps=reps, runs=runs)
    row = {"row": label, "site": site, "shape": list(x.shape), key: ms,
           f"plain_{key}": plain_ms, "library": library_name,
           f"library_{key}": plain_ms if library is None else
           timing.time_ms(library, x, dev, reps=reps, runs=runs),
           "launches": counter.launches - before,
           "bytes_bound_ms": timing.bytes_bound_ms(n_bytes), **attrs}
    row["share"] = row["bytes_bound_ms"] / ms if cuda else None
    row["gb_per_s"] = n_bytes / ms / 1e6 if cuda else None
    return row


def run_rle_expand_rm(device="cuda", frames: int = 16, side: int = 2048,
                      runs: int = 4, reps: int = 8,
                      output: Optional[str] = None, seed: int = 0) -> Dict:
    """The four copies on the luma stream of ``frames`` frames of side²,
    then the einsum A/B; returns the result and writes it to ``output`` if
    given."""
    dev = bench_device(device)
    rng = np.random.default_rng(seed)
    bw = side // 8
    rows = frames * bw * bw
    bh = rows // bw
    p = torch.from_numpy(rx.stream_values(rows, K, rng)).to(dev)
    wide = p.view(rows // 2, 2 * K)
    n_bytes = rx.stream_bytes(p)
    rm_attrs = rx.copy_attributes(rx.COPY_RM, dev)
    t_attrs = rx.copy_attributes(rx.COPY_T, dev)
    sink = torch.empty_like(p)
    copies = [
        copy_row(f"copy row-major ({rows}, {K})", "profile_rle_expand_rm.py:64",
                 rx.copy_rm, rx.copy_rm, rx.copy_rm_ref,
                 lambda x: sink.copy_(x), "Tensor.copy_", p, n_bytes,
                 rm_attrs, dev, runs, reps),
        copy_row(f"copy row-major WIDE ({rows // 2}, {2 * K}) view",
                 "profile_rle_expand_rm.py:95", rx.copy_rm, rx.copy_rm,
                 rx.copy_rm_ref, lambda x: sink.view(x.shape).copy_(x),
                 "Tensor.copy_", wide, n_bytes, rm_attrs, dev, runs, reps),
        copy_row(f"copy transposed contiguous ({K}, {rows})",
                 "profile_rle_expand_rm.py:67", rx.copy_t_contig,
                 rx.copy_t_contig, rx.copy_t_contig_ref, None,
                 "p.t().contiguous()", p, n_bytes, t_attrs, dev, runs, reps),
        copy_row(f"copy transposed slabs ({bh}, {K}, {bw}) (K7's layout)",
                 "profile_rle_expand_rm.py:72",
                 lambda x: rx.copy_t_slab(x, bw), rx.copy_t_slab,
                 lambda x: rx.copy_t_slab_ref(x, bw), None,
                 "p.view(bh, bw, K).transpose(1, 2).contiguous()", p, n_bytes,
                 t_attrs, dev, runs, reps),
    ]
    del p, wide, sink

    # (b) the einsum orientations, on the probe's operand.
    mi = rx.luma_inverse_basis(dev)
    z_kt = torch.from_numpy(
        rng.integers(-40, 40, size=(bh, 64, bw)).astype(np.float32)).to(dev)
    z_rm = z_kt.transpose(1, 2).contiguous()
    a = rx.inverse_einsum(z_kt, mi, "kt")
    b = rx.inverse_einsum(z_rm, mi, "rm")
    diff = (a.to(torch.int16) - b.to(torch.int16)).abs()
    key = timing.timer_key(dev)
    einsum = {
        "shape": [bh, 64, bw],
        "agree": bool(torch.equal(a, b)),
        "max_abs_diff": int(diff.max()),
        "differing_share": float((diff != 0).float().mean()),
        f"kt_{key}": timing.time_ms(lambda z: rx.inverse_einsum(z, mi, "kt"),
                                    z_kt, dev, reps=reps, runs=runs),
        f"rm_{key}": timing.time_ms(lambda z: rx.inverse_einsum(z, mi, "rm"),
                                    z_rm, dev, reps=reps, runs=runs),
    }
    del a, b, diff, z_kt, z_rm

    where = device_record(dev)
    t = [r[key] for r in copies]
    verdict = (f"on {where.get('card', dev)}: the contiguous transpose takes "
               f"{t[2] / t[0]:.2f}x the row-major copy, the slab transpose "
               f"{t[3] / t[0]:.2f}x, the wide view {t[1] / t[0]:.2f}x; the "
               f"row-major einsum takes {einsum[f'rm_{key}'] / einsum[f'kt_{key}']:.2f}x "
               f"the KT one, orientations "
               f"{'agree' if einsum['agree'] else 'differ'}")
    for r in copies:
        print(f"{r['row']:60s} {r[key]:9.4f} ms  plain {r[f'plain_{key}']:9.4f}"
              f"  library {r[f'library_{key}']:9.4f}"
              + ("" if r["share"] is None else
                 f"  {r['share']:.1%} of {r['bytes_bound_ms']:.4f}  "
                 f"{r['gb_per_s']:7.1f} GB/s rd+wr  regs {r['registers']}  "
                 f"smem {r['shared_bytes']}  ctas/SM {r['ctas_per_sm']}"),
              flush=True)
    print(f"einsum orientations agree: {einsum['agree']} (max |d| "
          f"{einsum['max_abs_diff']}, share {einsum['differing_share']:.3g}); "
          f"akb {einsum[f'kt_{key}']:.4f} ms, abk {einsum[f'rm_{key}']:.4f} ms",
          flush=True)
    print(f"verdict: {verdict}")
    result = {
        "frames": frames, "side": side, "rows": rows, "K": K, "bw": bw,
        "runs": runs, "reps": reps, "seed": seed, "backend": dev.type,
        "timer": "cuda events" if dev.type == "cuda" else "host clock",
        **where, "copies": copies, "einsum": einsum, "verdict": verdict,
    }
    return timing.write_result(result, output)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4jpeg_tpu_torch.profiles.rle_expand_rm",
        description="Copy and transpose costs of K7's stream, and the "
                    "inverse einsum's orientation A/B.")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--side", type=int, default=2048)
    timing.add_arguments(ap)
    args = ap.parse_args(argv)
    run_rle_expand_rm(args.device, args.frames, args.side, args.runs,
                      args.reps, args.output, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
