"""The sublane RLE at the probe's shapes, and whether packing on the
transposed layout saves the relayout.

Port of ``profiles/profile_sublane_butterfly.py``.  Check: the probe's
(64, 512) run-structured values through ``profiles/sublane_rle.py::
sublane_rle``, identical to its plain version (K4's plain version on the
transposed blocks: the probe's own check against ``rle_encode_packed16``).
Timing at (64, ``cols``) int32 uniform in [-511, 511] (the probe's (64,
2,097,152)): the kernel and its plain version, then the probe's question
answered on Hopper, three ways on the same bytes:

* ``sublane``: this kernel on the (64, B) layout the plane-view einsum
  emits;
* ``k5_kt_view``: K5 (``ops/pack16.py::pack16_encode_kt``) on the same
  bytes viewed as (1, 64, B), the plane (KT) layout of one block row;
* ``transpose_k4``: ``x.t().contiguous()``, the relayout, then K4
  (``pack16_encode``) on the (B, 64) rows;

and the relayout alone.  The three agree: K5's and K4's words are the
sublane words transposed, their lengths twice its run counts.

Times: ``profiles/timing.py`` (best of ``runs`` runs of ``reps`` calls,
queued behind a spin on the card; each kernel run guarded by its wrapper's
launch count).  Bound: the bytes each way must move at the least (values
in, words and counts out) over 3.35 TB/s.  Run on the card from the
repository root (on the CPU add ``--device cpu --cols 1024``)::

    python -m lz4jpeg_tpu_torch.profiles.sublane_butterfly --output b.json
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record
from lz4jpeg_tpu_torch.ops import pack16
from lz4jpeg_tpu_torch.profiles import sublane_rle as sr
from lz4jpeg_tpu_torch.profiles import timing

SEG = 64
CHECK_COLS = 512  # the probe's check width (profile_sublane_butterfly.py:76)


def check_probe(seg: int, cols: int, rng: np.random.Generator,
                dev: torch.device) -> Dict:
    """The probe's run-structured (seg, cols) values through the kernel (a
    CPU tensor: its plain version), held identical to the plain version;
    raises AssertionError otherwise."""
    xs = torch.from_numpy(sr.probe_values(seg, cols, rng)).to(dev)
    before = sr.sublane_rle.launches
    packed, runs = sr.sublane_rle(xs)
    want_p, want_r = sr.sublane_rle_ref(xs)
    if not (torch.equal(packed, want_p) and torch.equal(runs, want_r)):
        raise AssertionError(f"sublane RLE at ({seg}, {cols}): the kernel "
                             "differs from its plain version")
    return {"shape": [seg, cols], "identical": True,
            "launches": sr.sublane_rle.launches - before,
            "mean_runs": float(runs.float().mean())}


def ab_ways() -> Dict:
    """The three ways to pack (SEG, B) values: name → (call, wrapper whose
    count it adds to)."""
    return {
        "sublane": (sr.sublane_rle, sr.sublane_rle),
        "k5_kt_view": (lambda v: pack16.pack16_encode_kt(v.view(1, *v.shape)),
                       pack16.pack16_encode_kt),
        "transpose_k4": (lambda v: pack16.pack16_encode(v.t().contiguous()),
                         pack16.pack16_encode),
    }


def check_ways(x: torch.Tensor) -> None:
    """The three ways give the same runs; raises AssertionError if not."""
    outs = {name: fn(x) for name, (fn, _) in ab_ways().items()}
    packed, runs = outs["sublane"]
    k5_words, k5_lengths = outs["k5_kt_view"]
    k4_words, k4_lengths = outs["transpose_k4"]
    same = (torch.equal(k5_words, packed.t())
            and torch.equal(k4_words, k5_words)
            and torch.equal(k5_lengths, 2 * runs[0])
            and torch.equal(k4_lengths, k5_lengths))
    if not same:
        raise AssertionError("the sublane kernel, K5 on the KT view and "
                             "transpose + K4 disagree")


def run_sublane_butterfly(device="cuda", cols: int = 2_097_152, runs: int = 4,
                          reps: int = 8, output: Optional[str] = None,
                          seed: int = 0) -> Dict:
    """The probe's check, then the kernel, its plain version and the
    three-way A/B at (64, ``cols``); returns the result and writes it to
    ``output`` if given."""
    dev = bench_device(device)
    cuda = dev.type == "cuda"
    key = timing.timer_key(dev)
    rng = np.random.default_rng(seed)
    check = check_probe(SEG, CHECK_COLS, rng, dev)

    x = sr.uniform_values(SEG, cols, dev, seed)
    check_ways(x)
    n_bytes = sr.rle_bytes(SEG, cols)
    bound = timing.bytes_bound_ms(n_bytes)
    ways = []
    for name, (fn, counter) in ab_ways().items():
        before = counter.launches
        ms = timing.time_ms(fn, x, dev, reps=reps, runs=runs,
                            kernel=counter if cuda else None)
        ways.append({"way": name, key: ms,
                     "launches": counter.launches - before,
                     "share": bound / ms if cuda else None})
    kernel_ms = ways[0][key]
    plain_ms = timing.time_ms(sr.sublane_rle_ref, x, dev, reps=reps, runs=runs)
    relayout_ms = timing.time_ms(lambda v: v.t().contiguous(), x, dev,
                                 reps=reps, runs=runs)
    del x

    where = device_record(dev)
    t = {w["way"]: w[key] for w in ways}
    verdict = (f"on {where.get('card', dev)}: packing the (64, B) layout in "
               f"place takes {t['sublane']:.4f} ms against K5 on the KT view "
               f"{t['k5_kt_view']:.4f} ({t['k5_kt_view'] / t['sublane']:.2f}x) "
               f"and transpose + K4 {t['transpose_k4']:.4f} "
               f"({t['transpose_k4'] / t['sublane']:.2f}x; the relayout alone "
               f"{relayout_ms:.4f})")
    attrs = sr.attributes(SEG, 4, dev)
    print(f"check ({SEG}, {CHECK_COLS}) probe values: identical to plain "
          f"(mean runs {check['mean_runs']:.2f})", flush=True)
    for w in ways:
        print(f"{w['way']:14s} ({SEG}, {cols}) int32 {w[key]:9.4f} ms"
              + ("" if w["share"] is None else
                 f"  {w['share']:.1%} of {bound:.4f}"), flush=True)
    print(f"plain {plain_ms:.4f} ms; relayout alone {relayout_ms:.4f} ms; "
          f"regs {attrs['registers']}  smem {attrs['shared_bytes']}  "
          f"ctas/SM {attrs['ctas_per_sm']}", flush=True)
    print(f"verdict: {verdict}")
    result = {
        "seg": SEG, "cols": cols, "dtype": "int32", "runs": runs,
        "reps": reps, "seed": seed, "backend": dev.type,
        "timer": "cuda events" if cuda else "host clock", **where,
        "site": "profile_sublane_butterfly.py:64", "check": check,
        key: kernel_ms, f"plain_{key}": plain_ms,
        f"relayout_{key}": relayout_ms, "bytes": n_bytes,
        "bytes_bound_ms": bound, "share": bound / kernel_ms if cuda else None,
        **attrs, "ways": ways, "verdict": verdict,
    }
    return timing.write_result(result, output)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4jpeg_tpu_torch.profiles.sublane_butterfly",
        description="The sublane RLE kernel at the probe's shapes and its "
                    "A/B against K5 and transpose + K4.")
    ap.add_argument("--cols", type=int, default=2_097_152)
    timing.add_arguments(ap)
    args = ap.parse_args(argv)
    run_sublane_butterfly(args.device, args.cols, args.runs, args.reps,
                          args.output, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
