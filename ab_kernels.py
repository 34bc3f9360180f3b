#!/usr/bin/env python3
"""Time this checkout's kernels in turns with another checkout's, on one
CUDA card.

    python3 ab_kernels.py --other DIR [--only megakernel|inverse|lz4_parse]

DIR is the root of another checkout of this repository, for example an
earlier commit unpacked into a git-ignored directory with
``git archive <commit> | tar -x -C DIR``.  Each checkout builds its kernels
from its own sources into its own ``lz4jpeg_tpu_torch/_build/`` and is
called through its own wrappers, whose contracts every commit of the port
keeps: ``ops/fwd_megakernel.py::forward_combined`` (K1),
``ops/fused_match.py::match_candidates`` (K2) and, in ``ops/pack16.py``,
``pack16_encode`` (K4), ``pack16_encode_kt`` (K5), ``pack16_decode`` (K6)
and ``pack16_decode_plane`` (K7), and ``ops/stream.py::stream_copy`` (the
copy kernel, P-copy).  The two run in turns, other, this, this, other
(``chip_smoke.py::time_versions``), on phase 4's, phase 8's, phase 12's
and phase 20's shapes: K1 on 2048² uniform noise at batch 64 and 256; K2
on 32 MiB of generated text in 2048 blocks of 16 KiB (stride 1, lcp 4);
K4-K7 on the zigzag values of the luma (K = 64) and Cr chroma (K = 32)
channels of 64 such frames, K4 in int16 and int32; the copy kernel on
512 MiB of u8 as (rows, 2048), with ``Tensor.copy_`` of the same bytes,
the library call, timed in the same turns.  K1's, K2's, K4-K7's and the
copy's outputs must be identical.  Before K1: each checkout's K1 and KT
product builds (registers, ptxas's spill bytes, shared memory, CTAs an SM,
consumer groups, and their band loop's warp instructions a tile in the
SASS by warp role, by ``profiles/megakernel.py::band_sass_counts``, the
toolkit's); after it, in ``time_ms``'s protocol below, the megakernel's
probe rows (``PROBE_ROWS``: P-abl's full row, K1's instantiation in the
probe library, and its chunk sweep's band rows, T = 128, 16 and 32, on 32
frames of 2048² noise; P-kt's kt_split_runs, P-t's
kt_basis_a and P-v2's product and copy rows on its ``rgb_to_kt``) through
each checkout's ``profiles/megakernel.py::megakernel_variant``, outputs
identical, each product row with the issue floor of
each checkout's SASS count; ``--only megakernel`` stops there.  Then K9,
the sparse16 decode, through each checkout's
``ops/inv_megakernel.py::inverse_combined`` in the same turns as K1, on
phase 29's 2048² noise (K1's buffer) at batch 64 and 256 and on a
quality-100 buffer at batch 64, outputs identical between the checkouts,
with each build's registers, shared memory, CTAs an SM and ptxas's spill
bytes, and the bound of the part products this checkout's warps issue
(``--only inverse`` runs this alone, loading only K1 and K9).  Then the
probe kernels
of ``profiles/casts.py::cast`` (P-cast, the seven pairs at 134,217,728
random source words, ``casts.run_casts``' size) and
``profiles/dct_gates.py::basis_dot`` (P-dot, 2,097,152 × 64 pixels and the
luma basis), each with its library call (``x.to(dst)``;
``torch.matmul(x, m.T)`` with TF32 off), by ``profiles/timing.py::
time_ms`` (best of 4 runs of 8 calls, queued behind a spin, so that the
host's issue of a call drops out) in turns: other, this, library,
library, this, other.  The casts' outputs must equal ``x.to``'s (NaN as
NaN), the basis product's must be bit-identical between the two
checkouts (both sum k in order from 0).  Then, in the same protocol, the
matcher sort of ``profiles/bitonic_sort.py::bitonic_sort_blocks`` (P-sort,
both variants, on 2,048 of the probe's blocks) with ``torch.sort`` of the
keys and ``torch.sort`` + ``torch.gather`` as the library calls, and the
membership decode of ``profiles/rle_decode.py::rle_decode_membership``
(P-memb, the luma words of 64 frames of 2048²) with this checkout's K6 and
K8; the sorts' outputs and the decodes' must be identical between the
checkouts (and the sort's to ``torch.sort`` + ``torch.gather``, the
decode's to K6 and K8), and their share is of the issue bound where that
is the larger.  Then, in the same protocol, the fused MCU transforms of
``profiles/mcu.py`` (P-mcu-f, P-mcu-i) on the candidate A/B's 2,097,152
random luma tiles and their quantized coefficients, and P-mcu-i also on
those coefficients plus a uniform fraction (all nine part products), with
cuBLAS fp32 of the bare product (TF32 off) as the library call; the
outputs of the two checkouts, and the library's through the plain
versions' epilogues, held to each other by
``utils/parity.py::transform_flips`` (at most 1e-5 of the outputs, each
count printed).  Then, in the same protocol, the probe's stage kernels
of ``profiles/bucket_partition.py`` (P-conc, ``concentration_stages``,
and P-cex, ``compare_exchange_stages``, the control) on 2,048 of the
probe's blocks, the outputs identical between the checkouts, each share
taken of the issue floor at ``INSTRUCTIONS`` lane instructions per
stage-element and of each checkout's own floor at the count of its SASS
loop (``bucket_partition.stage_sass_counts``, which needs the toolkit).
Then LZ4's greedy parses through each checkout's wrappers: K10 by
``ops/fused_match.py::parse_candidates`` on this checkout's K2 words of
phase 8's 2048 blocks of 16 KiB (stride 1, lcp 4), and the fused matcher
``fast_match_blocks_fused`` (K2 and the parse) on the same blocks, in
``time_versions``' turns; K11 by the checkout's parity matcher
(``ops/lz4_parse.py::parity_parse`` where the checkout has it, else
``greedy_parse(*match_tables(x))`` of ``ops/match.py``) on phase 17's
76,500 B of text (255 blocks of 300 B) and on 30 blocks of 1,024 B, in
``ab_queued``'s turns; outputs identical between the checkouts (``--only
lz4_parse`` runs this alone).
Prints the card's name and power limit, each block of runs, and one line
per kernel and shape with both times, the ratio, the bound and its share.
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PACKAGE = "lz4jpeg_tpu_torch"
CAST_ELEMENTS = 64 * 2_097_152  # profiles/casts.py::run_casts' elements
DOT_ROWS = 2_097_152  # profiles/dct_gates.py::run_dct_gates' rows
SORT_BLOCKS = 2048  # profiles/bitonic_sort.py::run_bitonic_sort's blocks
MCU_TILES = 2 * 1024 * 1024  # profiles/candidates_ab.py's luma tiles
STAGE_BLOCKS = 2048  # profiles/bucket_partition.py's larger size
PROBE_ROWS = (  # (the row of PERF.md's table, variant)
    ("P-abl full", "full"),
    ("P-abl band_128", "band_128"),
    ("P-abl band_16", "band_16"),
    ("P-abl band_32", "band_32"),
    ("P-kt kt_split_runs", "kt_split_runs"),
    ("P-v2 kt_full_32", "kt_full_32"),
    ("P-v2/P-t kt_full", "kt_full"),
    ("P-v2 kt_full_128", "kt_full_128"),
    ("P-v2 kt_dct", "kt_dct"),
    ("P-t kt_basis_a", "kt_basis_a"),
    ("P-v2 kt_copy_32", "kt_copy_32"),
    ("P-v2 kt_copy", "kt_copy"),
    ("P-v2 kt_copy_128", "kt_copy_128"),
)


MODULES = ("ops.fwd_megakernel", "ops.fused_match", "ops.pack16",
           "ops.stream", "profiles.casts", "profiles.dct_gates",
           "profiles.bitonic_sort", "profiles.rle_decode", "profiles.mcu",
           "profiles.bucket_partition", "profiles.megakernel",
           "profiles.sass_loops", "ops.inv_megakernel", "ops.match")
INVERSE_MODULES = ("ops.fwd_megakernel", "ops.inv_megakernel",
                   "profiles.sass_loops")
LZ4_PARSE_MODULES = ("ops.fused_match", "ops.match")
PARITY_SHAPES = ((76_500, 300), (30_000, 1024))  # chip_smoke.py phase 17's


def load_checkout(root: Path, names=MODULES):
    """The kernel modules ``names`` of the checkout at ``root`` (by default
    fwd_megakernel, fused_match, pack16, stream, and the probes' casts,
    dct_gates, bitonic_sort, rle_decode, mcu, bucket_partition and
    megakernel, sass_loops, inv_megakernel and match), with every kernel built and
    loaded.  Drops any other checkout's modules from ``sys.modules``
    first; the modules stay alive through the returned references."""
    for name in [m for m in sys.modules
                 if m == PACKAGE or m.startswith(PACKAGE + ".")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        mods = [importlib.import_module(f"{PACKAGE}.{name}")
                for name in names]
    finally:
        sys.path.remove(str(root))
    for mod in mods:
        if not Path(mod.__file__).resolve().is_relative_to(root):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, "
                               f"not from {root}")
    for mod in mods:
        if hasattr(mod, "load_kernel"):
            mod.load_kernel()
    if names != MODULES:
        return mods
    (fwd, match, pack16, stream, casts, gates, sort, member, mcu,
     stages, probes, _, _, _) = mods
    pack16.load_pack_kernels()
    pack16.load_expand_kernels()
    return mods


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True, type=Path,
                        help="root of the checkout to time against this one")
    parser.add_argument("--only", choices=("megakernel", "inverse",
                                           "lz4_parse"),
                        help="time K1 and the megakernel's probe rows, K9, "
                        "or K10 and K11, only")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from chip_smoke import (
        COPY_BYTES,
        COPY_COLUMNS,
        K1_FLOP_PER_TILE,
        MAIN_BYTES,
        MAX_FLIP_SHARE,
        SEED,
        SIDE,
        TIME_FRAMES,
        bound,
        check,
        time_versions,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    names = {"inverse": INVERSE_MODULES,
             "lz4_parse": LZ4_PARSE_MODULES}.get(args.only, MODULES)
    other = load_checkout(args.other.resolve(), names)
    this = load_checkout(HERE, names)
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import CHANNEL_SLICES
    from lz4jpeg_tpu_torch.ops.lz4_fast import pad_blocks_fast
    from lz4jpeg_tpu_torch.ops.quantize import (
        CHROMINANCE_QUANTIZATION_TABLE as CHR,
        LUMINANCE_QUANTIZATION_TABLE as LUM,
    )
    from lz4jpeg_tpu_torch.ops.rle import rle_decode_sparse16
    from lz4jpeg_tpu_torch.utils.inputs import generate_text

    def ab(label, fn, inputs, n_bytes, flops=0.0, identical=True,
           library=None):
        """Times ``fn(modules, inputs)`` of the other checkout and of this
        one in turns, and ``library(inputs)`` with them if given; prints the
        times, their ratio, and the bound with this checkout's share of
        it."""
        fns = {"other": lambda a: fn(other, a), "this": lambda a: fn(this, a)}
        if library is not None:
            fns["library"] = library
        t = time_versions(label, fns, inputs, identical=identical)
        b = bound(n_bytes, flops)
        lib = "" if library is None else f", library {t['library']:.4f} ms"
        print(f"{label}: this {t['this']:.4f} ms, other {t['other']:.4f} ms "
              f"({t['other'] / t['this']:.2f}x this){lib}; bound {b[0]:.4f} "
              f"ms ({b[1]}), this {b[0] / t['this']:.1%} of it")

    def ab_queued(label, fns, inputs, n_bytes, same, issue_ms=None):
        """Each of ``fns`` (other, this, then the library calls and other
        references) on ``inputs`` once, the outputs held by ``same(name,
        out, this_out)``, then each timed by ``timing.time_ms`` in turns:
        other, this, the rest, the rest reversed, this, other; prints both
        times of each and its ratio to this, and the share of the bytes
        bound or, if larger, of ``issue_ms``; returns each one's mean."""
        outs = {name: fn(inputs) for name, fn in fns.items()}
        torch.cuda.synchronize()
        for name, out in outs.items():
            check(same(name, out, outs["this"]), f"{label}: {name} differs")
        del outs
        t = {}
        for name in [*fns, *reversed(list(fns))]:
            t.setdefault(name, []).append(timing.time_ms(fns[name], inputs, dev))
            print(f"{label} {name}: {t[name][-1]:.4f} ms", flush=True)
        b, by = bound(n_bytes)[0], "bytes"
        if issue_ms is not None and issue_ms > b:
            b, by = issue_ms, "issue"
        mean = {k: sum(v) / 2 for k, v in t.items()}
        print(f"{label}: this {t['this'][0]:.4f}, {t['this'][1]:.4f} ms; "
              + "; ".join(f"{k} {v[0]:.4f}, {v[1]:.4f} "
                          f"({mean[k] / mean['this']:.3f}x this)"
                          for k, v in t.items() if k != "this")
              + f"; bound {b:.4f} ms ({by}), this {b / mean['this']:.1%} "
              f"of it")
        return mean

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    from lz4jpeg_tpu_torch.profiles import timing

    def inverse_ab():
        """K9 through each checkout's ``inverse_combined`` in turns, on K1's
        buffer of 2048² noise at b64 and b256 and at quality 100 (b64), the
        outputs identical; each build's resources."""
        from lz4jpeg_tpu_torch.models.jpeg import scaled_tables

        def inv(mods):
            return next(m for m in mods
                        if m.__name__.endswith(".ops.inv_megakernel"))

        def fwd(mods):
            return next(m for m in mods
                        if m.__name__.endswith(".ops.fwd_megakernel"))

        loops = next(m for m in this
                     if m.__name__.endswith(".profiles.sass_loops"))
        for side, mods, root in (("other", other, args.other.resolve()),
                                 ("this", this, HERE)):
            attrs = inv(mods).kernel_attributes(dev)
            use = loops.ptxas_usage("inv_megakernel", root)
            print(f"K9 {side}: {attrs['registers']} registers, "
                  f"{attrs['shared_bytes']} B shared memory, "
                  f"{attrs['ctas_per_sm']} CTAs an SM, "
                  f"{sum(u['spill_stores'] for u in use.values())} B spill "
                  f"stores", flush=True)
        nb = SIDE // 8
        for quality, batches in ((None, (64, 256)), (100, (64,))):
            tables = scaled_tables(quality)
            x = torch.randint(0, 256, (64, SIDE, SIDE, 3), dtype=torch.uint8,
                              device=dev, generator=gen)
            comb = fwd(this).forward_combined(
                x, tables["lum"], tables["r"]).reshape(64, -1, 128)
            del x
            for batch in batches:
                big = comb.repeat(batch // 64, 1, 1)
                label = (f"K9 {SIDE}x{SIDE} b{batch}"
                         + ("" if quality is None else f" quality {quality}"))
                check(torch.equal(
                    inv(this).inverse_combined(big, tables, nb, nb, SIDE, SIDE),
                    inv(other).inverse_combined(big, tables, nb, nb, SIDE,
                                                SIDE)),
                      f"{label}: the checkouts' outputs differ")
                ab(label, lambda m, a: inv(m).inverse_combined(
                    a, tables, nb, nb, SIDE, SIDE), big,
                   big.numel() * 2 + batch * SIDE * SIDE * 3,
                   inv(this).part_products(big, nb, nb))
                del big
            del comb
            torch.cuda.empty_cache()

    def lz4_parse_ab():
        """K10 and K11 through each checkout's wrappers in turns, outputs
        identical between the checkouts."""
        from lz4jpeg_tpu_torch.ops.match import pad_blocks

        def mod(mods, suffix):
            return next(m for m in mods if m.__name__.endswith(suffix))

        def parity(mods):
            """The checkout's parity matcher: K11 where it has one."""
            scope = mod(mods, ".ops.fused_match").parse_candidates.__globals__
            if "parity_parse" in scope:
                return scope["parity_parse"]
            match = mod(mods, ".ops.match")
            return lambda x: match.greedy_parse(*match.match_tables(x))

        text = generate_text(MAIN_BYTES, np.random.default_rng(SEED))
        padded, lengths = pad_blocks_fast(text)
        blocks = torch.from_numpy(padded.astype(np.uint8)).to(dev)
        lens = torch.from_numpy(lengths).to(dev)
        b, p = blocks.shape
        packed = mod(this, ".ops.fused_match").match_candidates(blocks, lens, 1, 4)
        fields = [m.parse_candidates(packed, lens, p)
                  for m in (mod(other, ".ops.fused_match"),
                            mod(this, ".ops.fused_match"))]
        check(all(torch.equal(x, y) for x, y in zip(*fields)),
              "K10: the checkouts' fields differ")
        del fields
        ab(f"K10 {b}x16KiB stride 1 lcp 4",
           lambda m, a: mod(m, ".ops.fused_match").parse_candidates(
               a[0], a[1], p), (packed, lens), packed.numel() * 4 + b * 4
           + 3 * b * p * 4)
        ab(f"K2 + K10 (fast_match_blocks_fused) {b}x16KiB stride 1 lcp 4",
           lambda m, a: mod(m, ".ops.fused_match").fast_match_blocks_fused(
               a[0], a[1], lcp_words=4), (blocks, lens),
           blocks.numel() + b * 4 + 3 * b * p * 4)
        del packed, blocks, lens
        for n, block_length in PARITY_SHAPES:
            pb, _ = pad_blocks(text[:n], block_length)
            x = torch.from_numpy(pb).to(dev)
            ab_queued(f"K11 parity {n} B ({pb.shape[0]} x {block_length})",
                      {"other": parity(other), "this": parity(this)}, x,
                      x.numel() * (4 + 1 + 4 + 4),
                      lambda _, a, c: all(torch.equal(u, v)
                                          for u, v in zip(a, c)))
        torch.cuda.empty_cache()

    if args.only == "inverse":
        inverse_ab()
        return 0
    if args.only == "lz4_parse":
        lz4_parse_ab()
        return 0

    # Each checkout's K1 and KT product builds: warp instructions a tile in
    # their SASS (by warp role), registers and spill bytes (ptxas), from the
    # toolkit; shared memory and CTAs an SM from the card.
    roots = {"other": args.other.resolve(), "this": HERE}
    mk, loops = this[10], this[11]
    with ThreadPoolExecutor(6) as pool:  # nvcc runs beside nvcc
        jobs = {(side, what): pool.submit(fn, root)
                for side, root in roots.items()
                for what, fn in (
                    ("sass", mk.band_sass_counts),
                    ("k1", lambda r: loops.ptxas_usage("fwd_megakernel", r)),
                    ("probes",
                     lambda r: loops.ptxas_usage("fwd_probe_kernel", r)))}
        built = {key: job.result() for key, job in jobs.items()}
    sass = {side: built[side, "sass"] for side in roots}
    usage = {side: mk.probe_ptxas(root, built[side, "probes"])
             for side, root in roots.items()}
    for side, mods in (("other", other), ("this", this)):
        k1, probes = built[side, "k1"], built[side, "probes"]
        attrs = mods[10].variant_attributes("full", dev)
        print(f"K1 {side}: {attrs['registers']} registers, "
              f"{attrs['shared_bytes']} B shared memory, "
              f"{attrs['ctas_per_sm']} CTAs an SM, "
              f"{max(u['spill_stores'] for u in k1.values())} spill bytes "
              f"(every probe variant: "
              f"{sum(u['spill_stores'] for u in probes.values())}); band loop "
              f"{sass[side]['k1']['segments']} warp instructions a warp "
              f"between barriers, producer {sass[side]['k1']['producer']}")
        for name in mk.KT_PRODUCTS:
            u, c = usage[side][name], sass[side][name]
            attrs = mods[10].variant_attributes(name, dev)
            roles = ", ".join(f"{role} {r['count']} x {r['warps']}"
                              for role, r in c.items() if isinstance(r, dict))
            print(f"{name} {side}: {c['groups']} groups, {u['registers']} "
                  f"registers, {u['spill_stores']} B spill stores, "
                  f"{attrs['shared_bytes']} B shared memory, "
                  f"{attrs['ctas_per_sm']} CTAs an SM; {c['per_tile']:.2f} "
                  f"warp instructions a tile (a band: {roles})")
    for batch in (64, 256):
        x = torch.randint(0, 256, (batch, 2048, 2048, 3), dtype=torch.uint8,
                          device=dev, generator=gen)
        tiles = batch * 256 * 256
        out = this[0].forward_combined(x, LUM, CHR)
        check(torch.equal(out, other[0].forward_combined(x, LUM, CHR)),
              f"K1 b{batch}: the checkouts' outputs differ")
        if batch == 64:
            comb = out  # phase 12's values for K4-K7
        del out
        ab(f"K1 2048x2048 b{batch}",
           lambda m, x: m[0].forward_combined(x, LUM, CHR), x,
           x.numel() + tiles * 128 * 2, tiles * K1_FLOP_PER_TILE)
        for side, count in sass.items():
            floor = timing.issue_bound_ms(
                32 * count["k1"]["per_tile"] * tiles, dev)
            print(f"K1 b{batch} {side}: {count['k1']['per_tile']:.2f} warp "
                  f"instructions a tile in its SASS, issue floor "
                  f"{floor:.4f} ms")
        del x

    # The megakernel's probe rows on 32 frames of 2048² (P-abl's full row,
    # K1's instantiation in the probe library) and on their KT layout
    # (P-kt, P-t's basis-A row, P-v2's product and copy rows), in turns,
    # outputs identical between the checkouts; the floor at each
    # checkout's own SASS count.
    x = torch.randint(0, 256, (32, 2048, 2048, 3), dtype=torch.uint8,
                      device=dev, generator=gen)
    probe_inputs = {"rgb": x, "kt": this[0].rgb_to_kt(x)}
    tiles = 32 * 256 * 256

    def probe_same(_, a, b):
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        return all(torch.equal(p, q) for p, q in zip(a, b))

    for label, name in PROBE_ROWS:
        key = "k1" if name == "full" else name
        mean = ab_queued(
            f"{label} 32x2048x2048",
            {"other": lambda a: other[10].megakernel_variant(a, name, LUM, CHR),
             "this": lambda a: this[10].megakernel_variant(a, name, LUM, CHR)},
            probe_inputs[mk.BY_NAME[name].input],
            mk.variant_bytes(name, tiles), probe_same)
        if key not in sass["this"]:
            continue
        for side, mods in (("other", other), ("this", this)):
            floor = timing.issue_bound_ms(
                32 * sass[side][key]["per_tile"] * tiles, dev)
            attrs = mods[10].variant_attributes(name, dev)
            build = ""
            if name in usage[side]:
                build = (f"{sass[side][key]['groups']} groups, "
                         f"{usage[side][name]['spill_stores']} B spill "
                         "stores, ")
            print(f"{label} {side}: {build}{attrs['registers']} registers, "
                  f"{attrs['shared_bytes']} B shared memory, "
                  f"{attrs['ctas_per_sm']} CTAs an SM; "
                  f"{sass[side][key]['per_tile']:.2f} warp instructions a "
                  f"tile, issue floor {floor:.4f} ms, "
                  f"{floor / mean[side]:.1%} of it")
    del x, probe_inputs
    if args.only == "megakernel":
        return 0
    inverse_ab()

    # K4-K7 on phase 12's values: luma and Cr chroma of the b64 frames.
    bw = SIDE // 8
    for channel, c in (("luma", "lum"), ("chroma", "r")):
        sl = CHANNEL_SLICES[c]
        k = sl.stop - sl.start
        vals = rle_decode_sparse16(comb[:, sl]).to(torch.int16)
        n = vals.shape[0]
        shape = f"{channel} {SIDE}x{SIDE} b{TIME_FRAMES} ({n}x{k})"
        for dtype, size in ((torch.int16, 2), (torch.int32, 4)):
            ab(f"K4 {shape} {str(dtype)[6:]}",
               lambda m, a: m[2].pack16_encode(a), vals.to(dtype),
               n * k * (size + 2) + n * 4)
        words, lens = this[2].pack16_encode(vals)
        if channel == "luma":
            kt = vals.reshape(-1, bw, k).transpose(1, 2).contiguous()
            ab(f"K5 {shape}", lambda m, a: m[2].pack16_encode_kt(a), kt,
               n * k * 4 + n * 4)
            del kt
            ab(f"K6 {shape}", lambda m, a: m[2].pack16_decode(*a, k),
               (words, lens), n * k * 6 + n * 4)
        ab(f"K7 {shape}", lambda m, a: m[2].pack16_decode_plane(*a, bw),
           (words, lens), n * k * 4 + n * 4)
        del vals, words, lens
    del comb

    padded, lengths = pad_blocks_fast(
        generate_text(MAIN_BYTES, np.random.default_rng(SEED)))
    blocks = torch.from_numpy(padded.astype(np.uint8)).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    ab("K2 2048x16KiB stride 1 lcp 4",
       lambda m, a: m[1].match_candidates(a[0], a[1], 1, 4), (blocks, lens),
       blocks.numel() + lens.numel() * 4 + blocks.numel() * 4)
    del padded, blocks, lens

    x = torch.randint(0, 100, (COPY_BYTES // COPY_COLUMNS, COPY_COLUMNS),
                      generator=gen, device=dev, dtype=torch.uint8)
    sink = torch.empty_like(x)
    ab(f"copy {COPY_BYTES >> 20} MiB u8", lambda m, a: m[3].stream_copy(a), x,
       2 * x.numel(), library=lambda a: sink.copy_(a))
    del x, sink

    casts = this[4]
    for pair, (src, dst) in enumerate(casts.PAIRS):
        x = casts.random_values(src, CAST_ELEMENTS, dev, SEED + pair)
        ab_queued(f"P-cast {casts.pair_name(pair)} {CAST_ELEMENTS}",
                  {"other": lambda a: other[4].cast(a, dst),
                   "this": lambda a: this[4].cast(a, dst),
                   "library": lambda a: a.to(dst)}, x,
                  casts.cast_bytes(pair, CAST_ELEMENTS),
                  lambda name, a, b: casts.same(a, b))
        del x
    gates = this[5]
    m = gates.luma_basis(dev)
    x = gates.device_pixels((DOT_ROWS, gates.DEPTH), dev, SEED)

    def bits_of(name, a, b):
        if name == "library":  # cuBLAS: within the bound of float64
            return gates.dot_error(a, x, m)["within"]
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    ab_queued(f"P-dot ({DOT_ROWS}, 64) x (64, 64)",
              {"other": lambda a: other[5].basis_dot(a, m),
               "this": lambda a: this[5].basis_dot(a, m),
               "library": lambda a: a @ m.t()}, x,
              (2 * DOT_ROWS * gates.DEPTH + gates.DEPTH ** 2) * 4, bits_of)
    del x

    # P-sort: the probe's 2,048 blocks, both variants, with torch.sort of the
    # keys and torch.sort + torch.gather (the probe's keys are unique).
    bs = this[6]
    k_np, p_np = bs.probe_blocks(SORT_BLOCKS, SEED)
    blocks = (torch.from_numpy(k_np).to(dev), torch.from_numpy(p_np).to(dev))
    del k_np, p_np
    bounds = bs.sort_bounds(SORT_BLOCKS, dev)
    for record in (False, True):
        def sort_same(name, out, mine):
            if name == "torch.sort":
                return torch.equal(out[0], mine[0])
            if name == "torch.sort + gather" and record:
                return torch.equal(out[0], mine[0])
            return torch.equal(out[0], mine[0]) and torch.equal(out[1], mine[1])

        ab_queued(f"P-sort {SORT_BLOCKS} blocks record_masks={record}",
                  {"other": lambda a: other[6].bitonic_sort_blocks(*a, record),
                   "this": lambda a: this[6].bitonic_sort_blocks(*a, record),
                   "torch.sort": lambda a: torch.sort(a[0], dim=1, stable=True),
                   "torch.sort + gather": lambda a: bs.sort_gather(*a)},
                  blocks, 4 * 4 * bs.SLOTS * SORT_BLOCKS, sort_same,
                  bounds["replay_issue_bound_ms" if record else "issue_bound_ms"])
        got = this[6].bitonic_sort_blocks(*blocks, record)
        want = bs.sort_gather(*blocks)
        check(torch.equal(got[0], want[0]) and torch.equal(
            got[1], blocks[1] if record else want[1]),
              f"P-sort record_masks={record}: not torch.sort + gather")
    del blocks, got, want

    # P-memb: the luma words of 64 frames of 2048², with K6 and K8 (this
    # checkout's) in the same turns.
    rd = this[7]
    words, lens = rd.luma_words(TIME_FRAMES, SIDE, dev, SEED)
    n, seg = words.shape
    ab_queued(f"P-memb {n}x{seg}",
              {"other": lambda a: other[7].rle_decode_membership(*a, seg),
               "this": lambda a: this[7].rle_decode_membership(*a, seg),
               "K6": lambda a: this[2].pack16_decode(*a, seg),
               "K8": lambda a: this[2].pack16_decode_wide(*a)},
              (words, lens), n * seg * 2 + n * 4 + n * seg * 4,
              lambda name, a, b: torch.equal(a.to(torch.int32), b),
              timing.issue_bound_ms(rd.MEMBERSHIP_INSTRUCTIONS
                                    * rd.membership_pairs(lens, seg, seg), dev))
    del words, lens

    # P-mcu-f and P-mcu-i: the candidate A/B's luma tiles, the inverse on
    # their coefficients and on those plus a fraction; cuBLAS fp32 of the
    # bare product, its output through the plain version's epilogue.
    from lz4jpeg_tpu_torch.ops.color import _snap_trunc
    from lz4jpeg_tpu_torch.ops.fused import _round_clamp, _table_key
    from lz4jpeg_tpu_torch.utils.parity import transform_flips

    mcu = this[8]
    key = _table_key(LUM)
    _, m, off = mcu._forward_basis_on(8, 8, key, dev)
    _, minv = mcu._inverse_basis_on(8, 8, key, dev)
    tiles = torch.randint(0, 256, (MCU_TILES, 8, 8), generator=gen,
                          device=dev, dtype=torch.uint8)
    pixels = tiles.reshape(MCU_TILES, 64).float()
    zz = mcu.fused_forward_candidate_ref(tiles, LUM, 8, 8)
    frac = zz + torch.rand(zz.shape, generator=gen, device=dev) - 0.5
    n_bytes = MCU_TILES * (64 + 4 * 64)

    def flips(kind, x):
        def same(name, out, mine):
            if name == "library":
                out = (_snap_trunc(out - off, 1e-5) if kind == "forward"
                       else _round_clamp(out + 128.0).reshape(mine.shape))
            count = transform_flips(kind, x, out, mine, LUM, 8, 8)
            print(f"P-mcu {kind}: {name} against this: {count} flips in "
                  f"{mine.numel()} outputs")
            return count <= MAX_FLIP_SHARE * mine.numel()
        return same

    with timing.no_tf32():
        ab_queued(f"P-mcu-f {MCU_TILES}x64",
                  {"other": lambda a: other[8].fused_forward_candidate(
                       a, LUM, 8, 8),
                   "this": lambda a: this[8].fused_forward_candidate(
                       a, LUM, 8, 8),
                   "library": lambda a: pixels @ m.t()},
                  tiles, n_bytes, flips("forward", tiles))
        del pixels
        for label, z in (("", zz), (" fractions", frac)):
            ab_queued(f"P-mcu-i {MCU_TILES}x64{label}",
                      {"other": lambda a: other[8].fused_inverse_candidate(
                           a, LUM, 8, 8),
                       "this": lambda a: this[8].fused_inverse_candidate(
                           a, LUM, 8, 8),
                       "library": lambda a: a @ minv.t()},
                      z, n_bytes, flips("inverse", z))

    # P-conc and P-cex: the probe's 2,048 blocks, P-cex timed beside P-conc
    # as a control.  Each checkout's time against the floor of its own SASS
    # loop.
    bp = this[9]
    x = bp.probe_tiles(STAGE_BLOCKS, SEED).to(dev)
    elements = bp.STAGES * x.numel()
    counts = {"other": bp.stage_sass_counts(args.other.resolve()),
              "this": bp.stage_sass_counts(HERE)}
    for label, name in (("P-conc", "concentration_stages"),
                        ("P-cex", "compare_exchange_stages")):
        kind = bp.KERNELS[name][0]
        mean = ab_queued(
            f"{label} {STAGE_BLOCKS} blocks",
            {"other": lambda a: other[9].KERNELS[name][1](a),
             "this": lambda a: this[9].KERNELS[name][1](a)},
            x, 2 * 4 * x.numel(), lambda _, a, b: torch.equal(a, b),
            timing.issue_bound_ms(bp.INSTRUCTIONS[kind] * elements, dev))
        for side in ("other", "this"):
            floor = timing.issue_bound_ms(counts[side][kind] * elements, dev)
            print(f"{label} {side}: {counts[side][kind]:.4f} lane "
                  f"instructions per stage-element in its SASS loop, floor "
                  f"{floor:.4f} ms, {floor / mean[side]:.1%} of it")
    lz4_parse_ab()
    return 0


if __name__ == "__main__":
    sys.exit(main())
