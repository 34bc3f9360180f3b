"""Command-line interface of the PyTorch port.

Port of ``lz4jpeg_tpu/cli.py``: the same subcommands and flags, plus
``--device`` (default ``cuda``; without a card it raises, as the codecs
do) wherever a codec runs, and ``device`` for the JAX CLI's ``tpu`` engine:

    python -m lz4jpeg_tpu_torch lz4 encode IN OUT [--mode ...] [--hexdump HEX]
    python -m lz4jpeg_tpu_torch lz4 decode IN OUT [--text]
    python -m lz4jpeg_tpu_torch lz4 inspect IN
    python -m lz4jpeg_tpu_torch jpeg encode IN.png OUT.tjpg [...]
    python -m lz4jpeg_tpu_torch jpeg decode IN.tjpg OUT.png
    python -m lz4jpeg_tpu_torch jpeg roundtrip IN.png OUT.png [--visualize DIR] [--mse]
    python -m lz4jpeg_tpu_torch lzw {encode,decode} IN OUT
    python -m lz4jpeg_tpu_torch bench SUITE [--runs N] [--output F] [--device D]

``bench`` runs the suites of ``lz4jpeg_tpu_torch/bench/`` on ``--device``:
``headline`` (``bench/headline.py``), the sweeps of ``experiments.py``,
``entropy-ab``, ``roofline``/``roofline-inverse``, ``golden`` and
``scaling``.  The ``lz4*`` suites read the reference's corpus and
``golden`` its images (``utils/inputs.py::REFERENCE_ROOT``); without them
they raise ``FileNotFoundError``.
"""

from __future__ import annotations

import argparse
import sys


def _device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="torch device the codec runs on (default cuda; cpu runs the "
        "kernels' plain versions)",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lz4jpeg_tpu_torch",
        description="codec framework on PyTorch (CUDA or CPU)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    lz4 = sub.add_parser("lz4", help="LZ4-style block codec")
    lz4_sub = lz4.add_subparsers(dest="action", required=True)
    enc = lz4_sub.add_parser("encode")
    enc.add_argument("input")
    enc.add_argument("output")
    enc.add_argument("--mode", choices=["parity", "fast"], default="fast")
    enc.add_argument("--block-length", type=int, default=300)
    enc.add_argument("--hexdump", help="also write a hex mirror (compressed.txt)")
    enc.add_argument(
        "--log",
        help="append an encode record + frame structure to this file "
        "(the reference's encoding_log.txt)",
    )
    enc.add_argument(
        "--engine",
        choices=["auto", "native", "python", "device"],
        default="auto",
        help="fast-mode match finder: the device matcher, the native C++ "
        "host encoder, or the Python spec (auto is native)",
    )
    enc.add_argument(
        "--matcher",
        choices=["fused", "sort"],
        default="fused",
        help="device matcher for --engine device: the fused kernel "
        "(default) or the two-sort formulation",
    )
    enc.add_argument(
        "--stride",
        type=int,
        choices=[1, 2, 4],
        default=1,
        help="fused-matcher anchor stride: 2/4 trade compression ratio for "
        "match throughput",
    )
    enc.add_argument(
        "--lcp-words",
        type=int,
        choices=[1, 2, 4],
        default=4,
        help="carried suffix words for lcp verification: 4 (default) is "
        "the best device ratio, 2 trades ratio for throughput",
    )
    _device_flag(enc)
    dec = lz4_sub.add_parser("decode")
    dec.add_argument("input")
    dec.add_argument("output")
    dec.add_argument(
        "--text",
        action="store_true",
        help="render like the reference's uncompressed.txt "
        "(non-printables as 0xNN text)",
    )
    dec.add_argument(
        "--engine",
        choices=["auto", "native", "python", "device"],
        default="auto",
        help="device resolves match chains on the --device (pointer "
        "doubling); native/python decode on the host",
    )
    _device_flag(dec)
    insp = lz4_sub.add_parser("inspect")
    insp.add_argument("input")

    jpeg = sub.add_parser("jpeg", help="JPEG-style image pipeline")
    jpeg_sub = jpeg.add_subparsers(dest="action", required=True)
    for name in ("encode", "decode", "roundtrip"):
        sp = jpeg_sub.add_parser(name)
        sp.add_argument("input")
        sp.add_argument("output")
        if name != "decode":
            sp.add_argument(
                "--precision", choices=["fast", "exact"], default="fast"
            )
            sp.add_argument(
                "--entropy", choices=["shared", "per_block"], default="shared"
            )
            sp.add_argument(
                "--quality", type=int, default=None,
                help="1-100 quant-table scaling (default: reference tables)",
            )
        if name == "roundtrip":
            sp.add_argument(
                "--visualize",
                help="directory for luminance/chroma stage PNGs",
            )
            sp.add_argument(
                "--mse", action="store_true", help="print MSE + PSNR"
            )
        _device_flag(sp)

    lzw = sub.add_parser("lzw", help="LZW codec")
    lzw_sub = lzw.add_subparsers(dest="action", required=True)
    for name in ("encode", "decode"):
        sp = lzw_sub.add_parser(name)
        sp.add_argument("input")
        sp.add_argument("output")

    bench = sub.add_parser("bench", help="benchmark harness")
    bench.add_argument(
        "suite",
        choices=[
            "headline", "lz4", "lz4-device", "lz4-file", "lz4t-decode",
            "jpeg", "jpeg-inverse", "jpeg-perblock", "scaling", "roofline",
            "entropy-ab", "golden", "roofline-inverse",
        ],
        default="headline",
    )
    bench.add_argument("--runs", type=int, default=10)
    bench.add_argument("--output", help="JSON results path")
    _device_flag(bench)
    return p


def _cmd_lz4(args) -> int:
    from lz4jpeg_tpu_torch.config import LZ4Config
    from lz4jpeg_tpu_torch.models.lz4 import LZ4Codec
    from lz4jpeg_tpu_torch.utils.io import dump_to_hex_file, write_text_rendering

    with open(args.input, "rb") as f:
        data = f.read()
    if args.action == "inspect":
        from lz4jpeg_tpu_torch.formats.lz4_frame import describe_frame

        print(describe_frame(data))
        return 0
    if args.action == "encode":
        codec = LZ4Codec(
            LZ4Config(
                mode=args.mode,
                block_length=args.block_length,
                log_path=args.log,
                matcher=args.matcher,
                match_stride=args.stride,
                match_lcp_words=args.lcp_words,
            ),
            device=args.device,
        )
        out = codec.encode(data, engine=args.engine)
        with open(args.output, "wb") as f:
            f.write(out)
        if args.hexdump:
            dump_to_hex_file(args.output, args.hexdump)
        print(f"{len(data)} -> {len(out)} bytes ({len(out)/len(data):.3f})")
    else:
        codec = LZ4Codec(LZ4Config(mode="fast"), device=args.device)
        raw = codec.decode(data, engine=args.engine)
        if args.text:
            write_text_rendering(args.output, raw)
        else:
            with open(args.output, "wb") as f:
                f.write(raw)
        print(f"{len(data)} -> {len(raw)} bytes")
    return 0


def _cmd_jpeg(args) -> int:
    from lz4jpeg_tpu_torch.config import JPEGConfig
    from lz4jpeg_tpu_torch.formats.jpeg_container import (
        pack_container,
        unpack_container,
    )
    from lz4jpeg_tpu_torch.models.jpeg import JPEGPipeline
    from lz4jpeg_tpu_torch.utils.io import read_png, write_png

    if args.action == "decode":
        with open(args.input, "rb") as f:
            enc = unpack_container(f.read())
        pipeline = JPEGPipeline(JPEGConfig(quality=enc.quality), args.device)
        write_png(args.output, pipeline.decode(enc))
        print(f"decoded {enc.width}x{enc.height} -> {args.output}")
        return 0

    # Exact precision is float64 on every torch device: no x64 switch.
    cfg = JPEGConfig(
        precision=args.precision, entropy=args.entropy, quality=args.quality
    )
    pipeline = JPEGPipeline(cfg, args.device)
    rgb = read_png(args.input)

    if args.action == "encode":
        enc = pipeline.encode(rgb)
        blob = pack_container(enc)
        with open(args.output, "wb") as f:
            f.write(blob)
        print(
            f"{rgb.shape[1]}x{rgb.shape[0]} -> {len(blob)} bytes "
            f"({len(blob)/rgb.nbytes:.3f} of raw)"
        )
        return 0

    # roundtrip
    enc = pipeline.encode(rgb)
    rec = pipeline.decode(enc)
    write_png(args.output, rec)
    if args.visualize:
        from lz4jpeg_tpu_torch.oracle.jpeg_oracle import build_ycbcr_planes
        from lz4jpeg_tpu_torch.utils.io import ensure_dir
        from lz4jpeg_tpu_torch.utils.visualize import (
            b_chrominance_image,
            luminance_image,
            r_chrominance_image,
        )

        d = ensure_dir(args.visualize)
        y, cr, cb = build_ycbcr_planes(rgb, snap_ties=True)
        write_png(f"{d}/luminance.png", luminance_image(y))
        write_png(f"{d}/rChrominance.png", r_chrominance_image(cr))
        write_png(f"{d}/bChrominance.png", b_chrominance_image(cb))
    if args.mse:
        from lz4jpeg_tpu_torch.utils.metrics import mse_rgb, psnr

        print(f"MSE: {mse_rgb(rgb, rec):.4f}  PSNR: {psnr(rgb, rec):.2f} dB")
    print(f"roundtrip {rgb.shape[1]}x{rgb.shape[0]} -> {args.output}")
    return 0


def _cmd_lzw(args) -> int:
    from lz4jpeg_tpu_torch.models.lzw import lzw_decode, lzw_encode

    with open(args.input, "rb") as f:
        data = f.read()
    if args.action == "encode":
        out = lzw_encode(data)
        with open(args.output, "w") as f:
            f.write(out)
        print(f"{len(data)} bytes -> {len(out.split())} codes")
    else:
        raw = lzw_decode(data.decode())
        with open(args.output, "wb") as f:
            f.write(raw)
        print(f"-> {len(raw)} bytes")
    return 0


def _cmd_bench(args) -> int:
    runs, output, device = args.runs, args.output, args.device
    if args.suite == "headline":
        from lz4jpeg_tpu_torch.bench.headline import main as headline

        headline(device=device)
        return 0
    if args.suite == "roofline":
        from lz4jpeg_tpu_torch.bench.roofline import run_jpeg_forward_roofline

        run_jpeg_forward_roofline(output=output, device=device)
        return 0
    if args.suite == "roofline-inverse":
        from lz4jpeg_tpu_torch.bench.roofline import run_jpeg_inverse_roofline

        run_jpeg_inverse_roofline(output=output, device=device)
        return 0
    if args.suite == "golden":
        from lz4jpeg_tpu_torch.bench.golden import run_golden_images

        run_golden_images(runs=runs, output=output, device=device)
        return 0
    if args.suite == "entropy-ab":
        from lz4jpeg_tpu_torch.bench.entropy_ab import run_entropy_ab

        run_entropy_ab(runs=runs, output=output, device=device)
        return 0
    if args.suite == "scaling":
        import torch

        from lz4jpeg_tpu_torch.bench.harness import bench_device
        from lz4jpeg_tpu_torch.bench.scaling import jpeg_scaling_sweep

        # Device-count printout, the reference's only runtime report of its
        # parallel resources (Algorithms/parallel/LZ4/LZ4.c:1242-1246).
        dev = bench_device(device)
        count = torch.cuda.device_count() if dev.type == "cuda" else 1
        print(f"devices: {count}")
        jpeg_scaling_sweep(runs=runs, output=output, device=device)
        return 0
    from lz4jpeg_tpu_torch.bench.experiments import (
        run_jpeg_experiment,
        run_jpeg_inverse_device_experiment,
        run_jpeg_perblock_experiment,
        run_lz4_device_experiment,
        run_lz4_experiment,
        run_lz4_file_experiment,
        run_lz4t_decode_device_experiment,
    )

    sweep = {
        "lz4": run_lz4_experiment,
        "lz4-device": run_lz4_device_experiment,
        "lz4-file": run_lz4_file_experiment,
        "lz4t-decode": run_lz4t_decode_device_experiment,
        "jpeg-inverse": run_jpeg_inverse_device_experiment,
        "jpeg-perblock": run_jpeg_perblock_experiment,
        "jpeg": run_jpeg_experiment,
    }[args.suite]
    sweep(runs=runs, output=output, device=device)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "lz4":
        return _cmd_lz4(args)
    if args.command == "jpeg":
        return _cmd_jpeg(args)
    if args.command == "lzw":
        return _cmd_lzw(args)
    return _cmd_bench(args)


if __name__ == "__main__":
    sys.exit(main())
