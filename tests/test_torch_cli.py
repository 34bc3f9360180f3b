"""``python -m lz4jpeg_tpu_torch`` against ``python -m lz4jpeg_tpu`` on the
CPU, and the port's PNG codec against PIL.

* Each subcommand runs in-process through both CLIs on the same input
  (``--device cpu`` for the port; its ``device`` engine where the JAX CLI
  says ``tpu``, with the sort matcher, which is what the JAX CLI runs off a
  TPU).  Written files are byte-equal, except PNGs: the two packages
  compress them differently, so their pixels are compared.  ``jpeg`` runs
  on a 64×48 seeded PNG: containers byte-equal, decoded pixels within the
  fast-path envelope (max |Δ| ≤ 3 on ≤ 2e-3 of the values), the
  ``--visualize`` planes equal.
* ``lz4 inspect`` prints what the JAX CLI prints.
* ``python -m lz4jpeg_tpu_torch`` runs in a subprocess.
* Without ``--device`` the CLI asks for CUDA and raises on a host without
  a card.
* ``utils/io.py``'s PNG codec: files it writes (grey, RGB, RGBA) read back
  through PIL unchanged; PNGs that PIL writes, and PNGs whose rows use each
  of the five filters, read as PIL reads them; other formats raise.
"""

import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from lz4jpeg_tpu.cli import main as jax_main

from lz4jpeg_tpu_torch.cli import main
from lz4jpeg_tpu_torch.utils.inputs import generate_text
from lz4jpeg_tpu_torch.utils.io import PNG_SIGNATURE, read_png, write_png

REPO = Path(__file__).resolve().parent.parent


def _pil_pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _run_both(tmp_path, argv_of, files, capsys, port_extra=("--device", "cpu"),
              jax_extra=()):
    """Run ``argv_of(dir)`` through both CLIs, each writing into its own
    directory; return ({name: (port bytes, jax bytes)}, (port out, jax
    out))."""
    outs = []
    for who, fn, extra in (("port", main, port_extra),
                           ("jax", jax_main, jax_extra)):
        d = tmp_path / who
        d.mkdir(exist_ok=True)
        capsys.readouterr()
        assert fn([*argv_of(d), *extra]) == 0
        outs.append(capsys.readouterr().out)
    got = {f: ((tmp_path / "port" / f).read_bytes(),
               (tmp_path / "jax" / f).read_bytes()) for f in files}
    return got, outs


@pytest.fixture(scope="module")
def text_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("in") / "text.txt"
    path.write_bytes(generate_text(20_000, np.random.default_rng(0)))
    return path


@pytest.mark.parametrize("extra", [
    ("--mode", "parity"),
    ("--mode", "parity", "--block-length", "1024"),
    ("--mode", "fast"),
    ("--mode", "fast", "--engine", "native"),
    ("--mode", "fast", "--engine", "python"),
])
def test_lz4_encode_matches_jax(tmp_path, capsys, text_file, extra):
    def argv(d):
        return ["lz4", "encode", str(text_file), str(d / "out.lz4"),
                "--log", str(d / "log.txt"), "--hexdump", str(d / "hex.txt"),
                *extra]

    files, (out, jax_out) = _run_both(tmp_path, argv,
                                      ("out.lz4", "log.txt", "hex.txt"), capsys)
    for name, (got, want) in files.items():
        assert got == want, name
    assert out == jax_out


@pytest.mark.parametrize("stride,lcp", [(1, 4), (4, 2)])
def test_lz4_encode_device_engine_matches_jax_tpu_engine(
        tmp_path, capsys, text_file, stride, lcp):
    flags = ["--matcher", "sort", "--stride", str(stride), "--lcp-words",
             str(lcp)]
    files, (out, jax_out) = _run_both(
        tmp_path,
        lambda d: ["lz4", "encode", str(text_file), str(d / "out.lz4"), *flags],
        ("out.lz4",), capsys,
        port_extra=("--engine", "device", "--device", "cpu"),
        jax_extra=("--engine", "tpu"))
    got, want = files["out.lz4"]
    assert got == want and out == jax_out


@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("engine", ["device", "auto", "native", "python"])
def test_lz4_decode_matches_jax(tmp_path, capsys, text_file, mode, engine):
    frame = tmp_path / "in.lz4"
    assert jax_main(["lz4", "encode", str(text_file), str(frame),
                     "--mode", mode]) == 0
    jax_engine = "tpu" if engine == "device" else engine
    for text in ((), ("--text",)):
        files, (out, jax_out) = _run_both(
            tmp_path,
            lambda d: ["lz4", "decode", str(frame), str(d / "out"), *text],
            ("out",), capsys,
            port_extra=("--engine", engine, "--device", "cpu"),
            jax_extra=("--engine", jax_engine))
        got, want = files["out"]
        assert got == want and out == jax_out
        if not text:
            assert got == text_file.read_bytes()


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_lz4_inspect_prints_what_jax_prints(tmp_path, capsys, text_file, mode):
    frame = tmp_path / "in.lz4"
    assert main(["lz4", "encode", str(text_file), str(frame), "--mode", mode,
                 "--device", "cpu"]) == 0
    capsys.readouterr()
    assert main(["lz4", "inspect", str(frame)]) == 0
    out = capsys.readouterr().out
    assert jax_main(["lz4", "inspect", str(frame)]) == 0
    assert out == capsys.readouterr().out
    assert out.startswith("parity frame" if mode == "parity" else "LZ4T frame")


@pytest.fixture(scope="module")
def png_file(tmp_path_factory):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    img[:, ::2] = img[:, 1::2]  # runs
    path = tmp_path_factory.mktemp("img") / "in.png"
    write_png(str(path), img)
    return path


def _within_envelope(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return a.shape == b.shape and diff.max() <= 3 and (diff != 0).mean() <= 2e-3


@pytest.mark.parametrize("flags", [
    (), ("--precision", "exact"), ("--quality", "90"), ("--quality", "40"),
])
def test_jpeg_encode_and_decode_match_jax(tmp_path, capsys, png_file, flags):
    files, (out, jax_out) = _run_both(
        tmp_path,
        lambda d: ["jpeg", "encode", str(png_file), str(d / "out.tjpg"),
                   *flags],
        ("out.tjpg",), capsys)
    assert out == jax_out
    got, want = files["out.tjpg"]
    assert got == want
    files, (out, jax_out) = _run_both(
        tmp_path,
        lambda d: ["jpeg", "decode", str(d / "out.tjpg"), str(d / "dec.png")],
        (), capsys)
    ours = read_png(str(tmp_path / "port" / "dec.png"))
    assert np.array_equal(ours, _pil_pixels(tmp_path / "port" / "dec.png"))
    assert _within_envelope(ours, _pil_pixels(tmp_path / "jax" / "dec.png"))
    assert out.replace("port", "jax") == jax_out


def test_jpeg_encode_per_block_raises_as_in_jax(tmp_path, png_file):
    from lz4jpeg_tpu.formats.jpeg_container import (
        JPEGContainerError as JaxContainerError,
    )
    from lz4jpeg_tpu_torch.formats.jpeg_container import JPEGContainerError

    argv = ["jpeg", "encode", str(png_file), str(tmp_path / "out.tjpg"),
            "--entropy", "per_block"]
    with pytest.raises(JPEGContainerError, match="only shared-codebook"):
        main([*argv, "--device", "cpu"])
    with pytest.raises(JaxContainerError, match="only shared-codebook"):
        jax_main(argv)


def test_jpeg_roundtrip_with_mse_and_visualize_matches_jax(tmp_path, capsys,
                                                           png_file):
    _, (out, jax_out) = _run_both(
        tmp_path,
        lambda d: ["jpeg", "roundtrip", str(png_file), str(d / "rec.png"),
                   "--mse", "--visualize", str(d / "viz")],
        (), capsys)
    rec = read_png(str(tmp_path / "port" / "rec.png"))
    jax_rec = _pil_pixels(tmp_path / "jax" / "rec.png")
    assert _within_envelope(rec, jax_rec)
    if np.array_equal(rec, jax_rec):
        assert out.replace("port", "jax") == jax_out
    assert out.startswith("MSE: ") and "PSNR: " in out
    for name in ("luminance.png", "rChrominance.png", "bChrominance.png"):
        ours = tmp_path / "port" / "viz" / name
        assert np.array_equal(read_png(str(ours)),
                              _pil_pixels(tmp_path / "jax" / "viz" / name))


def test_lzw_matches_jax(tmp_path, capsys):
    src = tmp_path / "in.txt"
    src.write_bytes(b"to be or not to be, that is the question " * 50)
    files, outs = _run_both(
        tmp_path, lambda d: ["lzw", "encode", str(src), str(d / "codes.txt")],
        ("codes.txt",), capsys, port_extra=())
    got, want = files["codes.txt"]
    assert got == want and outs[0] == outs[1]
    files, outs = _run_both(
        tmp_path,
        lambda d: ["lzw", "decode", str(d / "codes.txt"), str(d / "back")],
        ("back",), capsys, port_extra=())
    got, want = files["back"]
    assert got == want == src.read_bytes() and outs[0] == outs[1]


def test_bench_is_not_a_subcommand(capsys):
    """An unknown ``bench`` suite is no subcommand the parser takes, and
    ``bench headline`` on the default device (``cuda``) raises on a host
    without a card instead of running on the CPU."""
    import torch

    with pytest.raises(SystemExit):
        main(["bench", "no-such-suite"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["bench", "headline"])


def test_module_entry_point(tmp_path, text_file):
    out = tmp_path / "out.lz4"
    proc = subprocess.run(
        [sys.executable, "-m", "lz4jpeg_tpu_torch", "lz4", "encode",
         str(text_file), str(out), "--mode", "parity", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("20000 -> ")
    assert out.read_bytes()[0] == -(-20000 // 300)


def test_default_device_raises_without_a_card(tmp_path, text_file, png_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for CPU hosts")
    for argv in (["lz4", "encode", str(text_file), str(tmp_path / "o")],
                 ["lz4", "decode", str(tmp_path / "o"), str(tmp_path / "d")],
                 ["jpeg", "roundtrip", str(png_file), str(tmp_path / "r.png")]):
        if argv[1] == "decode":
            (tmp_path / "o").write_bytes(b"")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)


# ---------------------------------------------------------------------------
# The PNG codec against PIL
# ---------------------------------------------------------------------------

PIL_MODES = {1: "L", 3: "RGB", 4: "RGBA"}


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (48, 64)])
def test_png_we_write_reads_back_through_pil(tmp_path, channels, shape):
    rng = np.random.default_rng(channels * 100 + shape[0])
    img = rng.integers(0, 256, (*shape, channels), dtype=np.uint8)
    path = tmp_path / "x.png"
    write_png(str(path), img[..., 0] if channels == 1 else img)
    with Image.open(path) as im:
        assert im.mode == PIL_MODES[channels]
        back = np.asarray(im)
    assert np.array_equal(back, img[..., 0] if channels == 1 else img)
    want_rgb = np.repeat(img, 3, axis=2) if channels == 1 else img[..., :3]
    assert np.array_equal(read_png(str(path)), want_rgb)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_pil_writes_reads_as_pil_reads_it(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (45, 61, channels), dtype=np.uint8)
    img[10:20] = 77  # flat rows, where PIL's filter choice differs
    img[:, 30:] = img[:, :31][:, ::-1][:, :31]
    path = tmp_path / "pil.png"
    Image.fromarray(img[..., 0] if channels == 1 else img,
                    PIL_MODES[channels]).save(path)
    assert np.array_equal(read_png(str(path)), _pil_pixels(path))


def _filter_row(kind, row, prior, bpp):
    """PNG spec §9 filter of one row (the encoder side, for the test)."""
    row, prior = row.astype(np.int32), prior.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (left + prior) >> 1
    else:
        p = left + prior - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prior, upleft))
    return ((row - pred) & 0xFF).astype(np.uint8)


def _png_bytes(width, height, colour, raw):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, colour,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels,colour", [(1, 0), (3, 2), (4, 6)])
def test_png_every_row_filter_reads_as_pil_reads_it(tmp_path, channels, colour):
    rng = np.random.default_rng(channels + 20)
    h, w = 25, 19
    img = rng.integers(0, 256, (h, w * channels), dtype=np.uint8)
    img[5:9] = img[4]
    prior = np.zeros(w * channels, np.uint8)
    raw = bytearray()
    for y in range(h):
        kind = y % 5
        raw.append(kind)
        raw += _filter_row(kind, img[y], prior, channels).tobytes()
        prior = img[y]
    path = tmp_path / "filters.png"
    path.write_bytes(_png_bytes(w, h, colour, bytes(raw)))
    got = read_png(str(path))
    assert np.array_equal(got, _pil_pixels(path))
    full = img.reshape(h, w, channels)
    want = np.repeat(full, 3, axis=2) if channels == 1 else full[..., :3]
    assert np.array_equal(got, want)


def test_png_other_formats_raise(tmp_path):
    rng = np.random.default_rng(3)
    palette = tmp_path / "p.png"
    Image.fromarray(rng.integers(0, 4, (8, 8), dtype=np.uint8), "L").convert(
        "P").save(palette)
    deep = tmp_path / "i16.png"
    Image.fromarray(rng.integers(0, 65535, (8, 8), dtype=np.uint16)).save(deep)
    laced = tmp_path / "laced.png"
    laced.write_bytes(_png_bytes(2, 2, 2, bytes(14)).replace(
        struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 0),
        struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 1)))
    not_png = tmp_path / "x.png"
    not_png.write_bytes(b"GIF89a")
    for path in (palette, deep, not_png):
        with pytest.raises(ValueError):
            read_png(str(path))
    with pytest.raises(ValueError):  # the IHDR CRC no longer matches
        read_png(str(laced))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "y.png"), np.zeros((4, 4, 2), np.uint8))
