"""The Hopper kernels against their plain torch versions, on the card.

Needs a CUDA device: every test takes the ``cuda`` fixture, which skips
with a reason on a host without one (the decision is made inside the
fixture, never while the module is imported).  This file imports neither
JAX nor ``lz4jpeg_tpu``, so it also runs on a machine without them:
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.

Tolerance of the forward kernel: identity, except sum-order flips
(``utils/parity.py``): a coefficient off by exactly 1 whose float64 ratio
lies within 1e-4 of an integer, at most 1e-5 of the coefficients.  The
kernel sums three bf16 tensor-core passes (exact products) in float32;
cuBLAS sums in its own order.

The LZ4 match kernel (K2), the rooted-resolve kernel (K3) and the packed16
kernels (K4-K7) compute on integers: identity, no tolerance.  The LZ4T
frame of a CUDA codec must equal the CPU codec's byte for byte; the packed16
containers of a CUDA pipeline equal the CPU pipeline's; quality 90 (int16
pairs, cuBLAS forward) equals it up to the sum-order flips above; decoded
RGB stays within max |Δ| ≤ 3 on ≤ 2e-3 of pixels of the CPU decode.
Parity frames of a CUDA codec (torch ops, no kernel) equal the CPU codec's
and the native encoder's byte for byte; the CLI on the card writes what its
``--device cpu`` run writes, by the same rules.
"""

import numpy as np
import pytest
import torch

from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline, LZ4Codec, LZ4Config
from lz4jpeg_tpu_torch.native import native_backend
from lz4jpeg_tpu_torch.ops.fused_match import (
    match_candidates,
    match_candidates_ref,
)
from lz4jpeg_tpu_torch.ops.lz4_fast import pad_blocks_fast
from lz4jpeg_tpu_torch.ops.lz4t_decode import (
    build_copy_program_fast,
    resolve_rooted,
    resolve_rooted_ref,
    root_program,
)
from lz4jpeg_tpu_torch.utils.inputs import (
    crafted_match_blocks,
    crafted_packed16_rows,
    generate_text,
)
from lz4jpeg_tpu_torch.formats.jpeg_container import pack_container, unpack_container
from lz4jpeg_tpu_torch.ops.fwd_megakernel import (
    forward_combined,
    forward_combined_ref,
)
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE as CHR,
    LUMINANCE_QUANTIZATION_TABLE as LUM,
    scale_table,
)
from lz4jpeg_tpu_torch.models.jpeg import scaled_tables
from lz4jpeg_tpu_torch.ops import pack16
from lz4jpeg_tpu_torch.utils.parity import combined_of, sum_order_flips

MAX_FLIP_SHARE = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(b, h, w, seed):
    rgb = np.random.default_rng(seed).integers(0, 256, size=(b, h, w, 3),
                                               dtype=np.uint8)
    rgb[:, :, 0 : 2 * (w // 2) : 2] = rgb[:, :, 1::2]
    return rgb


@pytest.mark.parametrize("shape", [(2, 256, 256), (1, 2047, 1531), (3, 37, 53),
                                   (1, 8, 8), (1, 1, 1), (1, 9, 17)])
def test_kernel_matches_plain_version(cuda, shape):
    rgb = _batch(*shape, seed=sum(shape))
    x = torch.from_numpy(rgb).to(cuda)
    before = forward_combined.launches
    got = forward_combined(x, LUM, CHR)
    torch.cuda.synchronize()
    assert forward_combined.launches == before + 1
    want = forward_combined_ref(x, LUM, CHR)
    assert got.shape == want.shape and got.dtype == torch.int16
    flips = sum_order_flips(rgb, got.cpu().numpy(), want.cpu().numpy(), LUM, CHR)
    assert flips <= MAX_FLIP_SHARE * got.numel()


@pytest.mark.parametrize("case,shape,quality", [
    ("staged, edge band", (2, 64, 1040), None),  # W·3 % 16 == 0; 130 tiles
    ("staged, q75", (4, 48, 528), 75),           # 66 tiles: 64 + 2
    ("staged, ragged height", (1, 61, 1040), None),   # rows 61-63 past H
    ("staged, ragged height, tall", (2, 1023, 512), None),
    ("generic, ragged", (3, 37, 53), None),      # W·3 % 16 != 0
    ("generic, tall", (1, 2050, 24), None),      # 257 block rows of 3 tiles
    ("generic, unaligned view", (1, 64, 64), None),
])
def test_kernel_routes_and_band_edges(cuda, case, shape, quality):
    """K1's two load routes (16-byte cp.async bands when the batch and its
    row stride W·3 are 16-byte aligned; direct reads otherwise) and its
    band edges (a last band of a block row with fewer than 64 tiles, rows
    past H, columns past W), against the plain version."""
    rgb = np.random.default_rng(sum(shape)).integers(
        0, 256, size=(*shape, 3), dtype=np.uint8)
    x = torch.from_numpy(rgb).to(cuda)
    if case.endswith("unaligned view"):
        buf = torch.empty(x.numel() + 1, dtype=torch.uint8, device=cuda)[1:]
        x = buf.copy_(x.reshape(-1)).view(x.shape)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    lum, chroma = scale_table(LUM, quality), scale_table(CHR, quality)
    before = forward_combined.launches
    got = forward_combined(x, lum, chroma)
    torch.cuda.synchronize()
    assert forward_combined.launches == before + 1
    want = forward_combined_ref(x, lum, chroma)
    assert got.shape == want.shape and got.dtype == torch.int16
    flips = sum_order_flips(rgb, got.cpu().numpy(), want.cpu().numpy(),
                            lum, chroma)
    assert flips <= MAX_FLIP_SHARE * got.numel()


def test_cuda_pipeline_matches_cpu_pipeline(cuda):
    rgbs = _batch(2, 96, 80, seed=1)
    gpu = JPEGPipeline(JPEGConfig(), device=cuda)
    cpu = JPEGPipeline(JPEGConfig(), device="cpu")
    before = forward_combined.launches
    g_encs, c_encs = gpu.encode_batch(rgbs), cpu.encode_batch(rgbs)
    assert forward_combined.launches == before + 1
    for rgb, g, c in zip(rgbs, g_encs, c_encs):
        if pack_container(g) != pack_container(c):
            sum_order_flips(rgb[None], g.rle_combined, c.rle_combined, LUM, CHR)
    containers = [unpack_container(pack_container(e)) for e in g_encs]
    g_rgb = gpu.decode_batch(containers)
    c_rgb = cpu.decode_batch([unpack_container(pack_container(e)) for e in g_encs])
    for a, b in zip(g_rgb, c_rgb):
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert diff.max() <= 3 and (diff != 0).mean() <= 2e-3


def _text_blocks(n_full, seed):
    """(n_full + 2, 16 KiB) uint8 blocks: text with a ragged last text
    block, then one block of uniform noise; and their int32 lengths."""
    rng = np.random.default_rng(seed)
    padded, lengths = pad_blocks_fast(generate_text(n_full * 16384 + 5001, rng))
    noise = rng.integers(0, 256, (1, 16384), dtype=np.uint8)
    blocks = np.concatenate([padded.astype(np.uint8), noise])
    return blocks, np.append(lengths, 16384).astype(np.int32)


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("lcp_words", [2, 4])
def test_match_kernel_matches_plain_version(cuda, stride, lcp_words):
    blocks, lengths = _text_blocks(5, seed=stride * 10 + lcp_words)
    x = torch.from_numpy(blocks).to(cuda)
    lens = torch.from_numpy(lengths).to(cuda)
    before = match_candidates.launches
    got = match_candidates(x, lens, stride, lcp_words)
    torch.cuda.synchronize()
    assert match_candidates.launches == before + 1
    want = match_candidates_ref(x, lens, stride, lcp_words)
    assert got.shape == (7, 16384 // stride) and got.dtype == torch.int32
    assert torch.equal(got, want)
    assert int((got != 0).sum()) > 1000  # text must give plenty of matches


# (P, stride): block_log 14 and 12, then 512, 256, 16 and 2 anchors per
# block (below 512 the sort pads to 512 slots; below 4 the row is stored
# word by word), each at strides 1, 2 and 4.
CRAFTED_MATCH_SHAPES = (
    [(p, s) for p in (16384, 4096) for s in (1, 2, 4)]
    + [(a * s, s) for a in (512, 256, 16, 2) for s in (1, 2, 4)])


@pytest.mark.parametrize("p,stride", CRAFTED_MATCH_SHAPES)
def test_match_kernel_on_crafted_blocks(cuda, p, stride):
    """K2 on the sort's edge cases (one bucket for every anchor, a 4-byte
    period, a block shorter than a window, zeros, a zero-length padding
    block, a ragged block) and on text: identical to the plain version."""
    rng = np.random.default_rng(p + stride)
    crafted, lengths = crafted_match_blocks(p, rng)
    text, text_lengths = pad_blocks_fast(generate_text(3 * p + 777, rng),
                                         p.bit_length() - 1)
    blocks = np.concatenate([crafted, text.astype(np.uint8)])
    x = torch.from_numpy(blocks).to(cuda)
    lens = torch.from_numpy(np.concatenate([lengths, text_lengths])).to(cuda)
    valid = max(0, (p - 4) // stride + 1)  # anchors with a whole window
    for lcp_words in (1, 4):
        before = match_candidates.launches
        got = match_candidates(x, lens, stride, lcp_words)
        torch.cuda.synchronize()
        assert match_candidates.launches == before + 1
        want = match_candidates_ref(x, lens, stride, lcp_words)
        assert torch.equal(got, want), (stride, lcp_words)
        # One bucket: every valid anchor but the first matches its 1-back.
        assert int((got[0] != 0).sum()) == max(0, valid - 1)


def _random_program(rows, p, seed):
    rng = np.random.default_rng(seed)
    lit = rng.integers(0, 256, (rows, p), dtype=np.uint8)
    root = rng.integers(0, p, (rows, p), dtype=np.int32)
    return lit, root


@pytest.mark.parametrize("source", ["native64k", "device16k", "p1000",
                                    "p1002", "p131072"])
def test_resolve_kernel_matches_plain_version(cuda, source):
    """Rooted programs of real frames (staged rows, vector loads) and of
    random roots at row lengths that take the scalar paths (P % 16 != 0,
    P % 4 != 0) and the unstaged path (P > 64 KiB)."""
    if source in ("native64k", "device16k"):
        data = generate_text(300_000, np.random.default_rng(7))
        data += np.random.default_rng(8).integers(0, 256, 70_000,
                                                  dtype=np.uint8).tobytes()
        frame = (native_backend().encode_fast(data) if source == "native64k"
                 else LZ4Codec(LZ4Config(mode="fast"), device="cpu").encode(
                     data, engine="device"))
        lit, src, _, _, _ = build_copy_program_fast(frame, depth_cap=1)
        lit_d = torch.from_numpy(lit).to(cuda)
        root_d = root_program(torch.from_numpy(src).to(cuda))
    else:
        lit, root = _random_program(3, int(source[1:]), seed=len(source))
        lit_d, root_d = torch.from_numpy(lit).to(cuda), torch.from_numpy(root).to(cuda)
    before = resolve_rooted.launches
    got = resolve_rooted(lit_d, root_d)
    torch.cuda.synchronize()
    assert resolve_rooted.launches == before + 1
    assert torch.equal(got, resolve_rooted_ref(lit_d, root_d))


def _runny_values(n, k, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-511, 512, size=(n, k))
    vals[::2] = np.repeat(rng.integers(-511, 512, size=(n, (k + 3) // 4)), 4,
                          axis=1)[::2, :k]
    vals[1], vals[3, -1] = 511, -511
    return torch.from_numpy(vals.astype(np.int16))


def _offset_view(x):
    """``x`` in a view one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape).copy_(x)
    assert view.data_ptr() % 16
    return view


@pytest.mark.parametrize("k", [64, 32, 16, 8, 2, 1])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_pack16_kernels_match_plain_versions(cuda, k, dtype):
    """K4 and K5 against their plain versions (any N, C), identical; K4 also
    on row counts that are no multiple of its rows per warp step and on an
    input view off a 16-byte boundary."""
    vals = _runny_values(1000, k, seed=k).to(dtype).to(cuda)
    for x in (vals, vals[:17], vals[:1], vals[:999], _offset_view(vals[:333])):
        before = pack16.pack16_encode.launches
        got = pack16.pack16_encode(x)
        torch.cuda.synchronize()
        assert pack16.pack16_encode.launches == before + 1
        want = pack16.pack16_encode_ref(x)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = pack16.pack16_encode(vals)
    kt = vals[:960].reshape(24, 40, k).transpose(1, 2).contiguous()
    before = pack16.pack16_encode_kt.launches
    got_kt = pack16.pack16_encode_kt(kt)
    torch.cuda.synchronize()
    assert pack16.pack16_encode_kt.launches == before + 1
    assert all(torch.equal(g, w) for g, w in
               zip(got_kt, pack16.pack16_encode_kt_ref(kt)))
    assert all(torch.equal(g, w[:960]) for g, w in zip(got_kt, got))


@pytest.mark.parametrize("k", [64, 32, 8, 2, 1])
def test_expand16_kernels_match_plain_versions(cuda, k):
    """K6 and K7 against their plain versions on canonical and crafted rows,
    identical (they honour lengths; a valid word 0 is -512 × 1); K7 on
    widths below, at and around its 64-block tile and on offset views."""
    words, lengths = pack16.pack16_encode_ref(_runny_values(500, k, seed=k))
    cw, cl = map(torch.from_numpy,
                 crafted_packed16_rows(k, np.random.default_rng(k), n_random=488))
    for w, l in ((words, lengths), (cw, cl)):
        w, l = w.to(cuda), l.to(cuda)
        for out_size in sorted({k, max(1, k // 2), min(64, k + 9)}):
            before = pack16.pack16_decode.launches
            got = pack16.pack16_decode(w, l, out_size)
            torch.cuda.synchronize()
            assert pack16.pack16_decode.launches == before + 1
            assert torch.equal(got, pack16.pack16_decode_ref(w, l, out_size))
        for bw in (50, 20, 1, 7, 63, 64, 65, 131):
            n = (w.shape[0] // bw) * bw
            for ww, ll in ((w[:n], l[:n]),
                           (_offset_view(w[:n]), _offset_view(l[:n]))):
                before = pack16.pack16_decode_plane.launches
                got = pack16.pack16_decode_plane(ww, ll, bw)
                torch.cuda.synchronize()
                assert pack16.pack16_decode_plane.launches == before + 1
                assert torch.equal(
                    got, pack16.pack16_decode_plane_ref(ww, ll, bw))


def _envelope(got, want):
    for a, b in zip(got, want):
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert diff.max() <= 3 and (diff != 0).mean() <= 2e-3


def test_cuda_packed16_pipeline_matches_cpu_pipeline(cuda):
    rgbs = _batch(2, 96, 80, seed=5)
    gpu = JPEGPipeline(JPEGConfig(), device=cuda)
    cpu = JPEGPipeline(JPEGConfig(), device="cpu")
    sparse = cpu.encode_batch(rgbs)
    k4, k6 = pack16.pack16_encode.launches, pack16.pack16_decode.launches
    g_packed = [gpu.entropy_encode(e) for e in gpu.to_packed16(sparse)]
    c_packed = [cpu.entropy_encode(e) for e in cpu.to_packed16(sparse)]
    assert pack16.pack16_encode.launches == k4 + 3  # one per channel
    for g, c, s in zip(g_packed, c_packed, sparse):
        assert pack_container(g) == pack_container(c) == pack_container(s)
    g_rgb = gpu.decode_batch(g_packed)
    assert pack16.pack16_decode.launches == k6 + 3
    _envelope(g_rgb, cpu.decode_batch(c_packed))
    _envelope(g_rgb, cpu.decode_batch(sparse))


def test_cuda_quality90_matches_cpu(cuda):
    """Uniform noise at 512 × 384: large enough that the 1e-5 flip share
    admits a few flips (two 96 × 80 frames with duplicated columns gave
    one admissible flip in 15,360 coefficients on an H100, over the share;
    four 2048² frames gave none)."""
    rgbs = np.random.default_rng(9).integers(0, 256, size=(2, 512, 384, 3),
                                             dtype=np.uint8)
    gpu = JPEGPipeline(JPEGConfig(quality=90), device=cuda)
    cpu = JPEGPipeline(JPEGConfig(quality=90), device="cpu")
    tables = scaled_tables(90)
    g_encs, c_encs = gpu.encode_batch(rgbs), cpu.encode_batch(rgbs)
    for rgb, g, c in zip(rgbs, g_encs, c_encs):
        assert not g.rle_sparse16 and not g.rle_packed16
        if pack_container(g) != pack_container(c):
            flips = sum_order_flips(rgb[None], combined_of(g), combined_of(c),
                                    tables["lum"], tables["r"])
            assert flips <= MAX_FLIP_SHARE * combined_of(g).size
    _envelope(gpu.decode_batch(g_encs), cpu.decode_batch(g_encs))
    containers = [unpack_container(pack_container(e)) for e in g_encs]
    _envelope([gpu.decode(e) for e in containers],
              [cpu.decode(e) for e in containers])


def test_cuda_codec_frame_matches_cpu_codec(cuda):
    data = generate_text(3 * 16384 + 999, np.random.default_rng(3))
    gpu = LZ4Codec(LZ4Config(mode="fast"), device=cuda)
    cpu = LZ4Codec(LZ4Config(mode="fast"), device="cpu")
    k2, k3 = match_candidates.launches, resolve_rooted.launches
    frame = gpu.encode(data, engine="device")
    assert match_candidates.launches == k2 + 1
    assert frame == cpu.encode(data, engine="device")
    assert gpu.decode(frame, engine="device") == data
    assert resolve_rooted.launches == k3 + 1
    assert gpu.decode(frame, engine="native") == data


@pytest.mark.parametrize("k", [64, 32, 16, 8, 4, 2, 1])
def test_wide_expand_kernel_matches_plain_version_and_k6(cuda, k):
    """K8 against its plain version and K6 (cast to int16) on canonical
    words, crafted rows (a valid word 0, count sums past K) and a view that
    starts one row in (not 16-byte aligned: the wrapper copies it)."""
    words, lengths = pack16.pack16_encode_ref(_runny_values(501, k, seed=k))
    cw, cl = map(torch.from_numpy,
                 crafted_packed16_rows(k, np.random.default_rng(k), n_random=288))
    for w, l in ((words, lengths), (cw, cl), (cw[1:], cl[1:])):
        w, l = w.to(cuda), l.to(cuda)
        before = pack16.pack16_decode_wide.launches
        got = pack16.pack16_decode_wide(w, l)
        torch.cuda.synchronize()
        assert pack16.pack16_decode_wide.launches == before + 1
        assert got.dtype == torch.int16 and got.shape == w.shape
        assert torch.equal(got, pack16.pack16_decode_wide_ref(w, l))
        assert torch.equal(got, pack16.pack16_decode(w, l, k).to(torch.int16))


@pytest.mark.parametrize("shape", [(16, 16), (37, 53)])
def test_cuda_exact_pipeline_matches_oracle(cuda, shape):
    """Exact precision runs real float64 on the card: coefficients, RLE and
    the round trip identical to the numpy oracle (snapped ties)."""
    from lz4jpeg_tpu_torch.oracle import jpeg_oracle

    img = np.random.default_rng(sum(shape)).integers(
        0, 256, size=(*shape, 3), dtype=np.uint8)
    pipe = JPEGPipeline(JPEGConfig(precision="exact"), device=cuda)
    rec, ref = jpeg_oracle.jpeg_roundtrip_oracle(img, snap_ties=True)
    stages = pipe.forward_stages(img)
    for c in ("lum", "r", "b"):
        assert stages[c]["zz"].dtype == np.float64
        assert np.array_equal(stages[c]["zz"], ref[f"zz_{c}"])
        for i, row in enumerate(ref[f"rle_{c}"]):
            n = int(stages[c]["rle_lengths"][i])
            assert list(stages[c]["rle"][i, :n]) == row
    assert np.array_equal(pipe.roundtrip(img), rec)


def test_cuda_overlapped_encode_matches_one_shot(cuda):
    """The banded encode (side stream, pinned bands) writes the one-shot
    container byte for byte, and a second encode leaves the first's host
    buffer as it was."""
    rng = np.random.default_rng(11)
    a, b = (rng.integers(0, 256, size=(96, 80, 3), dtype=np.uint8)
            for _ in range(2))
    pipe = JPEGPipeline(JPEGConfig(), device=cuda)
    banded = JPEGPipeline(JPEGConfig(), device=cuda)
    banded._OVERLAP_MIN_BLOCKS = 1
    enc_a = banded.encode(a)
    kept = enc_a.rle_combined.copy()
    assert pack_container(enc_a) == pack_container(pipe.encode_batch(a[None])[0])
    enc_b = banded.encode(b)
    assert pack_container(enc_b) == pack_container(pipe.encode_batch(b[None])[0])
    assert np.array_equal(enc_a.rle_combined, kept)


@pytest.mark.parametrize("n,block_length", [(350, 300), (20_000, 300),
                                            (76_500, 300), (30_000, 1024)])
def test_cuda_parity_codec_matches_cpu_codec(cuda, n, block_length):
    """Parity frames of the CUDA codec (match tables and greedy parse on the
    card) byte-identical to the CPU codec's and the native encoder's; the
    card's pointer-doubling decode returns the input."""
    from lz4jpeg_tpu_torch.oracle import lz4_encode_oracle

    data = generate_text(n, np.random.default_rng(n))
    cfg = LZ4Config(mode="parity", block_length=block_length)
    gpu = LZ4Codec(cfg, device=cuda)
    frame = gpu.encode(data)
    assert frame == LZ4Codec(cfg, device="cpu").encode(data)
    assert frame == native_backend().encode_parity(data, block_length)
    if n <= 2000:
        assert frame == lz4_encode_oracle(data, block_length)
    assert gpu.decode(frame, engine="device") == data


def test_cuda_cli_matches_cpu_cli(cuda, tmp_path):
    """``lz4`` and ``jpeg`` subcommands on the card write the files their
    ``--device cpu`` runs write (JPEG containers up to K1's sum-order
    flips, decoded PNGs within the envelope); K1, K2 and K3 launch."""
    from lz4jpeg_tpu_torch.cli import main
    from lz4jpeg_tpu_torch.utils.io import read_png, write_png

    text = tmp_path / "text.txt"
    text.write_bytes(generate_text(200_000, np.random.default_rng(3)))
    rgb = _batch(1, 96, 80, seed=3)[0]
    png = tmp_path / "in.png"
    write_png(str(png), rgb)
    launches = {f: f.launches for f in (forward_combined, match_candidates,
                                        resolve_rooted)}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        d.mkdir()
        for argv in (
            ["lz4", "encode", str(text), str(d / "fast.lz4"), "--mode", "fast",
             "--engine", "device"],
            ["lz4", "decode", str(d / "fast.lz4"), str(d / "fast.out"),
             "--engine", "device"],
            ["lz4", "encode", str(text), str(d / "parity.lz4"), "--mode",
             "parity", "--block-length", "1024"],
            ["lz4", "decode", str(d / "parity.lz4"), str(d / "parity.out"),
             "--engine", "device"],
            ["jpeg", "encode", str(png), str(d / "out.tjpg")],
            ["jpeg", "decode", str(d / "out.tjpg"), str(d / "dec.png")],
        ):
            assert main([*argv, "--device", dev]) == 0
    for f, before in launches.items():
        assert f.launches > before, f.__name__
    gpu, cpu = tmp_path / "cuda", tmp_path / "cpu"
    for name in ("fast.lz4", "parity.lz4"):
        assert (gpu / name).read_bytes() == (cpu / name).read_bytes(), name
    for name in ("fast.out", "parity.out"):
        assert (gpu / name).read_bytes() == text.read_bytes(), name
    g = unpack_container((gpu / "out.tjpg").read_bytes())
    c = unpack_container((cpu / "out.tjpg").read_bytes())
    if pack_container(g) != pack_container(c):
        flips = sum_order_flips(rgb[None], g.rle_combined, c.rle_combined,
                                LUM, CHR)
        assert 0 < flips <= MAX_FLIP_SHARE * g.num_blocks * 128
    diff = np.abs(read_png(str(gpu / "dec.png")).astype(np.int32)
                  - read_png(str(cpu / "dec.png")))
    assert diff.max() <= 3 and (diff != 0).mean() <= 2e-3


def _card_mesh(cuda, shards=4):
    """``shards`` shards of one card: the band split, the per-shard launches
    and the ordered gather run as on distinct cards."""
    from lz4jpeg_tpu_torch.parallel.mesh import CodecMesh

    return CodecMesh((torch.device(cuda.type, 0),) * shards)


def test_sharded_sparse_forward_launches_k1_per_band(cuda):
    from lz4jpeg_tpu_torch.parallel import ShardedSparseJPEG

    rgb = _batch(1, 200, 96, seed=19)[0]  # 25 block rows: the last band padded
    want = JPEGPipeline(JPEGConfig(), device=cuda).encode(rgb, entropy=False)
    before = forward_combined.launches
    got = ShardedSparseJPEG(_card_mesh(cuda)).forward(rgb)
    assert forward_combined.launches == before + 4
    assert np.array_equal(got, want.rle_combined)


def test_sharded_fast_parse_launches_k2_per_shard(cuda):
    from lz4jpeg_tpu_torch.ops.fused_match import fast_match_blocks_fused
    from lz4jpeg_tpu_torch.parallel.lz4 import sharded_fast_parse

    padded, lengths = pad_blocks_fast(
        generate_text(8 * 16384 - 999, np.random.default_rng(19)))
    want = fast_match_blocks_fused(
        torch.from_numpy(padded.astype(np.uint8)).to(cuda),
        torch.from_numpy(lengths).to(cuda), lcp_words=2)
    before = match_candidates.launches
    got = sharded_fast_parse(padded, lengths, _card_mesh(cuda))
    assert match_candidates.launches == before + 4
    for g, w in zip(got, want):
        assert np.array_equal(g, w.cpu().numpy())


def test_sharded_fast_decode_launches_k3_per_shard(cuda):
    from lz4jpeg_tpu_torch.formats.fast_frame import encode_fast
    from lz4jpeg_tpu_torch.parallel.lz4 import sharded_fast_decode

    data = generate_text(7 * 1024 + 37, np.random.default_rng(19))
    frame = encode_fast(data, block_log=10)
    before = resolve_rooted.launches
    assert sharded_fast_decode(frame, _card_mesh(cuda)) == data
    assert resolve_rooted.launches == before + 4


def test_multihost_fast_encode_runs_the_codec_path(cuda):
    """No group: one process encodes every block through the codec's device
    path, K2 once, and the frame is the codec's and decodes with K3."""
    from lz4jpeg_tpu_torch.parallel.lz4 import (
        multihost_fast_decode,
        multihost_fast_encode,
    )

    data = generate_text(8 * 16384 - 999, np.random.default_rng(19))
    want = LZ4Codec(LZ4Config(mode="fast"), cuda).encode(data, engine="device")
    k2, k3 = match_candidates.launches, resolve_rooted.launches
    frame = multihost_fast_encode(data, device=cuda)
    assert match_candidates.launches == k2 + 1
    assert frame == want
    assert multihost_fast_decode(frame, device=cuda) == data
    assert resolve_rooted.launches == k3 + 1


def test_sharded_packed16_inverse_launches_k6_per_shard(cuda):
    """K6 once per channel per shard.  The inverse products are cuBLAS
    calls of another row count than the unsharded decode's: identical, or
    within the fast-path envelope should cuBLAS sum in another order."""
    from lz4jpeg_tpu_torch.parallel import ShardedJPEGForward

    rgb = _batch(1, 96, 80, seed=19)[0]
    pipe = JPEGPipeline(JPEGConfig(), device=cuda)
    (packed,) = pipe.to_packed16([pipe.encode(rgb, entropy=False)])
    want = pipe.decode(packed, from_entropy=False)
    before = pack16.pack16_decode.launches
    got = ShardedJPEGForward(_card_mesh(cuda)).inverse(
        packed.rle, packed.rle_lengths, 12, 10, 96, 80, layout="packed16")
    assert pack16.pack16_decode.launches == before + 3 * 4
    if not np.array_equal(got, want):
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() < 2e-3


def test_cuda_mesh_refuses_more_devices_than_cards(cuda):
    from lz4jpeg_tpu_torch.config import MeshConfig
    from lz4jpeg_tpu_torch.parallel import codec_mesh

    n = torch.cuda.device_count()
    assert codec_mesh(MeshConfig(), "cuda").size == n
    with pytest.raises(ValueError, match="visible"):
        codec_mesh(MeshConfig(num_devices=n + 1), "cuda")


def test_nccl_world_of_one_ordered_gather(cuda):
    import socket

    import torch.distributed as dist

    from lz4jpeg_tpu_torch.parallel import multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert multihost.initialize(f"127.0.0.1:{port}", 1, 0, device=cuda) == 1
    try:
        assert dist.get_backend() == "nccl"
        out = multihost.ordered_allgather_payloads(
            [b"bb", b"", b"c" * 300], [1, 0, 2], 3)
        assert out == [b"", b"bb", b"c" * 300]
        with pytest.raises(ValueError, match="missing"):
            multihost.ordered_allgather_payloads([b"x"], [0], 2)
    finally:
        dist.destroy_process_group()


COPY_CHUNK = 16 * 1024  # ops/stream.py's CHUNK_BYTES
COPY_EDGES = {"chunk - 1": COPY_CHUNK - 1, "chunk": COPY_CHUNK,
              "chunk + 1": COPY_CHUNK + 1, "3 chunks + 5": 3 * COPY_CHUNK + 5,
              "above 2^31": 2**31 + 17}  # bytes


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32])
@pytest.mark.parametrize("case", ["aligned", "odd", "offset view", "empty",
                                  *COPY_EDGES])
def test_stream_copy_matches_plain_version(cuda, dtype, case):
    """The copy kernel: the vector body with byte-wise head and tail (odd
    sizes, equal offsets) and the byte-wise route (a source one element
    off a 16-byte boundary, a 16-byte-aligned destination); the template's
    chunk edges and a copy above 2^31 bytes (the byte sizes rounded down to
    whole elements), each launch the C plan's CTAs, equal to the mirror's."""
    from lz4jpeg_tpu_torch.ops import stream
    from lz4jpeg_tpu_torch.ops.stream import stream_copy, stream_copy_ref

    assert stream.CHUNK_BYTES == COPY_CHUNK
    size = torch.empty((), dtype=dtype).element_size()
    n = {"aligned": 1 << 22, "odd": 1_000_003, "offset view": 65_537,
         "empty": 0}.get(case, COPY_EDGES.get(case, 0) // size)
    gen = torch.Generator(device=cuda).manual_seed(n)
    if case in COPY_EDGES:
        x = torch.randint(0, 100, (n,), generator=gen, device=cuda, dtype=dtype)
    else:
        x = torch.randint(-100, 100, (n,), generator=gen, device=cuda).to(dtype)
    if case == "offset view":
        buf = torch.empty(n + 1, dtype=dtype, device=cuda)
        x = buf[1:].copy_(x)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    before = stream_copy.launches
    got = stream_copy(x)
    torch.cuda.synchronize()
    assert stream_copy.launches == before + (n > 0)
    want = stream_copy_ref(x)
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
    assert torch.equal(got, want)
    if n:
        assert got.data_ptr() != x.data_ptr()
        plan = stream.launch_plan(x.data_ptr(), got.data_ptr(), n * size)
        assert plan == stream.copy_plan(n * size, x.data_ptr() % 16,
                                        got.data_ptr() % 16)


@pytest.mark.parametrize("n", [1, 15, 16, 17, COPY_CHUNK - 1, COPY_CHUNK,
                               COPY_CHUNK + 1, 3 * COPY_CHUNK + 5])
def test_stream_copy_between_equal_offsets(cuda, n):
    """The C entry point between a source and a destination at the same
    offset modulo 16 (head, body, tail), for every offset: the copied bytes
    equal, the bytes around untouched; and its plan equal to the mirror's
    for every pair of offsets, also above 2^31 bytes."""
    from lz4jpeg_tpu_torch.ops import stream

    lib = stream.load_kernel()
    s = torch.cuda.current_stream(cuda).cuda_stream
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randint(0, 256, (n + 32,), generator=gen, device=cuda,
                      dtype=torch.uint8)
    for off in range(16):
        y = torch.zeros_like(x)
        assert lib.stream_copy_launch(x.data_ptr() + off, y.data_ptr() + off,
                                      n, s) == 0
        torch.cuda.synchronize()
        assert torch.equal(y[off:off + n], x[off:off + n]), off
        assert not y[:off].any() and not y[off + n:].any(), off
    for size in (n, 2**31 + 17):
        for src in range(16):
            for dst in (src, (src + 3) % 16):
                got = stream.launch_plan(4096 + src, 8192 + dst, size)
                assert got == stream.copy_plan(size, src, dst), (size, src, dst)


def _offset(x):
    """``x`` copied into a view one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape).copy_(x)
    assert view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("width", [8, 4])
@pytest.mark.parametrize("n", [1, 5, 513, 70_000, "offset view"])
def test_mcu_kernels_match_plain_versions(cuda, width, n):
    """The MCU transform kernels (``profiles/mcu.py``) against their plain
    versions (cuBLAS): identical up to one-step flips at summation ties
    (``utils/parity.py::transform_flips``), at most 1e-5 of the outputs."""
    from lz4jpeg_tpu_torch.profiles import mcu
    from lz4jpeg_tpu_torch.utils.parity import transform_flips

    table = LUM if width == 8 else CHR
    rows = 517 if n == "offset view" else n
    rng = np.random.default_rng(rows + width)
    tiles = torch.from_numpy(rng.integers(0, 256, size=(rows, 8, width),
                                          dtype=np.uint8)).to(cuda)
    zz = mcu.fused_forward_candidate_ref(tiles, table, width, 8)
    if n == "offset view":
        tiles, zz = _offset(tiles), _offset(zz)
    before = (mcu.fused_forward_candidate.launches,
              mcu.fused_inverse_candidate.launches)
    fwd = mcu.fused_forward_candidate(tiles, table, width, 8)
    inv = mcu.fused_inverse_candidate(zz, table, width, 8)
    torch.cuda.synchronize()
    assert (mcu.fused_forward_candidate.launches,
            mcu.fused_inverse_candidate.launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert fwd.dtype == torch.float32 and fwd.shape == (rows, 8 * width)
    assert inv.dtype == torch.uint8 and inv.shape == (rows, 8, width)
    f = transform_flips("forward", tiles, fwd, zz, table, width, 8)
    i = transform_flips("inverse", zz, inv,
                        mcu.fused_inverse_candidate_ref(zz, table, width, 8),
                        table, width, 8)
    assert f <= MAX_FLIP_SHARE * fwd.numel() and i <= MAX_FLIP_SHARE * inv.numel()


@pytest.mark.parametrize("length", [1, 2, 8, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_rle_compact_kernel_matches_plain_version(cuda, length, dtype):
    """The RLE compaction kernel (``profiles/rle.py``): identical pairs and
    lengths on crafted rows (all equal, all distinct, int16 limits), at row
    counts off its rows per warp pass, and in an unaligned view."""
    from lz4jpeg_tpu_torch.profiles.rle import (
        rle_encode_candidate,
        rle_encode_candidate_ref,
    )
    from lz4jpeg_tpu_torch.utils.inputs import crafted_rle_rows

    rng = np.random.default_rng(length)
    for n in (1, 5, 4099):
        x = torch.from_numpy(crafted_rle_rows(n, length, rng)).to(cuda, dtype)
        for view in (x, _offset(x)):
            before = rle_encode_candidate.launches
            got = rle_encode_candidate(view)
            torch.cuda.synchronize()
            assert rle_encode_candidate.launches == before + 1
            want = rle_encode_candidate_ref(view)
            assert got[0].dtype == torch.int16 and got[1].dtype == torch.int32
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("shape", [(64, 128), (7, 2), (3, 130), (1, 2),
                                   (33, 2048), "offset view"])
def test_plane_color_kernel_matches_plain_version(cuda, shape):
    """The plane colour kernel (``profiles/plane_color.py``): identical to
    the repeat + ``ycbcr_planes_to_rgb`` planes, including the 0/255
    extremes, widths off its 16-pixel step and unaligned views."""
    from lz4jpeg_tpu_torch.profiles.plane_color import (
        plane_color,
        plane_color_ref,
    )

    n, w = (9, 96) if shape == "offset view" else shape
    rng = np.random.default_rng(n * w)
    y = torch.from_numpy(rng.integers(0, 256, size=(n, w), dtype=np.uint8))
    cr, cb = (torch.from_numpy(rng.integers(0, 256, size=(n, w // 2),
                                            dtype=np.uint8)) for _ in range(2))
    y[0], cr[0], cb[0] = 255, 255, 0
    y, cr, cb = y.to(cuda), cr.to(cuda), cb.to(cuda)
    if shape == "offset view":
        y, cr, cb = _offset(y), _offset(cr), _offset(cb)
    before = plane_color.launches
    got = plane_color(y, cr, cb)
    torch.cuda.synchronize()
    assert plane_color.launches == before + 1
    for a, b in zip(got, plane_color_ref(y, cr, cb)):
        assert a.dtype == torch.uint8 and a.shape == (n, w)
        assert torch.equal(a, b)


def test_candidate_abs_on_the_card(cuda, tmp_path):
    """Both A/Bs at small scale on the card: gates, launch guards, the card
    named in the artifact."""
    import json

    from lz4jpeg_tpu_torch.profiles.candidates_ab import run_candidates_ab
    from lz4jpeg_tpu_torch.profiles.plane_color import run_plane_color_ab

    ab = run_candidates_ab(n_blocks=4096, chain=2, runs=1, device=cuda,
                           output=str(tmp_path / "ab.json"))
    pc = run_plane_color_ab(size=64, batch=2, runs=1, device=cuda)
    assert json.loads((tmp_path / "ab.json").read_text())["card"] == ab["card"]
    assert set(ab["ops"]) == {"fused_forward", "fused_inverse", "rle_encode"}
    assert ab["device"] == pc["device"] == str(cuda) and pc["card"]


# The forward megakernel's attribution variants (profiles/megakernel.py):
# each against its plain version by the one-step rule of ``variant_flips``
# (the bare rungs identical), the K1 rows identical to ``forward_combined``.
# Flips: at most ``flip_limit`` of the outputs (1e-5; 1e-3 for the raw,
# unsnapped dots), and one flip at these small shapes, where a single tie
# already passes 1e-5.
# Shapes: the runs' gate, one band short of every T, a last band of 2 tiles
# (W = 2064) and block rows of 6 tiles (coefficient-major runs that are not
# 16-byte aligned).
PROBE_SHAPES = [(2, 64, 128), (1, 16, 32), (1, 16, 2064), (2, 24, 48)]


@pytest.mark.parametrize("shape", PROBE_SHAPES)
def test_megakernel_variants_match_plain_versions(cuda, shape):
    from lz4jpeg_tpu_torch.profiles import megakernel as mk

    x = mk.noise_batch(*shape, seed=sum(shape)).to(cuda)
    k1 = forward_combined(x, LUM, CHR)
    for v in mk.RGB_VARIANTS:
        before = mk.megakernel_variant.launches
        got = mk.megakernel_variant(x, v.name, LUM, CHR)
        torch.cuda.synchronize()
        assert mk.megakernel_variant.launches == before + 1
        want = mk.megakernel_variant_ref(x, v.name, LUM, CHR)
        flips = mk.variant_flips(x, got, want, v.name, LUM, CHR)
        assert flips <= max(1, mk.flip_limit(v.name) * got.numel()), (
            v.name, flips)
        if v.name in mk.SAME_AS_K1:
            assert torch.equal(got, k1), v.name


def test_megakernel_variant_attributes(cuda):
    from lz4jpeg_tpu_torch.profiles import megakernel as mk

    attrs = {v.name: mk.variant_attributes(v.name, cuda) for v in mk.VARIANTS}
    assert attrs["full"]["ctas_per_sm"] == 3
    assert attrs["full"]["shared_bytes"] == 73_728
    assert attrs["band_128"]["ctas_per_sm"] == 1
    for name, a in attrs.items():
        assert 0 < a["registers"] <= 255 and a["ctas_per_sm"] >= 1, name


def test_megakernel_variant_refuses_what_the_probes_do_not_run(cuda):
    from lz4jpeg_tpu_torch.profiles import megakernel as mk

    x = mk.noise_batch(1, 16, 32, seed=0).to(cuda)
    buf = torch.empty(x.numel() + 1, dtype=torch.uint8, device=cuda)
    view = buf[1:].view(x.shape).copy_(x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mk.megakernel_variant(view, "full", LUM, CHR)
    with pytest.raises(ValueError, match="W·3 % 16"):
        mk.megakernel_variant(x[:, :, :24].contiguous(), "full", LUM, CHR)


def test_megakernel_probe_runs_on_the_card(cuda, tmp_path):
    import json

    from lz4jpeg_tpu_torch.profiles.megakernel_ablate import (
        run_megakernel_ablation,
    )
    from lz4jpeg_tpu_torch.profiles.megakernel_dma import run_megakernel_ladder

    for run in (run_megakernel_ablation, run_megakernel_ladder):
        res = run(cuda, frames=2, side=256, runs=1, chain=2,
                  output=str(tmp_path / "run.json"))
        assert json.loads((tmp_path / "run.json").read_text())["card"]
        for row in res["rows"]:
            assert row["ms"] > 0 and row["registers"] > 0, row


# The layout variants (profiles/megakernel.py's KT variants): each against its
# plain version by the one-step rule (the copy rows identical, the split
# stage's run counts equal to its nonzero words), the K1-arithmetic rows
# identical to ``forward_combined`` on ``rgb_to_kt`` of the same frames.
# Shapes: the runs' gate and a last band of 32 tiles (N = 544); then N =
# 4,144, ragged for every T (N % 16 == 0, N % 32 ≠ 0).
KT_SHAPES = [(2, 64, 128), (1, 16, 2176)]


@pytest.mark.parametrize("shape", KT_SHAPES)
def test_megakernel_kt_variants_match_plain_and_k1(cuda, shape):
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import rgb_to_kt
    from lz4jpeg_tpu_torch.profiles import megakernel as mk

    x = mk.noise_batch(*shape, seed=sum(shape), runs=True).to(cuda)
    kt = rgb_to_kt(x)
    k1 = forward_combined(x, LUM, CHR)
    for v in mk.KT_VARIANTS:
        before = mk.megakernel_variant.launches
        got = mk.megakernel_variant(kt, v.name, LUM, CHR)
        torch.cuda.synchronize()
        assert mk.megakernel_variant.launches == before + 1
        want = mk.megakernel_variant_ref(kt, v.name, LUM, CHR)
        flips = mk.variant_flips(kt, got, want, v.name, LUM, CHR)
        assert flips <= max(1, mk.flip_limit(v.name) * mk.combined(got).numel())
        if v.name in mk.KT_SAME_AS_K1:
            assert torch.equal(mk.combined(got), k1), v.name


def test_megakernel_kt_variants_on_a_ragged_n(cuda):
    from lz4jpeg_tpu_torch.profiles import megakernel as mk

    kt = mk.noise_kt(64 * 64 + 48, seed=7).to(cuda)
    for v in mk.KT_VARIANTS:
        got = mk.megakernel_variant(kt, v.name, LUM, CHR)
        torch.cuda.synchronize()
        want = mk.megakernel_variant_ref(kt, v.name, LUM, CHR)
        flips = mk.variant_flips(kt, got, want, v.name, LUM, CHR)
        assert flips <= max(1, mk.flip_limit(v.name) * mk.combined(got).numel())


def test_megakernel_kt_variant_refuses_what_the_route_does_not_take(cuda):
    import ctypes

    from lz4jpeg_tpu_torch.profiles import megakernel as mk

    kt = mk.noise_kt(100, seed=0).to(cuda)
    with pytest.raises(ValueError, match="N % 16"):
        mk.megakernel_variant(kt, "kt_full", LUM, CHR)
    buf = torch.empty(3 * 64 * 96 + 1, dtype=torch.uint8, device=cuda)
    view = buf[1:].view(3, 64, 96)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mk.megakernel_variant(view, "kt_full", LUM, CHR)
    lib = mk.load_kernel()
    out = torch.empty((100, 128), dtype=torch.int16, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    ptrs = (ctypes.c_void_p * 1)(out.data_ptr())
    kt_id = mk.VARIANTS.index(mk.BY_NAME["kt_full"])
    assert lib.fwd_probe_kt_launch(kt_id, kt.data_ptr(), ptrs, 0, 100,
                                   stream) != 0
    assert lib.fwd_probe_kt_launch(0, kt.data_ptr(), ptrs, 0, 96, stream) != 0
    assert lib.fwd_probe_launch(kt_id, kt.data_ptr(), out.data_ptr(), 0, 1, 8,
                                16, stream) != 0


def test_megakernel_kt_variant_attributes(cuda):
    from lz4jpeg_tpu_torch.profiles import megakernel as mk

    attrs = {v.name: mk.variant_attributes(v.name, cuda)
             for v in mk.KT_VARIANTS}
    for name in ("kt_split_runs", "kt_full", "kt_basis_a", "kt_dct",
                 "kt_copy"):
        assert attrs[name]["shared_bytes"] == 73_728, name
        assert attrs[name]["ctas_per_sm"] == 3, name
    assert attrs["kt_full_128"]["ctas_per_sm"] == 1
    assert attrs["kt_copy_128"]["ctas_per_sm"] == 1
    for name, a in attrs.items():
        assert 0 < a["registers"] <= 255 and a["ctas_per_sm"] >= 1, name


def test_megakernel_layout_runs_on_the_card(cuda, tmp_path):
    import json

    from lz4jpeg_tpu_torch.profiles.megakernel_kt import run_megakernel_kt
    from lz4jpeg_tpu_torch.profiles.megakernel_t import run_megakernel_t
    from lz4jpeg_tpu_torch.profiles.megakernel_v2 import run_megakernel_v2

    for run in (run_megakernel_kt, run_megakernel_t, run_megakernel_v2):
        res = run(cuda, frames=2, side=256, runs=1, chain=2,
                  output=str(tmp_path / "run.json"))
        assert json.loads((tmp_path / "run.json").read_text())["card"]
        assert res["plain_ms"] > 0
        for row in res["rows"]:
            assert row["ms"] > 0 and row["bound_ms"] > 0, row


# The matcher sorts and the membership decode (profiles/bitonic_sort.py,
# profiles/bucket_partition.py, profiles/rle_decode.py): integer kernels,
# identical to their plain versions; the sort also to torch.sort +
# torch.gather, its replay variant returning the input payload.


@pytest.mark.parametrize("record", [False, True])
def test_bitonic_sort_matches_plain_and_torch_sort(cuda, record):
    from lz4jpeg_tpu_torch.profiles import bitonic_sort as bs

    keys, pay = bs.probe_blocks(3, seed=13)
    k, p = torch.from_numpy(keys).to(cuda), torch.from_numpy(pay).to(cuda)
    before = bs.bitonic_sort_blocks.launches
    got = bs.bitonic_sort_blocks(k.view(3, 128, 128), p.view(3, 128, 128),
                                 record)
    torch.cuda.synchronize()
    assert bs.bitonic_sort_blocks.launches == before + 1
    assert got[0].shape == (3, 128, 128)
    want = bs.bitonic_sort_blocks_ref(k, p, record)
    assert torch.equal(got[0].view(3, -1), want[0])
    assert torch.equal(got[1].view(3, -1), want[1])
    lib_k, lib_p = bs.sort_gather(k, p)
    assert torch.equal(want[0], lib_k)
    assert torch.equal(want[1], p if record else lib_p)


@pytest.mark.parametrize("record", [False, True])
def test_bitonic_sort_on_duplicates_and_an_offset_view(cuda, record):
    from lz4jpeg_tpu_torch.profiles import bitonic_sort as bs

    gen = torch.Generator(device=cuda).manual_seed(3)
    keys = torch.randint(0, 9, (2, bs.SLOTS), dtype=torch.int32, device=cuda,
                         generator=gen)
    pay = torch.arange(2 * bs.SLOTS, dtype=torch.int32, device=cuda).view(2, -1)
    buf = torch.empty(keys.numel() + 1, dtype=torch.int32, device=cuda)
    view = buf[1:].view(keys.shape).copy_(keys)
    assert view.data_ptr() % 16
    got = bs.bitonic_sort_blocks(view, pay, record)
    want = bs.bitonic_sort_blocks_ref(keys, pay, record)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_bitonic_sort_refusals_and_attributes(cuda):
    from lz4jpeg_tpu_torch.profiles import bitonic_sort as bs

    x = torch.zeros((1, 128, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bs.bitonic_sort_blocks(x, x)
    lib = bs.load_kernel()
    y = torch.zeros((1, bs.SLOTS + 1), dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert lib.bitonic_sort_launch(y[:, 1:].data_ptr(), y.data_ptr(),
                                   y.data_ptr(), y.data_ptr(), 1, 0,
                                   stream) != 0
    plain, replay = bs.sort_attributes(False, cuda), bs.sort_attributes(True, cuda)
    assert plain["shared_bytes"] == 131_072 and replay["shared_bytes"] == 173_056
    assert plain["ctas_per_sm"] == replay["ctas_per_sm"] == 1


@pytest.mark.parametrize("name", ["concentration_stages",
                                  "compare_exchange_stages"])
def test_stage_kernels_match_plain(cuda, name):
    from lz4jpeg_tpu_torch.profiles import bucket_partition as bp

    _, fn, ref, _ = bp.KERNELS[name]
    x = bp.probe_tiles(3, seed=2).to(cuda)
    buf = torch.empty(x.numel() + 1, dtype=torch.int32, device=cuda)
    view = buf[1:].view(x.shape).copy_(x)
    for v in (x, view):
        before = fn.launches
        got = fn(v)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.equal(got, ref(x))


@pytest.mark.parametrize("k", [64, 32])
def test_membership_decode_matches_plain_and_k6(cuda, k):
    from lz4jpeg_tpu_torch.profiles import rle_decode as rd

    words, lengths = crafted_packed16_rows(k, np.random.default_rng(k),
                                           n_random=4087)
    w, lens = torch.from_numpy(words).to(cuda), torch.from_numpy(lengths).to(cuda)
    for out_size in (k, k // 2 + 3, 1):
        before = rd.rle_decode_membership.launches
        got = rd.rle_decode_membership(w, lens, out_size)
        torch.cuda.synchronize()
        assert rd.rle_decode_membership.launches == before + 1
        assert torch.equal(got, rd.rle_decode_membership_ref(w, lens, out_size))
        assert torch.equal(got, pack16.pack16_decode(w, lens, out_size))


def test_membership_decode_refusals(cuda):
    from lz4jpeg_tpu_torch.profiles import rle_decode as rd

    lib = rd.load_kernel()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for k, out_size in ((16, 16), (64, 65), (32, 0)):
        w = torch.zeros((4, k), dtype=torch.int16, device=cuda)
        lens = torch.zeros((4,), dtype=torch.int32, device=cuda)
        out = torch.empty((4, max(out_size, 1)), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError):
            rd.rle_decode_membership(w, lens, out_size)
        assert lib.rle_membership_launch(w.data_ptr(), lens.data_ptr(),
                                         out.data_ptr(), 4, k, out_size,
                                         stream) != 0


def test_matcher_sort_runners_on_the_card(cuda, tmp_path):
    import json

    from lz4jpeg_tpu_torch.profiles.bitonic_sort import run_bitonic_sort
    from lz4jpeg_tpu_torch.profiles.bucket_partition import run_bucket_partition
    from lz4jpeg_tpu_torch.profiles.rle_decode import run_rle_decode_ab

    out = tmp_path / "run.json"
    sort = run_bitonic_sort(cuda, blocks=16, check_blocks=2, runs=1, reps=1,
                            output=str(out))
    assert json.loads(out.read_text())["card"]
    assert all(r["ms"] > 0 for r in sort["rows"]) and sort["issue_bound_ms"] > 0
    stages = run_bucket_partition(cuda, blocks=(4,), runs=1, reps=1)
    for rec in stages["sizes"][0]["kernels"].values():
        assert rec["ms"] > 0 and rec["registers"] > 0
    ab = run_rle_decode_ab(cuda, frames=1, side=256, runs=1, reps=1)
    assert ab["versions"]["membership kernel"]["ms"] > 0 and ab["card"]


# K7's phase split (profiles/rle_expand.py): the three copies and the phase
# variants of K7's template, identical to their plain versions; the full
# phase is K7 itself.


@pytest.mark.parametrize("rows,k,bw", [(4096, 64, 256), (2048, 32, 128),
                                       (4099, 64, 4099), (917, 64, 131),
                                       (1, 8, 1), (30, 24, 5), (100, 4104, 10)])
def test_rle_expand_copies_match_plain(cuda, rows, k, bw):
    from lz4jpeg_tpu_torch.profiles import rle_expand as rx

    p = torch.from_numpy(rx.stream_values(rows, k, np.random.default_rng(rows)))
    p = p.to(cuda)
    views = [p, _offset_view(p)] + ([p.view(-1, 128)] if rows * k % 128 == 0
                                    else [])
    for x in views:
        w = bw if x.shape[1] == k else x.shape[0]  # the wide view: one slab
        for fn, ref in ((rx.copy_rm, rx.copy_rm_ref),
                        (rx.copy_t_contig, rx.copy_t_contig_ref),
                        (lambda v: rx.copy_t_slab(v, w),
                         lambda v: rx.copy_t_slab_ref(v, w))):
            got = fn(x)
            torch.cuda.synchronize()
            assert torch.equal(got, ref(x))
    before = rx.copy_rm.launches
    rx.copy_rm(p)
    assert rx.copy_rm.launches == before + 1


@pytest.mark.parametrize("rows,k", [(1, 8), (1023, 8), (1024, 8), (1025, 8),
                                    (3073, 8), (4096, 64), (2, 4104),
                                    (100, 4104)])
def test_copy_rm_runs_on_the_streaming_template(cuda, rows, k):
    """copy_rm at K 8, 64 and 4,104, rows · K · 2 bytes at and around the
    template's chunk edges, aligned, as an offset view and as the wide view:
    equal to the plain version, one launch a call, the C plan's CTAs those
    of the mirror over the bytes."""
    from lz4jpeg_tpu_torch.ops import stream
    from lz4jpeg_tpu_torch.profiles import rle_expand as rx

    p = torch.from_numpy(rx.stream_values(rows, k, np.random.default_rng(rows)))
    p = p.to(cuda)
    views = [p, _offset_view(p)] + ([p.view(-1, 128)] if rows * k % 128 == 0
                                    else [])
    for x in views:
        before = rx.copy_rm.launches
        got = rx.copy_rm(x)
        torch.cuda.synchronize()
        assert rx.copy_rm.launches == before + 1
        assert torch.equal(got, rx.copy_rm_ref(x))
        n = x.numel() * 2
        assert stream.launch_plan(x.data_ptr(), got.data_ptr(), n) == \
            stream.copy_plan(n, x.data_ptr() % 16, got.data_ptr() % 16)
    a = rx.copy_attributes(rx.COPY_RM, cuda)
    assert a["registers"] > 0 and a["ctas_per_sm"] >= 1


@pytest.mark.parametrize("k", [64, 32])
def test_rle_expand_phases_match_plain_and_k7(cuda, k):
    from lz4jpeg_tpu_torch.profiles import rle_expand as rx

    rng = np.random.default_rng(k)
    vals = torch.from_numpy(rx.ablate_symbols(64 * 7, k, rng)).to(cuda)
    words, lens = pack16.pack16_encode(vals)
    cw, cl = crafted_packed16_rows(k, rng, n_random=4084)
    cases = [(words, lens, 64), (words, lens, 7),
             (torch.from_numpy(cw).to(cuda), torch.from_numpy(cl).to(cuda), 8)]
    cases.append((_offset_view(cases[-1][0]), cases[-1][1], 8))
    for w, l, bw in cases:
        for phase in rx.PHASES:
            counter = (pack16.pack16_decode_plane if phase == "full"
                       else rx.expand_plane_phase)
            before = counter.launches
            got = rx.expand_plane_phase(w, l, bw, phase)
            torch.cuda.synchronize()
            assert counter.launches == before + 1
            assert torch.equal(got, rx.expand_plane_phase_ref(w, l, bw, phase))
        assert torch.equal(got, pack16.pack16_decode_plane_ref(w, l, bw))


def test_rle_expand_refusals_and_attributes(cuda):
    from lz4jpeg_tpu_torch.profiles import rle_expand as rx

    copy_lib, phase_lib = rx.load_copy_kernels(), rx.load_phase_kernels()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    x = torch.zeros((1000, 64), dtype=torch.int16, device=cuda)
    sink = torch.empty_like(x)
    with pytest.raises(ValueError):
        rx.copy_rm(x[:, :12].contiguous())
    assert copy_lib.rle_expand_copy_rm_launch(x.data_ptr(), sink.data_ptr(),
                                              16, 12, stream) != 0
    with pytest.raises(ValueError):
        rx.copy_t_slab(x, 256)
    assert copy_lib.rle_expand_copy_t_slab_launch(
        x.data_ptr(), sink.data_ptr(), 1000, 64, 256, stream) != 0
    lens = torch.zeros((16,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        rx.expand_plane_phase(x[:16, :16].contiguous(), lens, 8, "full")
    assert phase_lib.expand16_probe_launch(3, x.data_ptr(), lens.data_ptr(),
                                           sink.data_ptr(), 2, 8, 16,
                                           stream) != 0
    # the full phase is K7, not built in the probe library
    assert phase_lib.expand16_probe_launch(4, x.data_ptr(), lens.data_ptr(),
                                           sink.data_ptr(), 2, 8, 64,
                                           stream) != 0
    for phase in rx.PHASES:
        for seg in rx.PHASE_SEGMENTS:
            a = rx.phase_attributes(phase, seg, cuda)
            assert a["registers"] > 0 and a["ctas_per_sm"] > 0, (phase, seg)
    assert rx.copy_attributes(rx.COPY_RM, cuda)["ctas_per_sm"] > 0


def test_rle_expand_runners_on_the_card(cuda, tmp_path):
    import json

    from lz4jpeg_tpu_torch.profiles.rle_expand_ablate import (
        run_rle_expand_ablate,
    )
    from lz4jpeg_tpu_torch.profiles.rle_expand_rm import run_rle_expand_rm

    out = tmp_path / "run.json"
    rm = run_rle_expand_rm(cuda, frames=1, side=256, runs=1, reps=1,
                           output=str(out))
    assert json.loads(out.read_text())["card"]
    assert all(r["ms"] > 0 and r["launches"] > 0 for r in rm["copies"])
    ab = run_rle_expand_ablate(cuda, frames=1, side=256, runs=1, reps=1)
    for c in ab["channels"].values():
        assert [p["phase"] for p in c["phases"]] == [
            "copyT", "unpack", "matmul", "dist", "full"]
        assert all(p["ms"] > 0 and p["registers"] > 0 for p in c["phases"])


# -- P slices 5(a) and 5(b): the sublane RLE, the casts, the fused-DCT gates --
# The sublane RLE, the casts, the transpose and the split identical to their
# plain versions; the basis product within 64 · 2^-24 · Σ|x·m| of float64.


@pytest.mark.parametrize("seg", [32, 64])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
def test_sublane_rle_matches_plain(cuda, seg, dtype):
    from lz4jpeg_tpu_torch.profiles import sublane_rle as sr

    rng = np.random.default_rng(seg)
    for cols in (1, 131, 256, 70_001):
        x = torch.from_numpy(sr.probe_values(seg, cols, rng)).to(dtype).to(cuda)
        for v in (x, _offset(x)):
            before = sr.sublane_rle.launches
            packed, runs = sr.sublane_rle(v)
            torch.cuda.synchronize()
            assert sr.sublane_rle.launches == before + 1
            want_p, want_r = sr.sublane_rle_ref(v)
            assert torch.equal(packed, want_p) and torch.equal(runs, want_r)
    x = sr.uniform_values(seg, 4099, cuda, seg)
    packed, runs = sr.sublane_rle(x)
    words, lengths = pack16.pack16_encode_kt(x.view(1, seg, -1))
    assert torch.equal(words, packed.t()) and torch.equal(lengths, 2 * runs[0])


def test_sublane_rle_refusals_and_attributes(cuda):
    from lz4jpeg_tpu_torch.profiles import sublane_rle as sr

    lib = sr.load_kernel()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    x = torch.zeros((16, 128), dtype=torch.int32, device=cuda)
    sink = torch.empty((64, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        sr.sublane_rle(x)
    assert lib.sublane_rle_launch(x.data_ptr(), 4, sink.data_ptr(),
                                  sink.data_ptr(), 16, 128, stream) != 0
    assert lib.sublane_rle_launch(x.data_ptr(), 8, sink.data_ptr(),
                                  sink.data_ptr(), 64, 128, stream) != 0
    with pytest.raises(ValueError):
        sr.sublane_rle(torch.zeros((2, 64, 128), dtype=torch.int32, device=cuda))
    for seg in sr.SEGMENTS:
        for b in (2, 4):
            a = sr.attributes(seg, b, cuda)
            assert a["registers"] > 0 and a["ctas_per_sm"] > 0, (seg, b)


@pytest.mark.parametrize("pair", range(7))
def test_casts_match_x_to(cuda, pair):
    from lz4jpeg_tpu_torch.profiles import casts

    src, dst = casts.PAIRS[pair]
    rng = np.random.default_rng(pair)
    full = casts.full_range(src, rng).to(cuda)
    cases = [casts.probe_values(src, rng).to(cuda), full, _offset(full),
             full[:full.numel() - 5], full[:7],
             casts.random_values(src, 1_000_003, cuda, pair)]
    for x in cases:
        before = casts.cast.launches
        got = casts.cast(x, dst)
        torch.cuda.synchronize()
        assert casts.cast.launches == before + 1
        assert casts.same(got, x.to(dst)), (casts.pair_name(pair), x.shape)
    assert casts.attributes(pair, cuda)["ctas_per_sm"] > 0


def test_cast_refusals(cuda):
    from lz4jpeg_tpu_torch.profiles import casts

    lib = casts.load_kernel()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    x = torch.zeros(64, dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        casts.cast(x, torch.float64)
    with pytest.raises(ValueError):
        casts.cast(x.float(), torch.int32)
    assert lib.cast_launch(7, x.data_ptr(), x.data_ptr(), 64, stream) != 0
    assert lib.cast_launch(0, x.data_ptr(), x.data_ptr(), -1, stream) != 0
    assert lib.cast_launch(0, x.data_ptr() + 1, x.data_ptr(), 8, stream) != 0


@pytest.mark.parametrize("n", [512, 1, 65, 4099, 262_147, "offset view"])
def test_basis_dot_within_its_bound(cuda, n):
    from lz4jpeg_tpu_torch.profiles import dct_gates as dg

    rng = np.random.default_rng(7)
    m = dg.luma_basis(cuda)
    x = dg.probe_pixels(4099 if n == "offset view" else n, rng).to(cuda)
    if n == "offset view":
        x = _offset(x)
    before = dg.basis_dot.launches
    got = dg.basis_dot(x, m)
    torch.cuda.synchronize()
    assert dg.basis_dot.launches == before + 1
    assert dg.dot_error(got, x, m)["within"]
    assert dg.dot_error(dg.basis_dot_ref(x, m), x, m)["within"]
    cmp = dg.ulp_compare(got, dg.basis_dot_ref(x, m))
    assert cmp["outputs"] == got.numel()


@pytest.mark.parametrize("shape", [(8, 256, 8), (8, 128, 4), (3, 7, 5),
                                   (2, 1000, 64), (1, 1, 1), (5, 129, 3),
                                   (4, 300, 33), "offset view"])
def test_minor_transpose_matches_plain(cuda, shape):
    from lz4jpeg_tpu_torch.profiles import dct_gates as dg

    x = dg.device_pixels((6, 131, 8) if shape == "offset view" else shape,
                         cuda, 3)
    if shape == "offset view":
        x = _offset(x)
    before = dg.minor_transpose.launches
    got = dg.minor_transpose(x)
    torch.cuda.synchronize()
    assert dg.minor_transpose.launches == before + 1
    assert torch.equal(got, dg.minor_transpose_ref(x))


def test_lane_split_runs_on_the_copy_kernel(cuda):
    from lz4jpeg_tpu_torch.ops.stream import stream_copy
    from lz4jpeg_tpu_torch.profiles import dct_gates as dg

    for shape, tw in (((8, 2048), 8), ((3, 24), 4), ((5, 7), 7)):
        x = dg.device_pixels(shape, cuda, 4)
        for v in (x, _offset(x)):
            before = stream_copy.launches
            got = dg.lane_split(v, tw)
            torch.cuda.synchronize()
            assert stream_copy.launches == before + 1
            assert torch.equal(got, dg.lane_split_ref(v, tw))
            assert got.shape == (shape[0], shape[1] // tw, tw)


def test_dct_gate_refusals_and_attributes(cuda):
    from lz4jpeg_tpu_torch.profiles import dct_gates as dg

    lib = dg.load_kernel()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    x = torch.zeros((64, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        dg.basis_dot(x[:, :32].contiguous(), x)
    assert lib.basis_dot_launch(x.data_ptr(), x.data_ptr(), x.data_ptr(), 64,
                                32, 64, stream) != 0
    assert lib.basis_dot_launch(x.data_ptr() + 4, x.data_ptr(), x.data_ptr(),
                                8, 64, 64, stream) != 0
    with pytest.raises(ValueError):
        dg.minor_transpose(torch.zeros((8, 256, 0), device=cuda))
    assert lib.minor_transpose_launch(x.data_ptr(), x.data_ptr(), 8, 256, 0,
                                      stream) != 0
    assert lib.minor_transpose_launch(x.data_ptr(), x.data_ptr(), 1, 1, 65,
                                      stream) != 0
    with pytest.raises(ValueError):
        dg.lane_split(x, 5)
    assert dg.attributes(dg.DOT, device=cuda)["registers"] > 0
    for tw in (1, 4, 8, 64):
        assert dg.attributes(dg.TRANSPOSE, tw, cuda)["ctas_per_sm"] > 0


def test_gate_runners_on_the_card(cuda, tmp_path):
    import json

    from lz4jpeg_tpu_torch.profiles import casts, dct_gates
    from lz4jpeg_tpu_torch.profiles.plane_exact import run_plane_exact
    from lz4jpeg_tpu_torch.profiles.sublane_butterfly import (
        run_sublane_butterfly,
    )

    out = tmp_path / "run.json"
    b = run_sublane_butterfly(cuda, cols=4096, runs=1, reps=1,
                              output=str(out))
    assert json.loads(out.read_text())["card"]
    assert all(w["ms"] > 0 and w["launches"] > 0 for w in b["ways"])
    p = run_plane_exact(cuda, sizes=(256,), cols=4096, runs=1, reps=1)
    assert [c["seg"] for c in p["checks"]] == [32, 64]
    assert p["seg"] == 32 and p["ms"] > 0 and p["launches"] > 0
    c = casts.run_casts(cuda, elements=1 << 20, runs=1, reps=1)
    assert len(c["pairs"]) == 7 and all(r["launches"] > 0 for r in c["pairs"])
    g = dct_gates.run_dct_gates(cuda, rows=4096, bands=64, runs=1, reps=1)
    assert len(g["timed"]) == 4 and all(r["ms"] > 0 for r in g["timed"])


# -- P slices 5(c) and 5(d): the colour probe, the MCU relayout, the one-hot ----
# gathers.  All three identical to their plain versions (the colour probe's
# float64 emulation of the probe's FMA order, split_mcus's copy, the dense
# one-hot product in float64); every full gather row equal to torch.gather.


@pytest.mark.parametrize("case", ["probe", "cube 0", "cube 1", (3, 130, 3),
                                  (1, 2, 3), (5, 18, 3), (2, 64, 2048, 3),
                                  "offset view"])
def test_color_probe_matches_plain(cuda, case):
    from lz4jpeg_tpu_torch.profiles import pallas_color as pc

    if case == "probe":
        x = pc.probe_case(0).to(cuda)
    elif isinstance(case, str) and case.startswith("cube"):
        x = pc.colour_cube(int(case[-1]), cuda)
    else:
        shape = (3, 130, 3) if case == "offset view" else case
        x = torch.from_numpy(np.random.default_rng(5).integers(
            0, 256, size=shape, dtype=np.uint8)).to(cuda)
        if case == "offset view":
            x = _offset(x)
    before = pc.color_probe.launches
    got = pc.color_probe(x)
    torch.cuda.synchronize()
    assert pc.color_probe.launches == before + 1
    for a, b in zip(got, pc.color_probe_ref(x)):
        assert torch.equal(a, b)
    if case == "probe":
        assert pc.mismatches(got, x) == {"y": 1, "cr": 0, "cb": 3}


def test_color_probe_refusals_and_attributes(cuda):
    from lz4jpeg_tpu_torch.profiles import pallas_color as pc

    lib = pc.load_kernel()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    x = torch.zeros((4, 6, 3), dtype=torch.uint8, device=cuda)
    y = torch.empty((64,), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        pc.color_probe(x[:, :3].contiguous())
    with pytest.raises(TypeError):
        pc.color_probe(x.to(torch.int16))
    assert lib.rgb_color_launch(x.data_ptr(), y.data_ptr(), y.data_ptr(),
                                y.data_ptr(), 4, 3, stream) != 0
    assert lib.rgb_color_launch(x.data_ptr(), y.data_ptr() + 2, y.data_ptr(),
                                y.data_ptr(), 4, 6, stream) != 0
    a = pc.attributes(cuda)
    assert a["registers"] > 0 and a["ctas_per_sm"] > 0


@pytest.mark.parametrize("shape,tw", [((4, 2048, 2048), 8), ((4, 2048, 1024), 4),
                                      ((16, 20), 4), ((8, 24), 8),
                                      ((3, 24, 4104), 8), ((1, 8, 2064), 4),
                                      ((2, 8, 4), 4)])
def test_mcu_relayout_matches_plain(cuda, shape, tw):
    from lz4jpeg_tpu_torch.ops.color import split_mcus
    from lz4jpeg_tpu_torch.profiles import mcu_relayout as mr

    x = torch.from_numpy(np.random.default_rng(tw).integers(
        0, 256, size=shape, dtype=np.uint8)).to(cuda)
    for v in (x, _offset(x)):
        before = mr.mcu_relayout.launches
        got = mr.mcu_relayout(v, tw)
        torch.cuda.synchronize()
        assert mr.mcu_relayout.launches == before + 1
        assert torch.equal(got, mr.mcu_relayout_ref(v, tw))
    if tw == 8:
        want = split_mcus(x, x[..., ::2], x[..., ::2])[0]
    else:
        want = split_mcus(x.repeat_interleave(2, dim=-1), x, x)[1]
    assert torch.equal(got, want.reshape(got.shape))


def test_mcu_relayout_refusals_and_attributes(cuda):
    from lz4jpeg_tpu_torch.profiles import mcu_relayout as mr

    lib = mr.load_kernel()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    x = torch.zeros((8, 40), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        mr.mcu_relayout(x, 5)
    with pytest.raises(ValueError):
        mr.mcu_relayout(x[:, :36], 8)
    with pytest.raises(ValueError):
        mr.mcu_relayout(x[:4], 8)
    y = torch.empty((8, 48), dtype=torch.uint8, device=cuda)
    for args in ((1, 40, 5), (1, 36, 8), (-1, 40, 8), (1, 0, 4)):
        assert lib.mcu_relayout_launch(x.data_ptr(), y.data_ptr(), *args,
                                       stream) != 0
    for src, dst in ((x.data_ptr() + 4, y.data_ptr()),
                     (x.data_ptr(), y.data_ptr() + 8)):  # off 16 bytes
        assert lib.mcu_relayout_launch(src, dst, 1, 32, 8, stream) != 0
    for tw in mr.WIDTHS:
        assert mr.attributes(tw, cuda)["ctas_per_sm"] > 0


@pytest.mark.parametrize("blocks,p", [(2, 4096), (1, 2048), (3, 16_384),
                                      (1, 65_536)])
def test_onehot_gather_matches_plain(cuda, blocks, p):
    from lz4jpeg_tpu_torch.profiles import onehot_gather as og

    gen = torch.Generator(device=cuda).manual_seed(p)
    root = torch.randint(-300, p + 300, (blocks, p), dtype=torch.int32,
                         device=cuda, generator=gen)
    lit = torch.randint(0, 256, (blocks, p), dtype=torch.uint8, device=cuda,
                        generator=gen)
    for k in og.KERNELS:
        if p % k.step:
            continue
        for r in (root, _offset(root)):
            before = og.onehot_gather.launches
            got = og.onehot_gather(r, lit, k.name)
            torch.cuda.synchronize()
            assert og.onehot_gather.launches == before + 1
            assert torch.equal(got, og.onehot_gather_ref(r, lit, k.name)), k.name


@pytest.mark.parametrize("engine", ["device", "native"])
def test_onehot_gather_rows_equal_torch_gather_on_text(cuda, engine):
    from lz4jpeg_tpu_torch.ops.lz4t_decode import _trim_rows
    from lz4jpeg_tpu_torch.profiles import onehot_gather as og
    from lz4jpeg_tpu_torch.profiles.lz4t_mxu_gather import rooted_program

    text = generate_text(200_000, np.random.default_rng(9))
    frame = LZ4Codec(LZ4Config(mode="fast"), device=cuda).encode(
        text, engine=engine)
    lit, root, sizes, p, _ = rooted_program(frame)
    lit, root = torch.from_numpy(lit).to(cuda), torch.from_numpy(root).to(cuda)
    want = torch.gather(lit, 1, root.long())
    for row in og.ROWS:
        got = og.row_output(row, root, lit)
        torch.cuda.synchronize()
        assert torch.equal(got, og.row_output(row, root, lit,
                                              og.onehot_gather_ref)), row.name
        if og.BY_NAME[row.kernel].cut == og.FULL:
            assert torch.equal(got.to(torch.uint8), want), row.name
            assert _trim_rows(got.to(torch.uint8).cpu().numpy(), sizes) == text


def test_onehot_gather_refusals_and_attributes(cuda):
    from lz4jpeg_tpu_torch.profiles import onehot_gather as og

    lib = og.load_kernel()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    root = torch.zeros((1, 4096), dtype=torch.int32, device=cuda)
    lit = torch.zeros((1, 4096), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        og.onehot_gather(root[:, :3072].contiguous(), lit[:, :3072].contiguous(),
                         "hl_bf16_full_2048")
    with pytest.raises(ValueError):
        og.onehot_gather(root, lit, "g5")
    for args in ((9, 1, 4096), (1, 1, 3072), (6, 1, 2048), (1, -1, 4096),
                 (1, 1, 131_072)):
        i, b, p = args
        assert lib.onehot_gather_launch(i, root.data_ptr(), lit.data_ptr(),
                                        root.data_ptr(), b, p, stream) != 0
    assert lib.onehot_gather_launch(1, root.data_ptr(), lit.data_ptr() + 1,
                                    root.data_ptr(), 1, 4096, stream) != 0
    for k in og.KERNELS:
        a = og.attributes(k.name, cuda)
        assert a["registers"] > 0 and a["ctas_per_sm"] > 0, k.name


def test_colour_and_gather_runners_on_the_card(cuda, tmp_path):
    import json

    from lz4jpeg_tpu_torch.profiles.colorsplit3 import run_colorsplit3
    from lz4jpeg_tpu_torch.profiles.lz4t_mxu_gather import run_lz4t_mxu_gather
    from lz4jpeg_tpu_torch.profiles.pallas_color import run_pallas_color

    out = tmp_path / "c.json"
    c = run_pallas_color(cuda, frames=1, side=256, cube_rows=16, runs=1,
                         reps=1, output=str(out))
    assert json.loads(out.read_text())["card"]
    assert c["timed"]["ms"] > 0 and c["timed"]["launches"] > 0
    s = run_colorsplit3(cuda, frames=1, side=256, runs=1, reps=1)
    assert s["checks"]["C"]["mismatches"] == 0 and len(s["rows"]) == 6
    assert all(r["ms"] > 0 and r["launches"] > 0 for r in s["relayout"])
    g = run_lz4t_mxu_gather(cuda, text_bytes=200_000, runs=1, reps=1)
    assert len(g["rows"]) == 10 and all(r["ms"] > 0 for r in g["rows"])
    assert all(r["launches"] > 0 for r in g["rows"])


# -- the redesigned one-hot gathers and the transpose's two routes ----------------
# The gathers' persistent CTAs walk contiguous runs of steps and restage a
# block's slab when a run enters it: block counts that do not divide among
# the resident CTAs make runs cross blocks.  The transpose takes its vector
# route for tw 2, 4, 8 with bw % 4 == 0 and 16-byte aligned bases, its tile
# route otherwise; each route's launches are counted.  Identity throughout.


@pytest.mark.parametrize("blocks", [1, 3, 133])
@pytest.mark.parametrize("p", [2048, 4096, 65_536])
def test_onehot_gather_runs_that_cross_blocks(cuda, blocks, p):
    from lz4jpeg_tpu_torch.profiles import onehot_gather as og

    gen = torch.Generator(device=cuda).manual_seed(blocks * p)
    root = torch.randint(-300, p + 300, (blocks, p), dtype=torch.int32,
                         device=cuda, generator=gen)
    lit = torch.randint(0, 256, (blocks, p), dtype=torch.uint8, device=cuda,
                        generator=gen)
    for k in og.KERNELS:
        if p % k.step:
            continue
        for r in (root, _offset(root)):
            want = og.onehot_gather_ref(r, lit, k.name)
            before = og.onehot_gather.launches
            got = og.onehot_gather(r, lit, k.name)
            alone = og.onehot_gather_prepared(
                r, og.literal_operand(lit, k), k.name)
            torch.cuda.synchronize()
            assert og.onehot_gather.launches == before + 2
            assert torch.equal(got, want), k.name
            assert torch.equal(alone, want), k.name


TRANSPOSE_ROUTES = [((3, 128, 4), "vector"), ((3, 256, 8), "vector"),
                    ((5, 132, 2), "vector"), ((2, 128, 2), "vector"),
                    ((4, 256, 4), "vector"), ((2, 132, 8), "vector"),
                    ((3, 130, 4), "tile"), ((2, 130, 8), "tile"),
                    ((2, 128, 3), "tile"), ((2, 256, 16), "tile"),
                    ((2, 128, 64), "tile"), ("offset view", "tile")]


@pytest.mark.parametrize("shape,route", TRANSPOSE_ROUTES)
def test_minor_transpose_takes_its_route(cuda, shape, route):
    from lz4jpeg_tpu_torch.profiles import dct_gates as dg

    x = dg.device_pixels((5, 128, 4) if shape == "offset view" else shape,
                         cuda, 7)
    if shape == "offset view":
        x = _offset(x)  # 4 bytes off the allocation: the tile route
    lib = dg.load_kernel()
    b, bw, tw = x.shape
    before = dict(dg.minor_transpose.routes)
    got = dg.minor_transpose(x)
    torch.cuda.synchronize()
    assert torch.equal(got, dg.minor_transpose_ref(x))
    assert dg.minor_transpose.routes[route] == before[route] + 1
    assert sum(dg.minor_transpose.routes.values()) == sum(before.values()) + 1
    assert dg.transpose_route(b, bw, tw, x.data_ptr(), got.data_ptr()) == route
    assert dg.ROUTES[lib.minor_transpose_route(x.data_ptr(), got.data_ptr(),
                                               b, bw, tw)] == route


def test_minor_transpose_vector_route_attributes(cuda):
    from lz4jpeg_tpu_torch.profiles import dct_gates as dg

    for tw in dg.VECTOR_TW:
        a = dg.attributes(dg.TRANSPOSE_VEC, tw, cuda)
        assert a["registers"] > 0 and a["ctas_per_sm"] > 0
        assert a["shared_bytes"] == 0
    with pytest.raises(RuntimeError):
        dg.attributes(dg.TRANSPOSE_VEC, 3, cuda)
