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


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32])
@pytest.mark.parametrize("case", ["aligned", "odd", "offset view", "empty"])
def test_stream_copy_matches_plain_version(cuda, dtype, case):
    """The copy kernel: the vector body with byte-wise head and tail (odd
    sizes, equal offsets) and the byte-wise route (a source one element
    off a 16-byte boundary, a 16-byte-aligned destination)."""
    from lz4jpeg_tpu_torch.ops.stream import stream_copy, stream_copy_ref

    n = {"aligned": 1 << 22, "odd": 1_000_003, "offset view": 65_537,
         "empty": 0}[case]
    gen = torch.Generator(device=cuda).manual_seed(n)
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
