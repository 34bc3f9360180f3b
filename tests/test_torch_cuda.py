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
The inverse megakernel (K9) against its plain version: every differing
pixel explained by one-step plane flips at summation ties
(``utils/parity.py::decode_flips``), within the same envelope; crafted
words at every lane identical.
Parity frames of a CUDA codec (K11) equal the CPU codec's and the native
encoder's byte for byte; the CLI on the card writes what its ``--device
cpu`` run writes, by the same rules.  K10 and K11, LZ4's greedy parses,
compute on integers: identity with their plain versions, dtypes included.
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
@pytest.mark.parametrize("n", [1, 5, 63, 64, 65, 513, 70_000, "offset view"])
def test_mcu_kernels_match_plain_versions(cuda, width, n):
    """The MCU transform kernels (``profiles/mcu.py``) against their plain
    versions (cuBLAS): identical up to one-step flips at summation ties
    (``utils/parity.py::transform_flips``), at most 1e-5 of the outputs, at
    tile counts around a ring chunk (64) and in unaligned views.  The
    inverse runs on the forward's coefficients; on the same × 8 ± 256 + 0.1
    (|z| ≥ 256 with a fraction: the mid and lo parts' votes; most pixels
    clamp); on the same plus a uniform fraction; on the coefficients of
    smooth tiles under the quality-100 table (|z| past 256 with pixels in
    range); and on the forward's with the DC set so that every sum lies
    near -1.2e7, where the epilogue's 32-bit floor would wrap to 255.  Each
    flip count is printed, with the share of pixels at 0 or 255."""
    from lz4jpeg_tpu_torch.ops.fused import _table_key, inverse_basis
    from lz4jpeg_tpu_torch.ops.quantize import scale_table
    from lz4jpeg_tpu_torch.profiles import mcu
    from lz4jpeg_tpu_torch.utils.inputs import smooth_tiles
    from lz4jpeg_tpu_torch.utils.parity import transform_flips

    table = LUM if width == 8 else CHR
    top = scale_table(table, 100)
    rows = 517 if n == "offset view" else n
    rng = np.random.default_rng(rows + width)
    tiles = torch.from_numpy(rng.integers(0, 256, size=(rows, 8, width),
                                          dtype=np.uint8)).to(cuda)
    zz = mcu.fused_forward_candidate_ref(tiles, table, width, 8)
    frac = torch.from_numpy(rng.uniform(-0.5, 0.5, tuple(zz.shape))).to(cuda)
    smooth = torch.from_numpy(smooth_tiles(rows, width, rng)).to(cuda)
    far = zz.clone()
    far[:, 0] = -1.2e7 / float(inverse_basis(width, 8, _table_key(table))[0, 0])
    inputs = {"codec": (zz, table),
              "|z| >= 256": (zz * 8 + torch.sign(zz) * 256 + 0.1, table),
              "fractions": ((zz + frac).float(), table),
              "quality 100": (mcu.fused_forward_candidate_ref(
                  smooth, top, width, 8), top),
              "far below zero": (far, table)}
    if n == "offset view":
        tiles = _offset(tiles)
        inputs = {k: (_offset(v), t) for k, (v, t) in inputs.items()}
    before = (mcu.fused_forward_candidate.launches,
              mcu.fused_inverse_candidate.launches)
    fwd = mcu.fused_forward_candidate(tiles, table, width, 8)
    invs = {k: mcu.fused_inverse_candidate(z, t, width, 8)
            for k, (z, t) in inputs.items()}
    torch.cuda.synchronize()
    assert (mcu.fused_forward_candidate.launches,
            mcu.fused_inverse_candidate.launches) == (before[0] + 1,
                                                      before[1] + len(inputs))
    assert fwd.dtype == torch.float32 and fwd.shape == (rows, 8 * width)
    f = transform_flips("forward", tiles, fwd, inputs["codec"][0], table,
                        width, 8)
    print(f"HW {8 * width} N {n}: forward {f} flips in {fwd.numel()}")
    assert f <= MAX_FLIP_SHARE * fwd.numel()
    for kind, inv in invs.items():
        z, t = inputs[kind]
        assert inv.dtype == torch.uint8 and inv.shape == (rows, 8, width)
        want = mcu.fused_inverse_candidate_ref(z, t, width, 8)
        i = transform_flips("inverse", z, inv, want, t, width, 8)
        clamped = ((want == 0) | (want == 255)).float().mean().item()
        print(f"HW {8 * width} N {n}: inverse {kind} {i} flips in "
              f"{inv.numel()}, {clamped:.1%} of the pixels at 0 or 255")
        assert i <= MAX_FLIP_SHARE * inv.numel()
    assert (invs["far below zero"] == 0).all()


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
    assert attrs["full"]["ctas_per_sm"] == 1
    assert attrs["full"]["shared_bytes"] == mk.K1_SMEM
    assert attrs["full"] == mk.k1_attributes(cuda)
    # the chunk sweep's frames: T = 128 at 2 groups, rows over the operands
    # (17 warps, 96 registers at most); T = 16 at 6 groups of 4 warps and 4
    # producer warps (28 warps, 72 registers)
    assert mk.rgb_frame("band_128")["groups"] == 2
    assert attrs["band_128"]["ctas_per_sm"] == 1
    assert attrs["band_128"]["registers"] <= 96
    assert mk.rgb_frame("band_16")["threads"] == 896
    assert attrs["band_16"]["registers"] <= 72
    for v in mk.RGB_VARIANTS:  # the frame's mirror
        assert attrs[v.name]["shared_bytes"] == mk.rgb_frame(v.name)["smem"], \
            v.name
    for name, a in attrs.items():
        assert 0 < a["registers"] <= 255 and a["ctas_per_sm"] >= 1, name


def _wave_shape(cuda):
    """(1, H, 512): one band a block row, one band more than the CTAs of a
    whole wave."""
    from lz4jpeg_tpu_torch.profiles import megakernel as mk

    resident = mk.launch_plan(1, 8, 512, cuda).resident
    return (1, 8 * (resident + 1), 512)


@pytest.mark.parametrize("route", ["bulk", "direct"])
@pytest.mark.parametrize("case", ["b256, many bands a CTA",
                                  "a band past a whole wave",
                                  "last band a row and 16 columns short"])
def test_k1_band_loop_edges(cuda, case, route):
    """K1 against its plain version where the band loop's plan is tested
    hardest: 8,192 bands on 132 CTAs (62 a CTA, both groups, every ring
    slot many times), a band count one past a whole wave (one CTA takes a
    second band), and a last block row of 7 image rows whose last band is
    62 tiles of 496 columns; by bulk copies (aligned) and by direct reads
    (a view one byte in).  The kernel's launch plan is the mirror's."""
    from lz4jpeg_tpu_torch.profiles import megakernel as mk

    shape = {"b256, many bands a CTA": (256, 256, 256),
             "a band past a whole wave": _wave_shape(cuda),
             "last band a row and 16 columns short": (2, 255, 1008)}[case]
    rgb = np.random.default_rng(sum(shape)).integers(
        0, 256, size=(*shape, 3), dtype=np.uint8)
    x = torch.from_numpy(rgb).to(cuda)
    if route == "direct":
        buf = torch.empty(x.numel() + 1, dtype=torch.uint8, device=cuda)[1:]
        x = buf.copy_(x.reshape(-1)).view(x.shape)
        assert x.data_ptr() % 16 != 0
    plan = mk.launch_plan(*shape, cuda)
    assert plan == mk.k1_plan(*shape, plan.resident)
    if case == "a band past a whole wave":
        assert plan.n_bands == plan.resident + 1 == plan.ctas + 1
    before = forward_combined.launches
    got = forward_combined(x, LUM, CHR)
    torch.cuda.synchronize()
    assert forward_combined.launches == before + 1
    want = forward_combined_ref(x, LUM, CHR)
    flips = sum_order_flips(rgb, got.cpu().numpy(), want.cpu().numpy(), LUM,
                            CHR)
    assert flips <= MAX_FLIP_SHARE * got.numel()


def test_k1_plan_entry_matches_the_mirror(cuda):
    """``fwd_megakernel_plan`` against ``profiles/megakernel.py::k1_plan``
    at the plan tests' shapes and phase 2's."""
    from lz4jpeg_tpu_torch.profiles import megakernel as mk

    for shape in [(1, 64, 128), (2, 1023, 512), (1, 61, 1040),
                  (3, 2048, 2048), (5, 2048, 2048), (1, 37, 53), (1, 8, 8),
                  (8, 2048, 2048)]:
        plan = mk.launch_plan(*shape, cuda)
        assert plan.resident == torch.cuda.get_device_properties(
            cuda).multi_processor_count * mk.k1_attributes(cuda)["ctas_per_sm"]
        assert plan == mk.k1_plan(*shape, plan.resident), shape


def test_k1_and_its_probe_variants_spill_nothing(cuda):
    """ptxas's spill stores of K1 and of every probe variant (the toolkit,
    beside the card)."""
    from lz4jpeg_tpu_torch.profiles.sass_loops import spill_stores

    k1 = spill_stores("fwd_megakernel")
    assert len(k1) == 1 and set(k1.values()) == {0}, k1
    probes = spill_stores("fwd_probe_kernel")
    assert len(probes) == 26 and set(probes.values()) == {0}, probes


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
    assert attrs["kt_copy"]["shared_bytes"] == mk.K1_SMEM
    for name, a in attrs.items():
        # the frame's mirror: groups, slots, rows over the operands, the
        # basis-A product's staged basis
        frame = mk.kt_frame(name)
        assert a["shared_bytes"] == frame["smem"], name
        assert a["ctas_per_sm"] == 1, name
        assert 0 < a["registers"] <= 255, name
        if frame["producer_warps"] == 4:  # the register split's launch
            assert a["registers"] == frame["launch_registers"] == 72, name


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


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("blocks", [1, 3, 8])
def test_bitonic_sort_at_small_block_counts(cuda, blocks, record):
    from lz4jpeg_tpu_torch.profiles import bitonic_sort as bs

    keys, pay = bs.probe_blocks(blocks, seed=blocks)
    k, p = torch.from_numpy(keys).to(cuda), torch.from_numpy(pay).to(cuda)
    got = bs.bitonic_sort_blocks(k, p, record)
    want = bs.bitonic_sort_blocks_ref(k, p, record)
    lib_k, lib_p = bs.sort_gather(k, p)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], lib_k)
    assert torch.equal(got[1], p if record else lib_p)


@pytest.mark.parametrize("record", [False, True])
def test_bitonic_sort_repeated_at_2048_blocks(cuda, record):
    """Twenty launches, each against the plain version: a missing wait
    between threads shows only sometimes."""
    from lz4jpeg_tpu_torch.profiles import bitonic_sort as bs

    keys, pay = bs.probe_blocks(2048, seed=20)
    k, p = torch.from_numpy(keys).to(cuda), torch.from_numpy(pay).to(cuda)
    want = bs.bitonic_sort_blocks_ref(k, p, record)
    for _ in range(20):
        got = bs.bitonic_sort_blocks(k, p, record)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sort_and_membership_kernels_spill_nothing(cuda):
    from lz4jpeg_tpu_torch.profiles.sass_loops import spill_stores

    for source in ("bitonic_sort_kernel", "rle_membership_kernel"):
        spills = spill_stores(source)
        assert len(spills) == 2 and set(spills.values()) == {0}, spills


def test_sort_and_membership_under_compute_sanitizer(cuda):
    from lz4jpeg_tpu_torch.profiles import sanitize

    found = [r for rs in sanitize.sanitize().values() for r in rs]
    assert not [r for r in found if r["verdict"] == "hazard"], found
    if all(r["verdict"] == "unavailable" for r in found if r["tool"] != "plain"):
        pytest.skip("compute-sanitizer cannot run a program on this machine")


# The stage kernels at 1 block, the probe's 256, one resident wave of the
# concentration's persistent grid (profiles/bucket_partition.py::
# concentration_plan: 396 blocks on 132 SMs) ± 1 block, on a view one element
# past a 16-byte boundary (the concentration's direct-load path) and on the
# crafted rows.
STAGE_CASES = [(1, "aligned"), (3, "aligned"), (3, "offset"),
               (256, "aligned"), (395, "aligned"), (396, "aligned"),
               (397, "aligned"), (397, "offset"), (1, "crafted")]


@pytest.mark.parametrize("blocks,case", STAGE_CASES)
@pytest.mark.parametrize("name", ["concentration_stages",
                                  "compare_exchange_stages"])
def test_stage_kernels_match_plain(cuda, name, blocks, case):
    from lz4jpeg_tpu_torch.profiles import bucket_partition as bp

    _, fn, ref, _ = bp.KERNELS[name]
    x = (bp.crafted_tiles() if case == "crafted"
         else bp.probe_tiles(blocks, seed=blocks)).to(cuda)
    v = x
    if case == "offset":
        buf = torch.empty(x.numel() + 1, dtype=torch.int32, device=cuda)
        v = buf[1:].view(x.shape).copy_(x)
        assert v.data_ptr() % 16
    before = fn.launches
    got = fn(v)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, ref(x))


@pytest.mark.parametrize("name", ["concentration_stages",
                                  "compare_exchange_stages"])
def test_stage_kernels_repeated_at_2048_blocks(cuda, name):
    """Twenty launches, each against the plain version: a missing wait on a
    bulk copy shows only sometimes."""
    from lz4jpeg_tpu_torch.profiles import bucket_partition as bp

    _, fn, ref, _ = bp.KERNELS[name]
    x = bp.probe_tiles(2048, seed=22).to(cuda)
    want = ref(x)
    for _ in range(20):
        assert torch.equal(fn(x), want)


@pytest.mark.parametrize("aligned", [True, False])
def test_stage_entry_takes_any_row_count(cuda, aligned):
    """The C entry point on row counts that leave a tile, or a CTA's group
    of tiles, part full: every row up to n_rows equals the plain version's
    and no row past it is written."""
    from lz4jpeg_tpu_torch.profiles import bucket_partition as bp

    lib = bp.load_kernel()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    x = bp.probe_tiles(4, seed=5).to(cuda)
    want = bp.concentration_stages_ref(x).view(-1, bp.LANES)
    src = x.view(-1, bp.LANES)
    if not aligned:
        buf = torch.empty(src.numel() + 1, dtype=torch.int32, device=cuda)
        src = buf[1:].view(src.shape).copy_(src)
    for kind, ref in ((bp.CONCENTRATION, want),
                      (bp.COMPARE_EXCHANGE,
                       bp.compare_exchange_stages_ref(x).view(-1, bp.LANES))):
        for n_rows in (1, 31, 33, 100, 3 * bp.ROWS + 77):
            out = torch.full_like(src, -7)
            assert lib.stage_rate_launch(kind, src.data_ptr(), out.data_ptr(),
                                         n_rows, stream) == 0
            torch.cuda.synchronize()
            assert torch.equal(out[:n_rows], ref[:n_rows])
            assert (out[n_rows:] == -7).all()


def test_stage_kernels_spill_nothing(cuda):
    from lz4jpeg_tpu_torch.profiles import bucket_partition as bp
    from lz4jpeg_tpu_torch.profiles.sass_loops import spill_stores

    spills = spill_stores("stage_rate_kernel")
    assert len(spills) == 3 and set(spills.values()) == {0}, spills
    conc = bp.stage_attributes(bp.CONCENTRATION, cuda)
    assert conc["ctas_per_sm"] == bp.CONC_CTAS_PER_SM
    assert conc["shared_bytes"] >= bp.CONC_WARPS * bp.TILE_ROWS * bp.PITCH
    counts = bp.stage_sass_counts()
    assert set(counts) == {bp.CONCENTRATION, bp.COMPARE_EXCHANGE}
    # the redesign's target: at most 4 lane instructions a stage-element
    assert 0 < counts[bp.CONCENTRATION] <= bp.INSTRUCTIONS[bp.CONCENTRATION]
    assert counts[bp.COMPARE_EXCHANGE] > 0


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


@pytest.mark.parametrize("k", [64, 32])
def test_membership_decode_at_a_row_tile(cuda, k):
    from lz4jpeg_tpu_torch.profiles import rle_decode as rd

    tile = rd.WARPS * rd.membership_thread_map(k)[0]  # rows a CTA pass
    rng = np.random.default_rng(k + 1)
    for n in (tile - 1, tile, tile + 1):
        words, lengths = crafted_packed16_rows(k, rng, n_random=n)
        w = torch.from_numpy(words[:n]).to(cuda)
        lens = torch.from_numpy(lengths[:n]).to(cuda)
        for out_size in (k, k // 2 + 3, 1):
            got = rd.rle_decode_membership(w, lens, out_size)
            assert torch.equal(got, pack16.pack16_decode(w, lens, out_size))
            assert torch.equal(got, torch.from_numpy(rd.emulate_membership(
                words[:n], lengths[:n], out_size)).to(cuda))


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
        assert rec["sass_issue_bound_ms"] > 0  # counted in this build's SASS
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


def _cast_edges(pair):
    """Element counts at the cast kernel's edges: 1, a vector - 1, a chunk
    ± 1 and three chunks + a vector - 1."""
    from lz4jpeg_tpu_torch.profiles import casts

    plan = casts.cast_plan(pair, 0)
    vec, chunk = plan.vec_elems, plan.vec_elems * plan.threads
    return sorted({1, max(vec - 1, 1), chunk - 1, chunk, chunk + 1,
                   3 * chunk + vec - 1})


@pytest.mark.parametrize("pair", range(7))
def test_cast_chunk_edges_and_plans(cuda, pair):
    """Each pair at its chunk edges, bit-identical to ``x.to``, one launch
    a call, with the C plan equal to the mirror's there, at 0 and past 2^31
    output bytes."""
    from lz4jpeg_tpu_torch.profiles import casts

    src, dst = casts.PAIRS[pair]
    for n in _cast_edges(pair):
        x = casts.random_values(src, n, cuda, n)
        before = casts.cast.launches
        got = casts.cast(x, dst)
        torch.cuda.synchronize()
        assert casts.cast.launches == before + 1
        assert casts.same(got, x.to(dst)), (casts.pair_name(pair), n)
    big = (1 << 31) // dst.itemsize + 17
    for n in (0, *_cast_edges(pair), big):
        assert casts.launch_plan(pair, n) == casts.cast_plan(pair, n), n


def test_cast_past_2_31_output_bytes(cuda):
    """uint8 → int32 of 2^29 + 5 elements: 2^31 + 20 bytes out, 64-bit
    offsets, bit-identical to ``x.to``."""
    from lz4jpeg_tpu_torch.profiles import casts

    n = (1 << 29) + 5
    x = casts.random_values(torch.uint8, n, cuda, 29)
    got = casts.cast(x, torch.int32)
    torch.cuda.synchronize()
    assert got.numel() * 4 > 1 << 31
    assert torch.equal(got, x.to(torch.int32))


def _dot_edges(resident, plan):
    """Row counts at the product's edges: 1, 63, 64, 65, one tile short of
    and past a full ring a CTA (ragged), 4,099."""
    full = resident * plan.stages * plan.tile_rows
    return (1, 63, 64, 65, full - plan.tile_rows - 3, full + plan.tile_rows
            - 3, 4099)


def test_basis_dot_ring_edges_and_plan(cuda):
    """The product at the ring's edges within its bound, one launch a call,
    its C plan equal to the mirror's at each count and at 2,097,152 rows."""
    from lz4jpeg_tpu_torch.profiles import dct_gates as dg

    rng = np.random.default_rng(11)
    m = dg.luma_basis(cuda)
    resident = dg.dot_launch_plan(1 << 30, cuda).resident
    plan = dg.dot_plan(0, resident)
    for n in (0, *_dot_edges(resident, plan), 2_097_152):
        assert dg.dot_launch_plan(n, cuda) == dg.dot_plan(n, resident), n
    for n in _dot_edges(resident, plan):
        x = dg.probe_pixels(n, rng).to(cuda)
        before = dg.basis_dot.launches
        got = dg.basis_dot(x, m)
        torch.cuda.synchronize()
        assert dg.basis_dot.launches == before + 1
        assert dg.dot_error(got, x, m)["within"], n
    assert dg.attributes(dg.DOT, device=cuda)["shared_bytes"] >= plan.smem


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


# The inverse megakernel (K9, ops/inv_megakernel.py): against its plain
# version (the torch chain on cuBLAS), every differing pixel explained by
# one-step plane flips at summation ties (utils/parity.py::decode_flips),
# every decode within max |Δ| ≤ 3 on ≤ 2e-3 of pixels.
K9_CASES = [
    ("aligned", (2, 256, 256), None),
    ("byte route", (1, 2047, 1531), None),  # W·3 % 16 != 0
    ("ragged", (3, 37, 53), None),
    ("one tile", (1, 8, 8), None),
    ("one pixel", (1, 1, 1), None),
    ("last unit 2 tiles", (2, 512, 1040), None),  # 130 tiles a block row
    ("quality 75", (4, 48, 528), 75),
    ("unaligned input view", (1, 64, 64), None),
]


def _k9_input(cuda, shape, quality, seed):
    from lz4jpeg_tpu_torch.models.jpeg import scaled_tables

    b, h, w = shape
    tables = scaled_tables(quality)
    x = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, size=(b, h, w, 3), dtype=np.uint8)).to(cuda)
    comb = forward_combined(x, tables["lum"], tables["r"]).reshape(b, -1, 128)
    return comb, tables, -(-h // 8), -(-w // 8)


@pytest.mark.parametrize("case,shape,quality", K9_CASES)
def test_inverse_megakernel_matches_plain_version(cuda, case, shape, quality):
    from lz4jpeg_tpu_torch.ops import inv_megakernel as inv
    from lz4jpeg_tpu_torch.utils.parity import decode_flips

    comb, tables, bpc, bpr = _k9_input(cuda, shape, quality, sum(shape))
    if case.startswith("unaligned"):
        comb = _offset_view(comb)
    b, h, w = shape
    before = inv.inverse_combined.launches
    got = inv.inverse_combined(comb, tables, bpc, bpr, h, w)
    torch.cuda.synchronize()
    assert inv.inverse_combined.launches == before + 1
    want = inv.inverse_combined_ref(comb, tables, bpc, bpr, h, w)
    assert got.shape == want.shape == (b, h, w, 3) and got.is_contiguous()
    flips = decode_flips(comb, got, want, tables, bpc, bpr)
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 3 and flips <= 2e-3 * b * h * w
    plan = inv.launch_plan(b, bpc, bpr, h, w, comb.data_ptr(), got.data_ptr())
    assert plan == inv.inverse_plan(b, bpc, bpr, h, w, comb.data_ptr() % 16,
                                    got.data_ptr() % 16, plan.resident)


@pytest.mark.parametrize("word", [0, 1024, -512, -32768, 32767])
def test_inverse_megakernel_on_crafted_words(cuda, word):
    """A word at every lane of every tile: K9 identical to the plain
    version; a random mix of the five within the flip rule."""
    from lz4jpeg_tpu_torch.models.jpeg import scaled_tables
    from lz4jpeg_tpu_torch.ops import inv_megakernel as inv
    from lz4jpeg_tpu_torch.utils.parity import decode_flips

    tables = scaled_tables(None)
    comb = torch.full((2, 5 * 7, 128), word, dtype=torch.int16, device=cuda)
    got = inv.inverse_combined(comb, tables, 5, 7, 37, 53)
    assert torch.equal(got, inv.inverse_combined_ref(comb, tables, 5, 7, 37, 53))
    words = torch.tensor([0, 1024, -512, -32768, 32767], dtype=torch.int16)
    mix = words[torch.from_numpy(np.random.default_rng(word & 0xff).integers(
        0, 5, size=(2, 5 * 7, 128)))].to(cuda)
    got = inv.inverse_combined(mix, tables, 5, 7, 37, 53)
    decode_flips(mix, got, inv.inverse_combined_ref(mix, tables, 5, 7, 37, 53),
                 tables, 5, 7)


def test_inverse_megakernel_refusals_and_attributes(cuda):
    from lz4jpeg_tpu_torch.models.jpeg import scaled_tables
    from lz4jpeg_tpu_torch.ops import inv_megakernel as inv

    tables = scaled_tables(None)
    comb = torch.zeros((1, 4, 128), dtype=torch.int16, device=cuda)
    before = inv.inverse_combined.launches
    for args in ((comb, tables, 2, 3, 16, 16), (comb, tables, 2, 2, 17, 16),
                 (comb[:, :, :64], tables, 2, 2, 16, 16)):
        with pytest.raises(ValueError):
            inv.inverse_combined(*args)
    with pytest.raises(TypeError):
        inv.inverse_combined(comb.int(), tables, 2, 2, 16, 16)
    assert inv.inverse_combined.launches == before
    with pytest.raises(ValueError):  # the tie count on another device
        inv.inverse_combined(comb, tables, 2, 2, 16, 16,
                             ties=torch.zeros(1, dtype=torch.int64))
    out = torch.empty((1, 17, 16, 3), dtype=torch.uint8, device=cuda)
    lib = inv.load_kernel()
    keys = inv.table_keys(tables)
    bases = inv._device_bases(keys, cuda)
    parts = inv._device_parts(keys, cuda)
    rc = lib.inv_megakernel_launch(comb.data_ptr(), out.data_ptr(),
                                   parts.data_ptr(), bases.data_ptr(), 1, 2,
                                   2, 17, 16, None,
                                   torch.cuda.current_stream().cuda_stream)
    assert rc != 0 and lib.inv_megakernel_error_string(rc)
    a = inv.kernel_attributes(cuda)
    assert a["registers"] > 0 and a["ctas_per_sm"] >= 1
    assert a["shared_bytes"] == inv.smem_bytes()


@pytest.mark.parametrize("quality", [None, 75, 90, 100])
def test_inverse_megakernel_takes_the_chains_bytes(cuda, quality):
    """K9 equal to the fp32 chain's bytes (its parent's, the numpy mirror
    ``parent_decode``) on 2 × 512² noise at each quality; the tie pass's
    count between none and a hundredth of the plane values."""
    from lz4jpeg_tpu_torch.ops import inv_megakernel as inv

    comb, tables, bpc, bpr = _k9_input(cuda, (2, 512, 512), quality,
                                       seed=quality or 50)
    ties = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = inv.inverse_combined(comb, tables, bpc, bpr, 512, 512, ties=ties)
    want = inv.parent_decode(comb.cpu().numpy(), tables, bpc, bpr, 512, 512)
    assert np.array_equal(got.cpu().numpy(), want)
    assert 0 < int(ties[0]) < 0.01 * comb.shape[0] * comb.shape[1] * 192


def test_inverse_megakernel_spills_nothing(cuda):
    from lz4jpeg_tpu_torch.profiles.sass_loops import spill_stores

    spills = spill_stores("inv_megakernel")
    assert len(spills) == 1 and set(spills.values()) == {0}, spills


def test_decode_batch_launches_k9_once(cuda):
    from lz4jpeg_tpu_torch.ops.inv_megakernel import inverse_combined

    rgbs = _batch(3, 96, 80, seed=2)
    pipe = JPEGPipeline(JPEGConfig(), device=cuda)
    containers = [unpack_container(pack_container(e))
                  for e in pipe.encode_batch(rgbs)]
    before = inverse_combined.launches
    got = pipe.decode_batch(containers)
    assert inverse_combined.launches == before + 1
    want = JPEGPipeline(JPEGConfig(), device="cpu").decode_batch(containers)
    for a, b in zip(got, want):
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert diff.max() <= 3 and (diff != 0).mean() <= 2e-3


def test_sharded_sparse_inverse_launches_k9_per_shard(cuda):
    from lz4jpeg_tpu_torch.ops.inv_megakernel import inverse_combined
    from lz4jpeg_tpu_torch.parallel import ShardedSparseJPEG

    rgb = _batch(1, 200, 96, seed=23)[0]
    sharded = ShardedSparseJPEG(_card_mesh(cuda))
    comb = sharded.forward(rgb)
    before = inverse_combined.launches
    got = sharded.inverse(comb, 25, 12, 200, 96)
    assert inverse_combined.launches == before + 4
    want = JPEGPipeline(JPEGConfig(), device="cpu").decode(
        JPEGPipeline(JPEGConfig(), device="cpu")._wrap_sparse(comb, 200, 96,
                                                              25, 12),
        from_entropy=False)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 3 and (diff != 0).mean() <= 2e-3


# ---------------------------------------------------------------------------
# K10 and K11: LZ4's greedy parses (csrc/lz4_parse_kernel.cu); integers,
# identity with the plain versions.
# ---------------------------------------------------------------------------


def _same(got, want):
    return all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("lcp_words", [2, 4])
def test_segment_parse_matches_plain_version(cuda, stride, lcp_words):
    """K10's candidate entry on K2's words of text (a ragged block, a noise
    block) at the codec's segment, at a segment past a tile and below 512,
    and at lower ``max_dist`` caps: fields identical, one launch a call."""
    from lz4jpeg_tpu_torch.ops import lz4_parse

    blocks, lengths = _text_blocks(3, seed=31 + stride)
    x = torch.from_numpy(blocks).to(cuda)
    lens = torch.from_numpy(lengths).to(cuda)
    packed = match_candidates(x, lens, stride, lcp_words)
    for seg, max_dist in ((512, 65535), (16384, 65535), (64, 65535),
                          (512, 3000), (512, 9)):
        before = lz4_parse.parse_candidates.launches
        got = lz4_parse.parse_candidates(packed, lens, 16384, max_dist, stride,
                                         seg)
        torch.cuda.synchronize()
        assert lz4_parse.parse_candidates.launches == before + 1
        want = lz4_parse.parse_candidates_ref(packed, lens, 16384, max_dist,
                                              stride, seg)
        assert _same(got, want), (seg, max_dist)


def test_segment_parse_units_match_the_mirror(cuda):
    """K10's C plan launches one CTA a unit of ``segment_plan``."""
    from lz4jpeg_tpu_torch.ops import lz4_parse

    lib = lz4_parse.load_kernel()
    for n, seg_a in ((2048 * 16384, 512), (2048 * 4096, 128), (4096, 1),
                     (3 * 4096, 4096), (15000, 5000), (7 * 40, 7)):
        assert lib.segment_parse_units(n, seg_a) == len(
            lz4_parse.segment_plan(n, seg_a)), (n, seg_a)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("seg,stride", [(512, 1), (16384, 1), (100, 3),
                                        (7, 2)])
def test_segment_parse_fields_match_plain_version(cuda, dtype, seg, stride):
    """K10's field entry (the sort matcher's parse) on random lengths and
    on values whose arithmetic wraps in the input's type."""
    from lz4jpeg_tpu_torch.ops import lz4_parse

    rng = np.random.default_rng(seg + stride)
    cols = 16384 - 16384 % seg
    ml = rng.integers(-5, 600, (9, cols))
    md = rng.integers(0, 1 << 20, (9, cols))
    big = torch.iinfo(dtype).max
    ml[0, 5], ml[1, 7], ml[2, 3] = big, big // 2, big - 1
    ml_d = torch.from_numpy(ml).to(dtype).to(cuda)
    md_d = torch.from_numpy(md).to(dtype).to(cuda)
    before = lz4_parse.greedy_parse.launches
    got = lz4_parse.greedy_parse(ml_d, md_d, seg, stride)
    torch.cuda.synchronize()
    assert lz4_parse.greedy_parse.launches == before + 1
    assert _same(got, lz4_parse.greedy_parse_ref(ml_d, md_d, seg, stride))


@pytest.mark.parametrize("p,n_blocks", [(300, 255), (1024, 30), (4096, 3),
                                        (9000, 2)])
@pytest.mark.parametrize("max_match", [1024, 100])
def test_parity_parse_matches_plain_version(cuda, p, n_blocks, max_match):
    """K11 on text blocks (a ragged last one), with its tables: best_len
    and best_dist, is_match (bool), emit_len, emit_dist identical; 9,000
    positions take two tiles, the runs carried between them."""
    from lz4jpeg_tpu_torch.ops import lz4_parse
    from lz4jpeg_tpu_torch.ops.match import pad_blocks

    data = generate_text(p * n_blocks - p // 3, np.random.default_rng(p))
    x = torch.from_numpy(pad_blocks(data, p)[0]).to(cuda)
    before = lz4_parse.parity_parse.launches
    got = lz4_parse.parity_tables(x, max_match)
    torch.cuda.synchronize()
    assert lz4_parse.parity_parse.launches == before + 1
    want = lz4_parse.parity_tables_ref(x, max_match)
    assert _same(got, want)
    assert _same(lz4_parse.parity_parse(x, max_match), want[2:])


@pytest.mark.parametrize("kind", ["equal", "random", "crafted"])
def test_parity_parse_on_crafted_blocks(cuda, kind):
    """All-equal bytes (runs to the block's end, ties at every distance),
    random bytes, and runs whose true lengths are 256, 257, 260 and 512
    (the uint8 truncation), at max_match 1,024 and 100."""
    from lz4jpeg_tpu_torch.ops import lz4_parse

    rng = np.random.default_rng(3)
    if kind == "equal":
        blocks = np.full((3, 2000), 97, np.int32)
    elif kind == "random":
        blocks = rng.integers(0, 256, (255, 300)).astype(np.int32)
    else:
        rows = []
        for run in (256, 257, 260, 261, 512, 513):
            row = np.array([(i * 7 + 3) % 251 for i in range(1024)], np.int32)
            row[1 : 1 + run] = ord("a")
            rows.append(row)
        blocks = np.stack(rows)
    x = torch.from_numpy(blocks).to(cuda)
    for max_match in (1024, 100):
        assert _same(lz4_parse.parity_tables(x, max_match),
                     lz4_parse.parity_tables_ref(x, max_match))


def test_parity_parse_refuses_blocks_past_16_bit_sizes(cuda):
    from lz4jpeg_tpu_torch.ops import lz4_parse

    with pytest.raises(ValueError):
        lz4_parse.parity_parse(torch.zeros((1, 65537), dtype=torch.int32,
                                           device=cuda))


@pytest.mark.parametrize("matcher", ["fused", "sort"])
def test_lz4t_encode_launches_k10_once(cuda, matcher):
    """A device encode runs one K10 launch (the candidate entry after K2,
    or the field entry in the sort matcher); frame identical to the CPU
    codec's."""
    from lz4jpeg_tpu_torch.ops import lz4_parse

    data = generate_text(5 * 16384 + 999, np.random.default_rng(41))
    cfg = LZ4Config(mode="fast", matcher=matcher)
    counter = (lz4_parse.parse_candidates if matcher == "fused"
               else lz4_parse.greedy_parse)
    before = counter.launches
    frame = LZ4Codec(cfg, device=cuda).encode(data, engine="device")
    assert counter.launches == before + 1
    assert frame == LZ4Codec(cfg, device="cpu").encode(data, engine="device")


def test_parity_encode_launches_k11_per_chunk(cuda):
    from lz4jpeg_tpu_torch.ops import lz4_parse

    data = generate_text(76_500, np.random.default_rng(43))
    cfg = LZ4Config(mode="parity")
    before = lz4_parse.parity_parse.launches
    frame = LZ4Codec(cfg, device=cuda, batch_blocks=100).encode(data)
    assert lz4_parse.parity_parse.launches == before + 3  # 255 blocks
    assert frame == native_backend().encode_parity(data, 300)


def test_sharded_parses_launch_k10_and_k11_per_shard(cuda):
    from lz4jpeg_tpu_torch.ops import lz4_parse
    from lz4jpeg_tpu_torch.ops.match import pad_blocks
    from lz4jpeg_tpu_torch.parallel.lz4 import (
        sharded_block_parse,
        sharded_fast_parse,
    )

    mesh = _card_mesh(cuda)
    padded, lengths = pad_blocks_fast(
        generate_text(8 * 16384 - 999, np.random.default_rng(47)))
    before = lz4_parse.parse_candidates.launches
    sharded_fast_parse(padded, lengths, mesh)
    assert lz4_parse.parse_candidates.launches == before + 4
    blocks, _ = pad_blocks(generate_text(12_000, np.random.default_rng(48)), 300)
    before = lz4_parse.parity_parse.launches
    got = sharded_block_parse(blocks, mesh)
    assert lz4_parse.parity_parse.launches == before + 4
    want = lz4_parse.parity_parse_ref(torch.from_numpy(blocks))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
