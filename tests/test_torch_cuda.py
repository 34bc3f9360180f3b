"""The Hopper kernels against their plain torch versions, on the card.

Needs a CUDA device: every test takes the ``cuda`` fixture, which skips
with a reason on a host without one (the decision is made inside the
fixture, never while the module is imported).  This file imports neither
JAX nor ``lz4jpeg_tpu``, so it also runs on a machine without them:
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.

Tolerance of the forward kernel: identity, except sum-order flips
(``utils/parity.py``): a coefficient off by exactly 1 whose float64 ratio
lies within 1e-4 of an integer, at most 1e-5 of the coefficients.  The
kernel sums its 64 products in a fixed FMA order; cuBLAS in its own.

The LZ4 match kernel (K2) and the rooted-resolve kernel (K3) compute on
integers: identity, no tolerance.  The LZ4T frame of a CUDA codec must
equal the CPU codec's byte for byte.
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
from lz4jpeg_tpu_torch.utils.inputs import generate_text
from lz4jpeg_tpu_torch.formats.jpeg_container import pack_container, unpack_container
from lz4jpeg_tpu_torch.ops.fwd_megakernel import (
    forward_combined,
    forward_combined_ref,
)
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE as CHR,
    LUMINANCE_QUANTIZATION_TABLE as LUM,
)
from lz4jpeg_tpu_torch.utils.parity import sum_order_flips

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
