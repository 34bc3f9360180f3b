"""The Hopper forward kernel against its plain torch version, on the card.

Needs a CUDA device: every test takes the ``cuda`` fixture, which skips
with a reason on a host without one (the decision is made inside the
fixture, never while the module is imported).  This file imports neither
JAX nor ``lz4jpeg_tpu``, so it also runs on a machine without them:
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.

Tolerance: identity, except sum-order flips (``utils/parity.py``): a
coefficient off by exactly 1 whose float64 ratio lies within 1e-4 of an
integer, at most 1e-5 of the coefficients.  The kernel sums its 64
products in a fixed FMA order; cuBLAS in its own.
"""

import numpy as np
import pytest
import torch

from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
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
