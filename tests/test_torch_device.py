"""Where the port runs, and what it imports.

* A CUDA pipeline on a machine without a card raises; it never runs on
  the CPU instead.
* ``forward_combined.launches`` counts kernel launches only: CPU tensors
  run the plain version and leave it at 0.
* No module of ``lz4jpeg_tpu_torch`` (the oracle copy and the kernel
  candidates of ``profiles/`` included) nor ``chip_smoke.py`` imports
  ``jax``, ``lz4jpeg_tpu`` or the repository's ``profiles`` scripts, by an
  AST scan and by a subprocess that blocks the three names and still runs
  the kernel candidates', the megakernel variants', the sublane RLE's, the
  casts' and the fused-DCT gates' plain versions and JPEG round trips
  (sparse16, its packed16 twin, quality 90 in the int16 pair layout, exact
  precision against the oracle copy, per-block entropy, the overlapped
  and bucketed encodes, K8's plain version), an LZ4T
  ``engine="device"`` round trip, a parity round trip and one CLI call.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
from lz4jpeg_tpu_torch.ops.fwd_megakernel import forward_combined
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE as CHR,
    LUMINANCE_QUANTIZATION_TABLE as LUM,
)

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "lz4jpeg_tpu", "profiles")


def test_cuda_pipeline_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for CPU hosts")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        JPEGPipeline(JPEGConfig(), device="cuda")


def test_pipeline_requires_cpu_or_cuda():
    with pytest.raises(ValueError, match="unsupported device"):
        JPEGPipeline(JPEGConfig(), device="meta")


def test_pipeline_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    JPEGPipeline(JPEGConfig(), device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_tensors_never_count_launches():
    forward_combined.launches = 0
    rgb = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, size=(2, 16, 24, 3),
                                          dtype=np.uint8)
    )
    forward_combined(rgb, LUM, CHR)
    JPEGPipeline(JPEGConfig(), device="cpu").encode_batch(rgb.numpy())
    assert forward_combined.launches == 0


@pytest.mark.parametrize("bad", [
    torch.zeros((1, 8, 8, 3), dtype=torch.int32),           # dtype
    torch.zeros((8, 8, 3), dtype=torch.uint8),              # rank
    torch.zeros((1, 8, 8, 4), dtype=torch.uint8),           # channels
    torch.zeros((1, 8, 16, 3), dtype=torch.uint8)[:, :, ::2],  # strides
    torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device="meta"),  # device
])
def test_wrapper_checks_its_input(bad):
    with pytest.raises((TypeError, ValueError)):
        forward_combined(bad, LUM, CHR)


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_import_anywhere_in_the_port():
    files = sorted((REPO / "lz4jpeg_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert REPO / "lz4jpeg_tpu_torch" / "oracle" / "jpeg_oracle.py" in files
    assert len(files) > 10
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & set(BLOCKED), f"{path} imports {roots & set(BLOCKED)}"


_BLOCKED_RUN = """
import importlib.abc, sys
import numpy as np

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, {repo!r})
from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
from lz4jpeg_tpu_torch.formats.jpeg_container import pack_container, unpack_container
pipe = JPEGPipeline(JPEGConfig(), device="cpu")
rgb = np.random.default_rng(0).integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
out = pipe.decode(unpack_container(pack_container(pipe.encode(rgb))))
assert out.shape == rgb.shape and out.dtype == np.uint8
(packed,) = pipe.to_packed16([pipe.encode(rgb)])
pipe.entropy_encode(packed)
assert pack_container(packed) == pack_container(pipe.encode(rgb))
assert np.abs(pipe.decode(packed).astype(np.int32) - out).max() <= 3
q90 = JPEGPipeline(JPEGConfig(quality=90), device="cpu")
enc = q90.encode(rgb)
assert not enc.rle_sparse16 and not enc.rle_packed16
assert q90.decode(unpack_container(pack_container(enc))).shape == rgb.shape
assert q90.decode(enc).shape == rgb.shape
from lz4jpeg_tpu_torch.oracle import jpeg_oracle
exact = JPEGPipeline(JPEGConfig(precision="exact"), device="cpu")
ref, stages = jpeg_oracle.jpeg_roundtrip_oracle(rgb, snap_ties=True)
assert np.array_equal(exact.roundtrip(rgb), ref)
parity = JPEGPipeline(JPEGConfig(precision="exact", entropy="per_block"), device="cpu")
assert parity.encode(rgb).per_block_bits == stages["huff_bits"]
banded = JPEGPipeline(JPEGConfig(), device="cpu")
banded._OVERLAP_MIN_BLOCKS = 1
assert pack_container(banded.encode(rgb)) == pack_container(pipe.encode(rgb))
assert pack_container(pipe.encode_bucketed(rgb)) == pack_container(pipe.encode(rgb))
import torch
from lz4jpeg_tpu_torch.ops import pack16
words, lengths = pack16.pack16_encode(torch.full((4, 64), 7, dtype=torch.int16))
assert (pack16.pack16_decode_wide(words, lengths) == 7).all()
from lz4jpeg_tpu_torch import LZ4Codec, LZ4Config
from lz4jpeg_tpu_torch.utils.inputs import generate_text
text = generate_text(40000, np.random.default_rng(0))
codec = LZ4Codec(LZ4Config(mode="fast"), device="cpu")
frame = codec.encode(text, engine="device")
assert codec.decode(frame, engine="device") == text
assert codec.decode(frame, engine="native") == text
parity = LZ4Codec(LZ4Config(mode="parity"), device="cpu")
frame = parity.encode(text[:3000])
assert parity.decode(frame, engine="device") == text[:3000]
from lz4jpeg_tpu_torch.oracle import lz4_encode_oracle
assert frame == lz4_encode_oracle(text[:3000])
from lz4jpeg_tpu_torch.cli import main
open("in.txt", "wb").write(text[:3000])
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()) as said:
    assert main(["lz4", "encode", "in.txt", "out.lz4", "--mode", "parity",
                 "--device", "cpu"]) == 0
assert said.getvalue().startswith("3000 -> ")
assert open("out.lz4", "rb").read() == frame
from lz4jpeg_tpu_torch.ops.quantize import LUMINANCE_QUANTIZATION_TABLE as LUM
from lz4jpeg_tpu_torch.profiles import candidates_ab, mcu, plane_color, rle
zz = mcu.fused_forward_candidate(torch.from_numpy(rgb[..., 0][None, :8, :8].copy()),
                                 LUM, 8, 8)
assert mcu.fused_inverse_candidate(zz, LUM, 8, 8).shape == (1, 8, 8)
assert rle.rle_encode_candidate(zz.to(torch.int16))[1].shape == (1,)
assert len(plane_color.plane_color(*(torch.zeros(s, dtype=torch.uint8)
                                     for s in ((2, 4), (2, 2), (2, 2))))) == 3
from lz4jpeg_tpu_torch.ops.quantize import CHROMINANCE_QUANTIZATION_TABLE as CHR
from lz4jpeg_tpu_torch.profiles import megakernel
for v in megakernel.RGB_VARIANTS:
    out = megakernel.megakernel_variant(torch.zeros((1, 8, 16, 3), dtype=torch.uint8),
                                        v.name, LUM, CHR)
    assert tuple(out.shape) == v.shape(2)
from lz4jpeg_tpu_torch.profiles import megakernel_kt, megakernel_t, megakernel_v2
for v in megakernel.KT_VARIANTS:
    out = megakernel.megakernel_variant(torch.zeros((3, 64, 16), dtype=torch.uint8),
                                        v.name, LUM, CHR)
    assert tuple(megakernel.combined(out).shape) == (16, 128)
from lz4jpeg_tpu_torch.profiles import casts, dct_gates, sublane_rle
packed, runs = sublane_rle.sublane_rle(torch.zeros((32, 5), dtype=torch.int16))
assert runs.tolist() == [[1] * 5] and packed.shape == (32, 5)
assert casts.cast(torch.zeros(4, dtype=torch.bfloat16), torch.float32).dtype == torch.float32
assert dct_gates.basis_dot(torch.zeros((2, 64)), dct_gates.luma_basis()).shape == (2, 64)
assert dct_gates.minor_transpose(torch.zeros((1, 3, 2))).shape == (1, 2, 3)
assert dct_gates.lane_split(torch.zeros((2, 16)), 8).shape == (2, 2, 8)
from lz4jpeg_tpu_torch.profiles import mcu_relayout, onehot_gather, pallas_color
y, cr, cb = pallas_color.color_probe(torch.zeros((2, 4, 3), dtype=torch.uint8))
assert y.shape == (2, 4) and cr.shape == cb.shape == (2, 2) and y.dtype == torch.int16
assert mcu_relayout.mcu_relayout(torch.zeros((2, 8, 16), dtype=torch.uint8), 4).shape == (8, 32)
got = onehot_gather.onehot_gather(torch.arange(2048, dtype=torch.int32)[None],
                                  torch.full((1, 2048), 7, dtype=torch.uint8), "lt_i8_full_2048")
assert (got == 7).all()
assert "jax" not in sys.modules and "lz4jpeg_tpu" not in sys.modules
print("ok")
"""


def test_round_trip_with_jax_blocked(tmp_path):
    code = _BLOCKED_RUN.format(blocked=BLOCKED, repo=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
