"""The port's entropy A/B, rooflines, golden-image suite, headline and
stream-copy wrapper on the CPU, held against the JAX package's suites where
those run on the CPU.

* ``run_entropy_ab``: per channel the symbol count and both copy sizes
  equal JAX's at 32² (the suite itself checks that its host and device bit
  streams agree).
* The rooflines: stage names, each stage's operations and bytes as
  ``bench/roofline.py`` documents them, the data sheet's peaks, the launch
  guard, and every variant of the stream-ceiling probe.  They report CPU
  times here, which are no device metric.
* ``run_golden_images`` on a directory of four generated PNGs and
  oracle-made stage PNGs, equal to JAX's suite on the same directory in
  every field but the times.
* The headline's one JSON line; ``stream_copy`` equal to ``x.clone()``.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from lz4jpeg_tpu.bench import entropy_ab as jax_entropy_ab
from lz4jpeg_tpu.bench import golden as jax_golden
from lz4jpeg_tpu.oracle import jpeg_oracle as jax_oracle
from lz4jpeg_tpu.utils.io import write_png as pil_write_png
from lz4jpeg_tpu.utils.visualize import r_chrominance_image

from lz4jpeg_tpu_torch.bench import entropy_ab, golden, headline, roofline
from lz4jpeg_tpu_torch.ops.stream import stream_copy, stream_copy_ref

QUIET = contextlib.redirect_stdout


def test_entropy_ab_equals_jax(tmp_path):
    with QUIET(io.StringIO()):
        want = jax_entropy_ab.run_entropy_ab(image_size=32, runs=2)
        got = entropy_ab.run_entropy_ab(image_size=32, runs=2, device="cpu",
                                        output=str(tmp_path / "ab.json"))
    assert json.loads((tmp_path / "ab.json").read_text()) == got
    assert (got["image_size"], got["platform"], got["device"], got["runs"]) == (
        32, "cpu", "cpu", 2)
    assert set(got) == set(want) | {"device"}
    for c, w in want["channels"].items():
        g = got["channels"][c]
        assert set(g) == set(w)
        for key in ("symbols", "pairs_bytes_d2h", "packed_bytes_d2h"):
            assert g[key] == w[key], (c, key)


def test_device_hist_counts_every_bin():
    symbols = torch.tensor([-2048, -1, -1, 0, 5, 2047, 5, 5], dtype=torch.int32)
    hist = entropy_ab._device_hist(symbols)
    want = np.bincount(symbols.numpy() + 2048, minlength=4096)
    assert np.array_equal(hist.numpy(), want)


STREAM_VARIANTS = {"stream_f32", "triad_f32", "stream_u8",
                   "copy_kernel_u8", "copy_kernel_i16", "copy_kernel_f32",
                   "copy_u8", "copy_i16", "copy_f32"}


def test_stream_ceiling_lists_every_variant():
    probe = roofline.measure_hbm_stream_ceiling(1 << 16, chain=2, runs=2,
                                                device="cpu")
    assert set(probe["variants"]) == STREAM_VARIANTS
    assert probe["device"] == "cpu" and probe["footprint_bytes"] == 1 << 16
    n = 1 << 16
    for name, v in probe["variants"].items():
        assert v["bytes"] == (3 * n if name == "triad_f32" else 2 * n), name
        assert v["achieved_gbs"] == pytest.approx(v["bytes"] / v["measured_s"] / 1e9)
    assert probe["ceiling_gbs"] == max(v["achieved_gbs"]
                                       for v in probe["variants"].values())
    assert probe["ceiling_variant"] in STREAM_VARIANTS


def _check_stages(result, flops, bytes_):
    assert result["peaks"] == {
        "hbm_gbs": 3350.0,
        "tensor_bf16_tflops": 989.0,
        "hbm_gbs_measured": result["hbm_stream_ceiling"]["ceiling_gbs"],
    }
    assert {k: (s["flops"], s["bytes"]) for k, s in result["stages"].items()} == {
        k: (flops[k], bytes_[k]) for k in flops
    }
    for name, st in result["stages"].items():
        if st["sol_fraction"] is None:
            continue
        sol = max(st["bytes"] / 3350e9, st["flops"] / 989e12)
        assert st["speed_of_light_s"] == pytest.approx(sol), name
        assert st["sol_fraction"] == pytest.approx(sol / st["measured_s"])
        measured = max(st["bytes"] / (result["peaks"]["hbm_gbs_measured"] * 1e9),
                       st["flops"] / 989e12)
        assert st["sol_fraction_measured"] == pytest.approx(
            measured / st["measured_s"])


def test_forward_roofline_stages(tmp_path):
    out = tmp_path / "fwd.json"
    with QUIET(io.StringIO()):
        result = roofline.run_jpeg_forward_roofline(
            size=64, batch=2, chain=2, output=str(out), device="cpu")
    assert json.loads(out.read_text()) == result
    npix = 2 * 64 * 64
    ops = (10 + 2 * 64 + 2 * 32) * npix
    _check_stages(
        result,
        {"megakernel": ops, "full_forward": ops, "plain_chain": ops,
         "readback_d2h": 0},
        {"megakernel": 7 * npix, "full_forward": 7 * npix,
         "plain_chain": 7 * npix, "readback_d2h": (npix // 64) * 128 * 2},
    )
    assert (result["size"], result["batch"], result["chain"], result["device"],
            result["limiting_stage"]) == (64, 2, 2, "cpu", "megakernel")
    assert result["stages"]["readback_d2h"]["sol_fraction"] is None
    assert result["fence_floor"]["measured_s"] > 0


def test_inverse_roofline_stages():
    with QUIET(io.StringIO()):
        result = roofline.run_jpeg_inverse_roofline(size=64, batch=2, chain=2,
                                                    device="cpu")
    npix = 2 * 64 * 64
    einsum = 2 * 64 * npix + 2 * 32 * 2 * npix
    _check_stages(
        result,
        {"unbias_kt": 0, "folded_einsum": einsum, "color_merge": 10 * npix,
         "full_inverse": einsum + 10 * npix},
        {"unbias_kt": 12 * npix, "folded_einsum": 11 * npix,
         "color_merge": 6 * npix, "full_inverse": 7 * npix},
    )
    assert result["limiting_stage"] in ("unbias_kt", "folded_einsum",
                                        "color_merge")


class _Counter:
    """A stand-in kernel wrapper: ``launches`` moves only when called."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x):
        self.launches += 1
        return x

    __name__ = "fake_kernel"


def test_launch_guard_fires_when_the_counter_does_not_move():
    kernel = _Counter()
    x = torch.arange(16, dtype=torch.uint8)

    def launching(x, c, s):
        s = s + kernel(x + c).sum(dtype=torch.float32)
        return roofline._carry(s, torch.uint8), s

    def silent(x, c, s):
        s = s + (x + c).sum(dtype=torch.float32)
        return roofline._carry(s, torch.uint8), s

    assert roofline._chain_bench(launching, x, 3, torch.uint8, runs=2,
                                 kernel=kernel) > 0
    assert kernel.launches == 3 * 3  # warm-up chain and two timed chains
    with pytest.raises(RuntimeError, match="launch guard"):
        roofline._chain_bench(silent, x, 3, torch.uint8, runs=2,
                              kernel=kernel)


def test_forward_roofline_guards_k1_on_the_card(monkeypatch):
    """On a CUDA device the K1 stages pass ``forward_combined`` as the
    guard; here its counter stays at 0 (CPU tensors run the plain version),
    so a roofline that believed it ran on a card must refuse its numbers."""
    from lz4jpeg_tpu_torch.ops import fwd_megakernel

    guarded = []
    real = roofline._chain_bench

    def spy(body, data, chain, carry_dtype, runs=4, kernel=None):
        guarded.append(kernel)
        return real(body, data, chain, carry_dtype, runs, kernel)

    monkeypatch.setattr(roofline, "_chain_bench", spy)
    with QUIET(io.StringIO()):
        roofline.run_jpeg_forward_roofline(size=16, batch=1, chain=2,
                                           device="cpu")
    assert guarded == [None] * 4  # megakernel, full_forward, plain, floor
    with pytest.raises(RuntimeError, match="launch guard"):
        real(lambda x, c, s: (c, s + fwd_megakernel.forward_combined(
            x, *_tables()).sum(dtype=torch.float32)),
            torch.zeros((1, 8, 8, 3), dtype=torch.uint8), 2, torch.uint8,
            runs=1, kernel=fwd_megakernel.forward_combined)


def _tables():
    from lz4jpeg_tpu_torch.ops.quantize import (
        CHROMINANCE_QUANTIZATION_TABLE,
        LUMINANCE_QUANTIZATION_TABLE,
    )

    return LUMINANCE_QUANTIZATION_TABLE, CHROMINANCE_QUANTIZATION_TABLE


@pytest.fixture
def golden_dir(tmp_path, monkeypatch):
    """Four generated images under the reference's names and the three stage
    PNGs of og.png as the oracle makes them (reconstructed.png one pixel
    off, so one provenance flag is false)."""
    rng = np.random.default_rng(11)
    shapes = {"og.png": (24, 40), "jellyfish.png": (16, 16),
              "switzerland-uot.png": (13, 21), "Solid_red.png": (8, 8)}
    for name, (h, w) in shapes.items():
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        if name == "Solid_red.png":
            img[:] = (255, 0, 0)
        pil_write_png(str(tmp_path / name), img)
        if name == "og.png":
            og = img
    ld = np.longdouble
    y87 = np.trunc(ld(0.299) * og[..., 0].astype(ld)
                   + ld(0.587) * og[..., 1].astype(ld)
                   + ld(0.114) * og[..., 2].astype(ld)).astype(np.uint8)
    _, cr, cb = jax_oracle.build_ycbcr_planes(og, snap_ties=False)
    planes = jax_oracle.divide_image(y87, jax_oracle.chroma_subsample(cr),
                                     jax_oracle.chroma_subsample(cb))
    recon = jax_oracle.assemble_image(planes).copy()
    recon[0, 0, 0] ^= 1
    pil_write_png(str(tmp_path / "luminance.png"), np.repeat(y87[..., None], 3, 2))
    pil_write_png(str(tmp_path / "rChrominance.png"), r_chrominance_image(cr))
    pil_write_png(str(tmp_path / "reconstructed.png"), recon)
    for module in (golden, jax_golden):
        monkeypatch.setattr(module, "ASSETS", str(tmp_path))
        monkeypatch.setattr(module, "STAGE_DIR", str(tmp_path))
    return tmp_path


def test_golden_equals_jax(golden_dir):
    with QUIET(io.StringIO()):
        want = jax_golden.run_golden_images(runs=2)
        got = golden.run_golden_images(runs=2, device="cpu",
                                       output=str(golden_dir / "g.json"))
    assert json.loads((golden_dir / "g.json").read_text()) == got
    assert set(got) == set(want) | {"device"}
    assert got["stage_provenance"] == want["stage_provenance"]
    assert [got["stage_provenance"][k] for k in (
        "luminance_x87_exact", "r_chrominance_exact",
        "reconstructed_is_by_value_bug")] == [True, True, False]
    assert list(got["images"]) == list(want["images"]) == list(golden.IMAGES)
    for name, w in want["images"].items():
        g = got["images"][name]
        for key in ("shape", "mse", "psnr_db", "compressed_bytes", "raw_bytes"):
            assert g[key] == w[key], (name, key)
        assert len(g["execution_times"]) == 2


def test_golden_needs_the_reference_images(tmp_path, monkeypatch):
    monkeypatch.setattr(golden, "ASSETS", str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError):
        golden.run_golden_images(runs=1, device="cpu")


def test_forward_rle_equals_jax():
    """What the headline and the rooflines time: the pipeline's sparse16
    device forward, equal to the JAX pipeline's ``_forward_rle``; a pair
    pipeline (quality 90) refuses it (its forward is ``_forward``)."""
    import jax.numpy as jnp

    from lz4jpeg_tpu.config import JPEGConfig as JaxJPEGConfig
    from lz4jpeg_tpu.models.jpeg import JPEGPipeline as JaxJPEGPipeline

    from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline

    rgb = np.random.default_rng(5).integers(0, 256, size=(24, 40, 3),
                                            dtype=np.uint8)
    pipe = JPEGPipeline(JPEGConfig(), "cpu")
    got = pipe._forward_rle(pipe._image(rgb))
    want = JaxJPEGPipeline(JaxJPEGConfig())._forward_rle(jnp.asarray(rgb))
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy().view(np.uint16), np.asarray(want))
    q90 = JPEGPipeline(JPEGConfig(quality=90), "cpu")
    with pytest.raises(ValueError, match="sparse16"):
        q90._forward_rle(q90._image(rgb))


def test_headline_prints_one_json_line():
    with QUIET(io.StringIO()) as said:
        line = headline.main(size=64, batch=2, device="cpu")
    (printed,) = said.getvalue().splitlines()
    assert json.loads(printed) == line
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "jpeg_forward_throughput_64_b2_cpu"
    assert line["unit"] == "MPix/s" and line["value"] > 0
    # Both numbers are rounded from one unrounded throughput t, value to
    # 2 decimals: vs_baseline = round(t / base, 1) for some t within 0.005
    # of value (on a slow CPU t ~ 0.04, where the two roundings part).
    base = 2048 * 2048 / 1e6 / 26.7048
    assert (round((line["value"] - 0.005) / base, 1) <= line["vs_baseline"]
            <= round((line["value"] + 0.005) / base, 1))


@pytest.mark.parametrize("dtype,n,width", [
    (torch.uint8, 4096, 8), (torch.uint8, 4098, 2), (torch.uint8, 4097, 1),
    (torch.int16, 6, 4), (torch.int16, 1_000_003, 2), (torch.int32, 3, 4),
    (torch.float32, 1000, 8), (torch.int64, 5, 8), (torch.uint8, 0, 8),
])
def test_device_checksum_sums_every_byte(dtype, n, width):
    """The fence of the chained benchmarks: the wrapping sum of the bytes
    read as the widest integers that tile them; every byte moves it."""
    from lz4jpeg_tpu_torch.utils.profiling import device_checksum

    rng = np.random.default_rng(n)
    raw = rng.integers(0, 256, size=n * torch.empty((), dtype=dtype).element_size(),
                       dtype=np.uint8)
    x = torch.from_numpy(raw.copy()).view(dtype)
    words = raw.view({8: np.int64, 4: np.int32, 2: np.int16, 1: np.uint8}[width])
    want = np.float32(words.sum(dtype=words.dtype))  # wraps as the device sum
    got = device_checksum(x)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == float(want)
    if n:
        raw[-1] ^= 1
        assert float(device_checksum(torch.from_numpy(raw).view(dtype))) != float(got)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32])
@pytest.mark.parametrize("n", [0, 1, 4096, 1_000_003])
def test_stream_copy_on_the_cpu_is_a_clone(dtype, n):
    x = torch.arange(n).to(dtype)
    stream_copy.launches = 0
    got = stream_copy(x)
    assert torch.equal(got, stream_copy_ref(x)) and torch.equal(got, x)
    assert got.data_ptr() != x.data_ptr() or n == 0
    assert stream_copy.launches == 0


def test_stream_copy_refuses_strided_tensors():
    x = torch.arange(32, dtype=torch.uint8)[::2]
    for fn in (stream_copy, stream_copy_ref):
        with pytest.raises(ValueError, match="contiguous"):
            fn(x)
    with pytest.raises(ValueError, match="unsupported device"):
        stream_copy(torch.zeros(4, device="meta"))
