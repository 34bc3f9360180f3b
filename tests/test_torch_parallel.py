"""The port's sharded paths on an 8-shard CPU mesh, held against the JAX
package's on ``tests/conftest.py``'s 8-device CPU mesh and against the
single-device port.

The port's mesh repeats the CPU device eight times (``CodecMesh``), so every
shard runs its own call, as on a mesh that repeats one card.  The cases
mirror ``tests/test_parallel.py`` and the checks of
``__graft_entry__.py:63-218``, with generated text in place of the
reference corpus.  Tolerance: identity everywhere, bitwise, except the
staged sparse16 inverse against the folded single-device decode, held to
JAX's own bar (max |Δ| ≤ 1 on < 2e-3 of pixels, ``tests/test_parallel.py:
167-168``).  The cross-process paths run here in one process (no group);
``tests/test_torch_multihost.py`` runs two gloo processes.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from lz4jpeg_tpu.bench import harness as jax_harness
from lz4jpeg_tpu.config import JPEGConfig as JaxJPEGConfig
from lz4jpeg_tpu.config import MeshConfig as JaxMeshConfig
from lz4jpeg_tpu.formats.fast_frame import encode_fast as jax_encode_fast
from lz4jpeg_tpu.formats.jpeg_container import pack_container as jax_pack
from lz4jpeg_tpu.models.jpeg import JPEGPipeline as JaxJPEGPipeline
from lz4jpeg_tpu.oracle import jpeg_oracle
from lz4jpeg_tpu.parallel import codec_mesh as jax_codec_mesh
from lz4jpeg_tpu.parallel import jpeg as jax_pjpeg
from lz4jpeg_tpu.parallel import lz4 as jax_plz4
from lz4jpeg_tpu.parallel import mesh as jax_pmesh
from lz4jpeg_tpu.utils import stats as jax_stats

from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline, LZ4Codec, LZ4Config
from lz4jpeg_tpu_torch.bench import harness
from lz4jpeg_tpu_torch.bench.scaling import jpeg_scaling_sweep
from lz4jpeg_tpu_torch.config import MeshConfig
from lz4jpeg_tpu_torch.formats.fast_frame import (
    assemble_frame,
    decode_fast,
    emit_block_from_parse,
)
from lz4jpeg_tpu_torch.formats.jpeg_container import (
    pack_container,
    unpack_container,
)
from lz4jpeg_tpu_torch.ops.lz4_fast import TPU_BLOCK_LOG, pad_blocks_fast
from lz4jpeg_tpu_torch.ops.match import pad_blocks
from lz4jpeg_tpu_torch.parallel import (
    ShardedJPEGForward,
    ShardedSparseJPEG,
    codec_mesh,
    pad_to_devices,
    sharded_block_parse,
)
from lz4jpeg_tpu_torch.parallel import jpeg as pjpeg
from lz4jpeg_tpu_torch.parallel import lz4 as plz4
from lz4jpeg_tpu_torch.parallel import multihost
from lz4jpeg_tpu_torch.parallel.mesh import CodecMesh, shard_leading_axis
from lz4jpeg_tpu_torch.utils import stats
from lz4jpeg_tpu_torch.utils.inputs import generate_noise_image, generate_text
from lz4jpeg_tpu_torch.utils.profiling import checksum, fenced, time_device, trace

CPU = torch.device("cpu")
SHARDS = 8
CHANNELS = ("lum", "r", "b")


@pytest.fixture(scope="module")
def mesh():
    return CodecMesh((CPU,) * SHARDS)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_codec_mesh(JaxMeshConfig())


@pytest.fixture(scope="module")
def text():
    return generate_text(200_000, np.random.default_rng(0))


def _image(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3),
                                                dtype=np.uint8)


def _assert_fields_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_devices", [None, 4])
def test_mesh_config_fields_equal_jax(num_devices):
    assert dataclasses.asdict(MeshConfig(num_devices=num_devices)) == (
        dataclasses.asdict(JaxMeshConfig(num_devices=num_devices)))


def test_codec_mesh_on_the_cpu(mesh, jax_mesh):
    assert mesh.size == jax_mesh.devices.size == SHARDS
    assert (MeshConfig().data_axis,) == jax_mesh.axis_names
    assert codec_mesh(MeshConfig(num_devices=SHARDS), "cpu") == mesh
    assert codec_mesh(MeshConfig(), "cpu").devices == (CPU,)
    # The one-axis mesh names no axis: data_axis changes nothing.
    sub = codec_mesh(MeshConfig(num_devices=4, data_axis="blocks"), "cpu")
    assert sub.size == 4 and sub == codec_mesh(MeshConfig(num_devices=4), "cpu")


def test_cuda_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for CPU hosts")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        codec_mesh(MeshConfig(), "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.initialize("127.0.0.1:1", 1, 0, device="cuda")


@pytest.mark.parametrize("devices", [
    (), (CPU, torch.device("meta")), (torch.device("meta"),),
])
def test_mesh_rejects_bad_devices(devices):
    with pytest.raises(ValueError):
        CodecMesh(devices)


@pytest.mark.parametrize("shape,pad_value", [
    ((10, 3), 0), ((16, 3), 0), ((3, 300), -1), ((1,), 7),
])
def test_pad_to_devices_equals_jax(shape, pad_value):
    batch = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    got, n = pad_to_devices(batch, SHARDS, pad_value=pad_value)
    want, jn = jax_pmesh.pad_to_devices(batch, SHARDS, pad_value=pad_value)
    assert n == jn == shape[0]
    np.testing.assert_array_equal(got, want)


def test_shard_leading_axis(mesh):
    x = np.arange(16 * 3).reshape(16, 3)
    (shards,) = shard_leading_axis([x], mesh)
    assert len(shards) == SHARDS
    assert all(s.device == d for s, d in zip(shards, mesh.devices))
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x)
    with pytest.raises(ValueError, match="pad_to_devices"):
        shard_leading_axis([x[:10]], mesh)


# ---------------------------------------------------------------------------
# ShardedJPEGForward
# ---------------------------------------------------------------------------


def _stages_equal(got, want):
    for c in CHANNELS:
        for k in ("zz", "rle", "rle_lengths"):
            np.testing.assert_array_equal(got[c][k], np.asarray(want[c][k]))


@pytest.mark.parametrize("size", [16, 32])
def test_sharded_exact_forward_matches_oracle_and_jax(mesh, jax_mesh, size):
    img = _image(size, size)
    stages, n = ShardedJPEGForward(mesh, JPEGConfig(precision="exact"))(img)
    ref = jpeg_oracle.jpeg_forward_oracle(img, snap_ties=True)
    np.testing.assert_array_equal(stages["lum"]["zz"][:n], ref["zz_lum"])
    np.testing.assert_array_equal(stages["r"]["zz"][:n], ref["zz_r"])
    for i in range(n):
        ln = int(stages["lum"]["rle_lengths"][i])
        assert list(stages["lum"]["rle"][i][:ln]) == ref["rle_lum"][i]
    jax_stages, jn = jax_pjpeg.ShardedJPEGForward(
        jax_mesh, JaxJPEGConfig(precision="exact"))(img)
    assert n == jn
    _stages_equal(stages, jax_stages)


@pytest.mark.parametrize("quality", [None, 40])
def test_sharded_fast_forward_matches_forward_stages(mesh, jax_mesh, quality):
    img = _image(32, 32)
    cfg = dict(precision="fast", quality=quality)
    stages, n = ShardedJPEGForward(mesh, JPEGConfig(**cfg))(img)
    ref = JPEGPipeline(JPEGConfig(**cfg), "cpu").forward_stages(img)
    for c in CHANNELS:
        np.testing.assert_array_equal(stages[c]["zz"][:n], ref[c]["zz"])
        np.testing.assert_array_equal(stages[c]["rle"][:n], ref[c]["rle"])
    jax_stages, _ = jax_pjpeg.ShardedJPEGForward(
        jax_mesh, JaxJPEGConfig(**cfg))(img)
    _stages_equal(stages, jax_stages)


def test_sharded_respects_quality(mesh):
    """The sharded path scales its quant tables like ``JPEGPipeline``."""
    img = _image(32, 32)
    cfg = JPEGConfig(precision="exact", quality=40)
    stages, n = ShardedJPEGForward(mesh, cfg)(img)
    ref = JPEGPipeline(cfg, "cpu").forward_stages(img)
    np.testing.assert_array_equal(stages["lum"]["zz"][:n], ref["lum"]["zz"])
    plain, _ = ShardedJPEGForward(mesh, JPEGConfig(precision="exact"))(img)
    assert not np.array_equal(plain["lum"]["zz"][:n], stages["lum"]["zz"][:n])


def test_every_shard_computes_on_its_device(mesh):
    """Counterpart of ``test_output_is_sharded``: one result per shard,
    each on its mesh device, with its share of the padded MCU rows."""
    fwd = ShardedJPEGForward(mesh, JPEGConfig())
    tiles, n = fwd._tiles(_image(40, 24))  # 15 MCUs → 16 rows
    shards = fwd._mcu_stage(*shard_leading_axis(tiles, mesh))
    assert n == 15 and len(shards) == SHARDS
    for dev, shard in zip(mesh.devices, shards):
        for c in CHANNELS:
            assert shard[c]["zz"].device == dev
            assert shard[c]["rle"].shape[0] == 2


def _layout_streams(layout, img):
    """(rle, lengths, precision) of ``img`` in a layout, from the port's
    single-device pipeline."""
    if layout == "pairs":
        enc = JPEGPipeline(JPEGConfig(precision="exact"), "cpu").encode(
            img, entropy=False)
        return enc.rle, enc.rle_lengths, "exact"
    pipe = JPEGPipeline(JPEGConfig(), "cpu")
    enc = pipe.encode(img, entropy=False)
    if layout == "packed16":
        (enc,) = pipe.to_packed16([enc])
        return enc.rle, enc.rle_lengths, "fast"
    return enc.rle, None, "fast"


@pytest.mark.parametrize("layout", ["pairs", "packed16", "sparse16"])
def test_sharded_inverse_matches_jax(mesh, jax_mesh, layout):
    img = _image(32, 40, seed=1)
    rle, lengths, precision = _layout_streams(layout, img)
    args = (4, 5, 32, 40)
    explicit = None if layout == "pairs" else layout
    got = ShardedJPEGForward(mesh, JPEGConfig(precision=precision)).inverse(
        rle, lengths, *args, layout=explicit)
    want = jax_pjpeg.ShardedJPEGForward(
        jax_mesh, JaxJPEGConfig(precision=precision)).inverse(
        rle, lengths, *args, layout=explicit)
    np.testing.assert_array_equal(got, want)
    pipe = JPEGPipeline(JPEGConfig(precision=precision), "cpu")
    single = pipe.decode(pipe.encode(img, entropy=False), from_entropy=False)
    if layout == "pairs":
        np.testing.assert_array_equal(got, single)
    else:
        # The staged tile inverse against the folded sparse16 decode: the
        # fast-path contract, ±1 at round-half ties on few pixels.
        diff = np.abs(got.astype(np.int32) - single.astype(np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() < 2e-3


def test_sharded_inverse_refuses_unlabelled_uint16(mesh):
    rle, lengths, _ = _layout_streams("packed16", _image(16, 16))
    with pytest.raises(ValueError, match="ambiguous"):
        ShardedJPEGForward(mesh).inverse(rle, lengths, 2, 2, 16, 16)


def test_per_block_entropy_from_sharded_forward(mesh):
    """The sharded forward's RLE streams feed the per-block Huffman pass
    with bitstrings identical to the unsharded pipeline's
    (``__graft_entry__.py:149-172``)."""
    img = _image(32, 32)
    cfg = JPEGConfig(precision="exact", entropy="per_block")
    pipe = JPEGPipeline(cfg, "cpu")
    stages, n = ShardedJPEGForward(mesh, cfg)(img)
    local = pipe.encode(img)
    from_sharded = dataclasses.replace(
        local,
        rle={c: stages[c]["rle"][:n] for c in CHANNELS},
        rle_lengths={c: stages[c]["rle_lengths"][:n] for c in CHANNELS},
        per_block_bits=None,
    )
    pipe.entropy_encode(from_sharded)
    assert from_sharded.per_block_bits == local.per_block_bits
    jax_local = JaxJPEGPipeline(JaxJPEGConfig(
        precision="exact", entropy="per_block")).encode(img)
    assert from_sharded.per_block_bits == jax_local.per_block_bits


# ---------------------------------------------------------------------------
# ShardedSparseJPEG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 64), (40, 24), (96, 160), (16, 20)])
def test_sparse_forward_matches_unsharded_and_jax(mesh, jax_mesh, shape):
    """Aligned shapes run one forward per band; the ragged 16×20 delegates
    to the single-device pipeline (never padded at the RGB level)."""
    img = _image(*shape)
    got = ShardedSparseJPEG(mesh).forward(img)
    assert got.dtype == np.uint16
    ref = JPEGPipeline(JPEGConfig(), "cpu").encode(img, entropy=False)
    np.testing.assert_array_equal(got, ref.rle_combined)
    np.testing.assert_array_equal(got, jax_pjpeg.ShardedSparseJPEG(
        jax_mesh).forward(img))


def test_sparse_roundtrip_matches_unsharded_and_jax(mesh, jax_mesh):
    h, w = 72, 88
    img = _image(h, w)
    sharded = ShardedSparseJPEG(mesh)
    comb = sharded.forward(img)
    got = sharded.inverse(comb, 9, 11, h, w)
    pipe = JPEGPipeline(sharded.config, "cpu")
    ref = pipe.decode(pipe.encode(img, entropy=False), from_entropy=False)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jax_pjpeg.ShardedSparseJPEG(
        jax_mesh).inverse(comb, 9, 11, h, w))


@pytest.mark.parametrize("cfg", [
    JPEGConfig(precision="exact"), JPEGConfig(entropy="per_block"),
    JPEGConfig(quality=90),
])
def test_sparse_rejects_non_sparse_config(mesh, cfg):
    with pytest.raises(ValueError, match="sparse16-eligible"):
        ShardedSparseJPEG(mesh, cfg)


# ---------------------------------------------------------------------------
# Sharded LZ4
# ---------------------------------------------------------------------------


def _parity_blocks(text):
    """4,800 B of text in blocks of 300, padded to the mesh with -1 rows."""
    padded, _ = pad_blocks(text[:4800], 300)
    return pad_to_devices(padded, SHARDS, pad_value=-1)[0]


def test_sharded_block_parse_matches_jax_and_unsharded(mesh, jax_mesh, text):
    from lz4jpeg_tpu_torch.ops.match import greedy_parse, match_tables

    blocks = _parity_blocks(text)
    got = sharded_block_parse(blocks, mesh)
    _assert_fields_equal(got, jax_plz4.sharded_block_parse(blocks, jax_mesh))
    ref = greedy_parse(*match_tables(torch.from_numpy(blocks)))
    _assert_fields_equal(got, [r.numpy() for r in ref])


def test_sharded_compressed_sizes_matches_jax(mesh, jax_mesh, text):
    blocks = _parity_blocks(text)
    is_match, emit_len, _ = sharded_block_parse(blocks, mesh)
    total = plz4.sharded_compressed_sizes(emit_len, is_match, mesh)
    assert int(total) == int(is_match.sum()) > 0
    assert int(total) == int(jax_plz4.sharded_compressed_sizes(
        emit_len, is_match, jax_mesh))


def test_sharded_fast_parse_matches_jax(mesh, jax_mesh, text):
    padded, lengths = pad_blocks_fast(text[: SHARDS * 16384])
    got = plz4.sharded_fast_parse(padded, lengths, mesh)
    _assert_fields_equal(got, jax_plz4.sharded_fast_parse(padded, lengths,
                                                          jax_mesh))


def test_sharded_fast_parse_frame_round_trips(mesh, text):
    data = text[: SHARDS * 16384]
    padded, lengths = pad_blocks_fast(data)
    is_match, emit_len, emit_dist = plz4.sharded_fast_parse(padded, lengths, mesh)
    payloads, raws = [], []
    for bi in range(padded.shape[0]):
        n = int(lengths[bi])
        raw = bytes(padded[bi, :n].astype(np.uint8))
        payloads.append(emit_block_from_parse(
            raw, is_match[bi, :n], emit_len[bi, :n], emit_dist[bi, :n]))
        raws.append(raw)
    frame = assemble_frame(payloads, raws, len(data), TPU_BLOCK_LOG)
    assert decode_fast(frame) == data and len(frame) < len(data)


DECODE_CASES = {
    "empty": lambda t: b"",
    "one_byte": lambda t: b"z",
    "ragged_tail": lambda t: b"ragged tail " * 31,
    "8x1KiB+37": lambda t: t[: SHARDS * 1024 + 37],
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_sharded_fast_decode(mesh, jax_mesh, text, case):
    data = DECODE_CASES[case](text)
    frame = jax_encode_fast(data, block_log=10)
    assert plz4.sharded_fast_decode(frame, mesh) == data
    assert jax_plz4.sharded_fast_decode(frame, jax_mesh) == data
    assert plz4.multihost_fast_decode(frame, device="cpu") == data


def test_sharded_resolve_blocks_matches_jax(mesh, jax_mesh, text):
    from lz4jpeg_tpu_torch.ops.lz4t_decode import build_copy_program_fast

    lit, src, _, _, _ = build_copy_program_fast(
        jax_encode_fast(text[:20_000], block_log=10))
    lit, _ = pad_to_devices(lit, SHARDS)
    src, _ = pad_to_devices(src, SHARDS, pad_value=-1)
    got = plz4.sharded_resolve_blocks(lit, src, mesh)
    np.testing.assert_array_equal(
        got, jax_plz4.sharded_resolve_blocks(lit, src, jax_mesh))


# ---------------------------------------------------------------------------
# Cross-process paths, in one process
# ---------------------------------------------------------------------------


def test_initialize_without_arguments_starts_nothing():
    assert multihost.initialize() == 1
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    with pytest.raises(ValueError, match="process_id"):
        multihost.initialize("127.0.0.1:1", 2, device="cpu")


def test_ordered_gather_single_process():
    out = multihost.ordered_allgather_payloads([b"bb", b"a", b"cccc"], [1, 0, 2], 3)
    assert out == [b"a", b"bb", b"cccc"]
    with pytest.raises(ValueError, match="missing"):
        multihost.ordered_allgather_payloads([b"x"], [0], 2)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_world_of_one_runs_the_collectives(text):
    """A group of one process takes the collective path (all-reduce MAX,
    count and row all-gathers) with the results of no group."""
    import torch.distributed as dist

    assert multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0,
                                device="cpu") == 1
    try:
        assert multihost.initialize() == 1 and dist.get_backend() == "gloo"
        out = multihost.ordered_allgather_payloads([b"bb", b"", b"c"], [1, 0, 2], 3)
        assert out == [b"", b"bb", b"c"]
        data = text[:40_000]
        assert plz4.multihost_fast_encode(data, device="cpu") == (
            jax_plz4.multihost_fast_encode(data))
        img = generate_noise_image(40, 24, np.random.default_rng(7))
        container = pjpeg.multihost_jpeg_encode(img, device="cpu")
        assert container == jax_pjpeg.multihost_jpeg_encode(img)
        np.testing.assert_array_equal(
            pjpeg.multihost_jpeg_decode(container, device="cpu"),
            jax_pjpeg.multihost_jpeg_decode(container))
    finally:
        dist.destroy_process_group()
    assert multihost.process_count() == 1


@pytest.mark.parametrize("n_bytes", [0, 1, 140_072])
def test_multihost_fast_codec_matches_jax(text, n_bytes):
    data = text[:n_bytes]
    frame = plz4.multihost_fast_encode(data, device="cpu")
    assert frame == jax_plz4.multihost_fast_encode(data)
    assert frame == LZ4Codec(LZ4Config(mode="fast"), "cpu").encode(
        data, engine="device")
    assert plz4.multihost_fast_decode(frame, device="cpu") == data


@pytest.mark.parametrize("cfg", [
    dict(), dict(quality=90), dict(precision="exact"),
])
def test_multihost_jpeg_codec_matches_jax(cfg):
    img = generate_noise_image(96, 80, np.random.default_rng(7))
    container = pjpeg.multihost_jpeg_encode(img, JPEGConfig(**cfg), device="cpu")
    assert container == jax_pjpeg.multihost_jpeg_encode(img, JaxJPEGConfig(**cfg))
    pipe = JPEGPipeline(JPEGConfig(**cfg), "cpu")
    assert container == pack_container(pipe.encode(img))
    assert container == jax_pack(JaxJPEGPipeline(JaxJPEGConfig(**cfg)).encode(img))
    got = pjpeg.multihost_jpeg_decode(container, JPEGConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(got, pipe.decode(unpack_container(container)))
    np.testing.assert_array_equal(got, jax_pjpeg.multihost_jpeg_decode(
        container, JaxJPEGConfig(**cfg)))


def test_multihost_jpeg_refuses_per_block():
    with pytest.raises(ValueError, match="shared"):
        pjpeg.multihost_jpeg_encode(_image(8, 8), JPEGConfig(entropy="per_block"),
                                    device="cpu")


# ---------------------------------------------------------------------------
# Statistics, harness, profiling, the scaling sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("values", [
    [3.0], [2.0, 1.0], [5.0, 1.0, 4.0, 2.0, 3.0], [0.25, 9.0, 1.5, 1.5],
])
def test_stats_equal_jax(values):
    assert stats.trimmed_mean(values) == jax_stats.trimmed_mean(values)
    assert stats.median(values) == jax_stats.median(values)


def test_harness_equals_jax(tmp_path):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("one failing run, retried")

    got = harness.run_timed("x", flaky, scale=7, runs=4, work=100.0,
                            work_unit="B")
    assert len(got.times_s) == 4 and len(calls) == 1 + 4 + 1
    assert got.mean_s == stats.trimmed_mean(got.times_s)
    assert got.throughput == 100.0 / got.mean_s and got.throughput_unit == "B/s"
    twin = jax_harness.BenchResult(**dataclasses.asdict(got))
    assert got.to_json() == twin.to_json()
    harness.write_results(str(tmp_path / "port.json"), [got])
    jax_harness.write_results(str(tmp_path / "jax.json"), [twin])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_fenced_checksums_the_whole_output():
    out = {"a": torch.arange(10, dtype=torch.int16),
           "b": [torch.ones(3, 4, dtype=torch.float32), np.full(5, 2, np.uint8)],
           "c": (torch.tensor([True, False, True]),)}
    assert checksum(out) == 45 + 12 + 10 + 2
    assert fenced(lambda x: {"y": x * 2})(torch.arange(4)) == 12.0
    times = time_device(lambda x: x + 1, torch.zeros(8), runs=3, warmup=1)
    assert len(times) == 3 and all(t >= 0 for t in times)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "trace"), device="cpu") as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert log_dir == str(tmp_path / "trace") and events["traceEvents"]


def test_scaling_sweep_writes_jax_keys(tmp_path):
    out = tmp_path / "scaling.json"
    entries = jpeg_scaling_sweep(64, mesh_sizes=[1, 2, 4], runs=2,
                                 output=str(out), device="cpu")
    payload = json.loads(out.read_text())
    assert set(payload) == {"image_size", "platform", "runs", "entries", "note"}
    assert payload["platform"] == "cpu" and payload["entries"] == entries
    assert [e["devices"] for e in entries] == [1, 2, 4]
    keys = {"devices", "mean_s", "speedup", "efficiency", "mpix_per_s"}
    assert all(set(e) == keys for e in entries)
    assert entries[0]["speedup"] == 1.0
