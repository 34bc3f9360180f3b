"""The port's experiment sweeps, inputs and CLI ``bench``, held against the
JAX package's on the CPU.

Each sweep runs in both packages on the same seeded inputs at a tiny size;
their results must agree in everything but the times: names, scales, run
counts, throughput units and the reference-schema JSON keys (the port adds
the device each entry ran on).  The LZ4 sweeps read a corpus: both packages
get the same ``generate_text`` output (the JAX sweep through a
monkeypatched ``load_corpus``; its file is not edited).  The JAX LZ4T
decode sweep times the TPU-only one-hot resolve and cannot run on the CPU,
so its entries are held to the JAX copy-program builder on the same frame.
``tests/test_torch_bench_suites.py`` holds the other suites.
"""

import contextlib
import io
import json

import jax
import numpy as np
import pytest

from lz4jpeg_tpu.bench import experiments as jax_ex
from lz4jpeg_tpu.ops.lz4t_decode import (
    build_copy_program_fast as jax_build_copy_program_fast,
    depth_to_steps as jax_depth_to_steps,
)
from lz4jpeg_tpu.utils import inputs as jax_inputs

from lz4jpeg_tpu_torch.bench import experiments
from lz4jpeg_tpu_torch.cli import build_parser, main as cli
from lz4jpeg_tpu_torch.native import native_backend
from lz4jpeg_tpu_torch.utils import inputs

SUITES = ("headline", "lz4", "lz4-device", "lz4-file", "lz4t-decode", "jpeg",
          "jpeg-inverse", "jpeg-perblock", "scaling", "roofline",
          "entropy-ab", "golden", "roofline-inverse")


@pytest.fixture(scope="module")
def corpus():
    return inputs.generate_text(100_000, np.random.default_rng(3))


@pytest.mark.parametrize("seed,length", [(0, 1), (1, 350), (2, 999), (3, 5000),
                                         (4, 5256)])
def test_extract_random_passage_equals_jax(seed, length):
    corpus = b"line one\r\nline two\nthree\n" * 200 + bytes(range(256))
    assert len(corpus) == 5256  # the last case takes the whole corpus
    got = inputs.extract_random_passage(corpus, length,
                                        np.random.default_rng(seed))
    want = jax_inputs.extract_random_passage(corpus, length,
                                             np.random.default_rng(seed))
    assert got == want and len(got) == length
    assert b"\n" not in got and b"\r" not in got


def test_extract_random_passage_refuses_long_passages():
    for extract in (inputs.extract_random_passage,
                    jax_inputs.extract_random_passage):
        with pytest.raises(ValueError, match="exceeds corpus"):
            extract(b"abc", 4, np.random.default_rng(0))


def test_load_corpus_reads_a_file(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(b"Gregor Samsa\nwoke\r\n")
    assert inputs.load_corpus(str(path)) == jax_inputs.load_corpus(str(path))
    assert inputs.METAMORPHOSIS_PATH.endswith("Output-Input/input/Metamorphosis.txt")


def _same_results(port, jax_results, port_json, jax_json):
    """Names, scales, run counts and units equal; the JSON files have the
    JAX keys plus the device."""
    assert [(r.name, r.scale, len(r.times_s), r.throughput_unit) for r in port] == [
        (r.name, r.scale, len(r.times_s), r.throughput_unit) for r in jax_results
    ]
    assert all(r.throughput > 0 for r in port)
    got, want = json.loads(port_json.read_text()), json.loads(jax_json.read_text())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) | {"device"} and g["device"] == "cpu"
        for key in set(w) - {"execution_times", "mean", "median", "throughput"}:
            assert g[key] == w[key], key


@pytest.mark.parametrize("sweep,kwargs,lz4", [
    ("run_lz4_experiment", {"sizes": [350, 500]}, True),
    ("run_jpeg_experiment", {"sizes": [8, 16]}, False),
    ("run_jpeg_perblock_experiment", {"sizes": [32]}, False),
    ("run_jpeg_inverse_device_experiment", {"sizes": [32]}, False),
    ("run_lz4_device_experiment", {"batches": [2], "lcp_words_list": [2]}, True),
])
def test_sweep_equals_jax(sweep, kwargs, lz4, corpus, tmp_path, monkeypatch):
    x64 = jax.config.jax_enable_x64
    try:
        if lz4:
            monkeypatch.setattr(jax_ex, "load_corpus", lambda: corpus)
        with contextlib.redirect_stdout(io.StringIO()) as jax_said:
            want = getattr(jax_ex, sweep)(runs=2, output=str(tmp_path / "jax.json"),
                                          **kwargs)
    finally:
        jax.config.update("jax_enable_x64", x64)
    extra = {"corpus": corpus} if lz4 else {}
    with contextlib.redirect_stdout(io.StringIO()) as said:
        got = getattr(experiments, sweep)(
            runs=2, output=str(tmp_path / "port.json"), device="cpu",
            **kwargs, **extra,
        )
    _same_results(got, want, tmp_path / "port.json", tmp_path / "jax.json")
    # One printed line per result (the inverse sweep adds no memory note on
    # the CPU), each naming what the JAX line names before the colon.
    lines, jax_lines = said.getvalue().splitlines(), jax_said.getvalue().splitlines()
    assert [s.split(":")[0] for s in lines] == [s.split(":")[0] for s in jax_lines]


def test_lz4t_decode_entries_equal_jax_programs(corpus, tmp_path):
    """The sweep checks both resolves against the input itself (it raises
    otherwise); its entries equal the JAX builder's on the same frame."""
    out = tmp_path / "lz4t.json"
    with contextlib.redirect_stdout(io.StringIO()):
        results = experiments.run_lz4t_decode_device_experiment(
            sizes_mb=[1], runs=2, output=str(out), corpus=corpus, device="cpu",
        )
    assert [(r.name, r.scale, r.throughput_unit) for r in results] == [
        ("lz4t_decode_device", 1, "MB/s")]
    artifact = json.loads(out.read_text())
    assert artifact["device"] == "cpu" and "gather_melem_s" not in artifact
    (entry,) = artifact["entries"]
    data = (corpus * (-(-1 * 1 << 20) // len(corpus) + 1))[: 1 << 20]
    frame = native_backend().encode_fast(data)
    lit, _, _, _, depth = jax_build_copy_program_fast(frame)
    assert (entry["mb"], entry["blocks"], entry["max_depth"],
            entry["doubling_steps"]) == (1, lit.shape[0], depth,
                                         jax_depth_to_steps(depth))
    assert entry["rooted_resolve_mb_s"] > 0 and entry["end_to_end_mb_s"] > 0


def test_lz4_file_experiment_round_trips(corpus, tmp_path):
    out = tmp_path / "file.json"
    with contextlib.redirect_stdout(io.StringIO()):
        result = experiments.run_lz4_file_experiment(
            size_mb=1, runs=2, output=str(out), corpus=corpus, device="cpu")
    assert json.loads(out.read_text()) == result
    assert result["device"] == "cpu" and 0 < result["ratio"] < 1
    assert len(result["encode_times_s"]) == len(result["decode_times_s"]) == 2


def test_sweeps_refuse_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for CPU hosts")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        experiments.run_jpeg_experiment(sizes=[8], runs=1)


@pytest.mark.parametrize("suite", SUITES)
def test_cli_parses_every_suite(suite):
    args = build_parser().parse_args(["bench", suite, "--runs", "3",
                                      "--device", "cpu"])
    assert (args.command, args.suite, args.runs, args.device) == (
        "bench", suite, 3, "cpu")
    assert build_parser().parse_args(["bench", suite]).device == "cuda"


def test_cli_bench_jpeg_writes_the_schema(tmp_path, monkeypatch):
    monkeypatch.setattr(experiments, "JPEG_SIZES", [8, 16])
    out = tmp_path / "jpeg.json"
    with contextlib.redirect_stdout(io.StringIO()) as said:
        assert cli(["bench", "jpeg", "--runs", "2", "--device", "cpu",
                    "--output", str(out)]) == 0
    entries = json.loads(out.read_text())
    assert [e["image_size"] for e in entries] == [8, 16]
    assert {e["name"] for e in entries} == {"jpeg_fast"}
    assert set(entries[0]) == {
        "name", "image_size", "runs", "mean_method", "execution_times",
        "mean", "median", "throughput", "throughput_unit", "device"}
    assert all(e["runs"] == 2 and e["device"] == "cpu" for e in entries)
    assert len(said.getvalue().splitlines()) == 2


def test_cli_bench_lz4_reads_the_reference_corpus(tmp_path, monkeypatch):
    """Without ``corpus`` the LZ4 suites read ``load_corpus()``: absent here,
    so the CLI raises as the JAX CLI does."""
    monkeypatch.setattr(experiments, "load_corpus",
                        lambda: inputs.load_corpus(str(tmp_path / "none")))
    with pytest.raises(FileNotFoundError):
        cli(["bench", "lz4", "--runs", "1", "--device", "cpu"])
