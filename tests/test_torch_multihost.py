"""Two real processes over gloo on 127.0.0.1: the port's cross-process paths.

The counterpart of ``tests/test_multihost_distributed.py``.  This file is
also its own worker: ``python tests/test_torch_multihost.py <addr> 2 <rank>
<out>`` joins a gloo group (``device="cpu"``) and runs, on each rank:

* the ragged-width ordered gather of ``tests/multihost_worker.py:36-43``;
* ``multihost_fast_encode`` and ``multihost_fast_decode`` of 140,072 bytes
  of generated text (seed 0: 8 × 16 KiB blocks and a ragged tail);
* ``multihost_jpeg_encode`` and ``multihost_jpeg_decode`` of a 96×80 noise
  image (seed 7), in the sparse16 layout and at quality 90 (int16 pairs);

and asserts that it never imported ``jax``.  The test launches two workers
and holds both ranks' frames and containers equal to each other and to the
JAX package's single-process results, byte for byte.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT_BYTES = 8 * 16384 + 9000
IMAGE_SHAPE = (96, 80)
QUALITIES = (None, 90)  # sparse16, int16 pairs


def _inputs():
    from lz4jpeg_tpu_torch.utils.inputs import generate_noise_image, generate_text

    data = generate_text(TEXT_BYTES, np.random.default_rng(0))
    img = generate_noise_image(*IMAGE_SHAPE, np.random.default_rng(7))
    return data, img


def worker(coordinator: str, num_processes: int, process_id: int, out: str) -> int:
    import torch.distributed as dist

    from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
    from lz4jpeg_tpu_torch.formats.fast_frame import decode_fast
    from lz4jpeg_tpu_torch.formats.jpeg_container import unpack_container
    from lz4jpeg_tpu_torch.parallel.jpeg import (
        multihost_jpeg_decode,
        multihost_jpeg_encode,
    )
    from lz4jpeg_tpu_torch.parallel.lz4 import (
        multihost_fast_decode,
        multihost_fast_encode,
    )
    from lz4jpeg_tpu_torch.parallel.multihost import (
        initialize,
        ordered_allgather_payloads,
    )

    count = initialize(coordinator, num_processes, process_id, device="cpu")
    assert count == num_processes == initialize(), count
    # Rank 0 holds short payloads of blocks {0, 2}; rank 1 one much longer
    # payload of block {1}: widths and counts differ across ranks.
    if process_id == 0:
        local, indices = [b"aa", b"cccc"], [0, 2]
    else:
        local, indices = [b"b" * 100], [1]
    got = ordered_allgather_payloads(local, indices, 3)
    assert got == [b"aa", b"b" * 100, b"cccc"], [len(p) for p in got]
    print(f"process {process_id}: gather OK")

    data, img = _inputs()
    frame = multihost_fast_encode(data, device="cpu")
    assert decode_fast(frame) == data
    with open(f"{out}.{process_id}", "wb") as f:
        f.write(frame)
    assert multihost_fast_decode(frame, device="cpu") == data
    print(f"process {process_id}: lz4 OK ({len(frame)} bytes)")

    for quality in QUALITIES:
        cfg = JPEGConfig(precision="fast", entropy="shared", quality=quality)
        container = multihost_jpeg_encode(img, cfg, device="cpu")
        with open(f"{out}.jpeg{quality}.{process_id}", "wb") as f:
            f.write(container)
        mh_img = multihost_jpeg_decode(container, cfg, device="cpu")
        local_img = JPEGPipeline(cfg, "cpu").decode(unpack_container(container))
        assert np.array_equal(mh_img, local_img)
    print(f"process {process_id}: jpeg OK")

    assert "jax" not in sys.modules and "lz4jpeg_tpu" not in sys.modules
    dist.destroy_process_group()
    print(f"process {process_id}: no jax")
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_matches_jax_single_process(tmp_path):
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out_base = str(tmp_path / "frame.bin")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), coordinator, "2",
             str(rank), out_base],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=REPO,
        )
        for rank in range(2)
    ]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a gloo worker timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        for marker in ("gather OK", "lz4 OK", "jpeg OK", "no jax"):
            assert f"process {rank}: {marker}" in out, out

    frames = [open(f"{out_base}.{i}", "rb").read() for i in range(2)]
    assert frames[0] == frames[1]

    from lz4jpeg_tpu.config import JPEGConfig as JaxJPEGConfig
    from lz4jpeg_tpu.formats.jpeg_container import pack_container
    from lz4jpeg_tpu.models.jpeg import JPEGPipeline as JaxJPEGPipeline
    from lz4jpeg_tpu.parallel.lz4 import multihost_fast_encode

    data, img = _inputs()
    assert frames[0] == multihost_fast_encode(data)
    for quality in QUALITIES:
        containers = [open(f"{out_base}.jpeg{quality}.{i}", "rb").read()
                      for i in range(2)]
        assert containers[0] == containers[1]
        cfg = JaxJPEGConfig(precision="fast", entropy="shared", quality=quality)
        assert containers[0] == pack_container(JaxJPEGPipeline(cfg).encode(img))


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
