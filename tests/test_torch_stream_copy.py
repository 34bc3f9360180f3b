"""The streaming copy template's launch plan on the CPU.

``csrc/stream_copy.cuh`` is CUDA only; both copy kernels launch it
(``ops/stream.py::stream_copy`` and ``profiles/rle_expand.py::copy_rm``).
Here ``ops/stream.py::copy_plan`` and ``cta_ranges``, the Python mirror of
its plan and of each CTA's index arithmetic, are held to cover every byte
of a copy exactly once, with one CTA a chunk and none idle, for sizes
around the chunk, above 2^31 bytes, and source and destination offsets
equal and unequal modulo 16.  The mirror's constants are read back from
the header.  The card tests (``tests/test_torch_cuda.py``) hold the
mirror equal to the C code's plan and the kernels equal to their plain
versions.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from lz4jpeg_tpu_torch.ops import stream

CHUNK = stream.CHUNK_BYTES
SIZES = [0, 1, 15, 16, 17, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 5,
         2**31 + 17]
OFFSETS = [(0, 0), (5, 5), (15, 15), (0, 3), (9, 2)]  # src, dst modulo 16


def _covered_once(ranges: np.ndarray, n: int) -> bool:
    """The (cta, start, stop) ranges tile [0, n) with no gap or overlap."""
    if n == 0:
        return len(ranges) == 0
    r = ranges[np.argsort(ranges[:, 1], kind="stable")]
    return (r[0, 1] == 0 and r[-1, 2] == n
            and bool(np.all(r[1:, 1] == r[:-1, 2])))


@pytest.mark.parametrize("offsets", OFFSETS, ids=lambda o: f"src{o[0]}-dst{o[1]}")
@pytest.mark.parametrize("n", SIZES)
def test_copy_plan_covers_every_byte_once(n, offsets):
    src, dst = offsets
    plan = stream.copy_plan(n, src, dst)
    ranges = stream.cta_ranges(plan)
    assert _covered_once(ranges, n)
    # the launch: one CTA a chunk of the body or of the byte-wise list,
    # every CTA with work, and no more CTAs than chunks of the n bytes + 1
    ctas = np.unique(ranges[:, 0])
    assert plan.ctas == len(ctas) and np.array_equal(ctas, np.arange(plan.ctas))
    assert plan.ctas == (0 if n == 0 else -(-max(16 * plan.n_vec,
                                                   plan.head + plan.tail)
                                              // CHUNK))
    assert plan.ctas <= -(-n // CHUNK) + 1
    if src == dst:
        # the vector body: a head up to src's 16-byte boundary, whole
        # vectors, fewer than 16 tail bytes
        assert plan.head == min((16 - src) % 16, n) and plan.tail < 16
        assert plan.head + 16 * plan.n_vec + plan.tail == n
        assert plan.chunks == -(-plan.n_vec // stream.CHUNK_VECS)
    else:
        # every byte byte-wise, a chunk of bytes a CTA
        assert (plan.head, plan.n_vec, plan.tail) == (n, 0, 0)
        assert plan.ctas == -(-n // CHUNK)


@pytest.mark.parametrize("rows,k", [(1, 8), (2047, 8), (2048, 8), (2049, 8),
                                    (1_048_576, 64), (524_288, 128),
                                    (100, 4104), (4, 4104)])
def test_copy_rm_bytes_take_the_same_plan(rows, k):
    """``copy_rm`` launches the template over rows · K · 2 bytes into a
    16-byte aligned output: the body where the stream is aligned, bytes
    where it is an offset view (2 bytes past a boundary)."""
    n = rows * k * 2
    aligned, offset = stream.copy_plan(n, 0, 0), stream.copy_plan(n, 2, 0)
    assert (aligned.head, aligned.tail) == (0, 0)
    assert aligned.ctas == -(-n // CHUNK) and offset.ctas == -(-n // CHUNK)
    assert _covered_once(stream.cta_ranges(aligned), n)
    assert _covered_once(stream.cta_ranges(offset), n)


def test_mirror_constants_match_the_header():
    header = (Path(stream.__file__).resolve().parent.parent / "csrc"
              / "stream_copy.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", header))
    assert int(consts["kThreads"]) == stream.THREADS
    assert "constexpr int64_t kChunkVecs = kThreads;" in header
    assert stream.CHUNK_VECS == stream.THREADS
    assert stream.CHUNK_BYTES == 16 * stream.THREADS
