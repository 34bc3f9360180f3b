"""The cast kernel's launch plan on the CPU.

``csrc/cast_kernel.cu`` is CUDA only.  Here ``profiles/casts.py::
cast_plan`` and ``cta_ranges``, the Python mirror of its plan and of each
CTA's index arithmetic, are held to cover every element of a cast exactly
once, with one CTA a chunk and none idle, for each of the seven pairs at 0,
1, one vector - 1, a chunk ± 1 and a size whose output passes 2^31 bytes
(the plan only), and to load and store whole 128-byte lines a warp.  The
mirror's threads a CTA are read back from the source.  The card tests
(``tests/test_torch_cuda.py``) hold the mirror equal to the C code's plan
and the kernel bit-identical to ``x.to``.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from lz4jpeg_tpu_torch.profiles import casts

SOURCE = Path(casts.__file__).resolve().parent.parent / "csrc" / "cast_kernel.cu"


def _covered_once(ranges: np.ndarray, n: int) -> bool:
    """The (cta, start, stop) ranges tile [0, n) with no gap or overlap."""
    if n == 0:
        return len(ranges) == 0
    r = ranges[np.argsort(ranges[:, 1], kind="stable")]
    return (r[0, 1] == 0 and r[-1, 2] == n
            and bool(np.all(r[1:, 1] == r[:-1, 2])))


def _sizes(pair):
    plan = casts.cast_plan(pair, 0)
    vec, chunk = plan.vec_elems, plan.vec_elems * plan.threads
    big = (1 << 31) // casts.PAIRS[pair][1].itemsize + 17
    return [0, 1, vec - 1, vec, chunk - 1, chunk, chunk + 1, 3 * chunk + 5, big]


@pytest.mark.parametrize("pair", range(len(casts.PAIRS)))
def test_cast_plan_covers_every_element_once(pair):
    for n in _sizes(pair):
        plan = casts.cast_plan(pair, n)
        assert plan.n_vec * plan.vec_elems + plan.tail == n
        assert 0 <= plan.tail < plan.vec_elems
        ranges = casts.cta_ranges(plan)
        assert _covered_once(ranges, n), n
        ctas = np.unique(ranges[:, 0])
        assert plan.ctas == len(ctas) and np.array_equal(
            ctas, np.arange(plan.ctas)), n
        chunk = plan.threads * plan.vec_elems
        assert plan.ctas == max(-(-plan.n_vec // plan.threads),
                                -(-plan.tail // chunk))
        assert plan.ctas <= -(-n // chunk)
        if n > (1 << 31) // 4:
            # 64-bit offsets: the output passes 2^31 bytes
            assert n * casts.PAIRS[pair][1].itemsize > 1 << 31
            assert ranges[:, 2].max() == n


def test_mirror_threads_match_the_source():
    found = re.findall(r"constexpr int kThreads = (\d+);", SOURCE.read_text())
    assert [int(t) for t in found] == [casts.THREADS]


@pytest.mark.parametrize("pair", range(len(casts.PAIRS)))
def test_plan_shapes_are_whole_lines(pair):
    """A lane loads its vector's source bytes (4, 8 or 16) as one load and
    stores its results as one 16-byte vector, so a warp's load and its
    store each cover whole 128-byte lines."""
    src, dst = casts.PAIRS[pair]
    plan = casts.cast_plan(pair, 1 << 20)
    assert plan.vec_elems * dst.itemsize == 16
    assert plan.vec_elems * src.itemsize in (4, 8, 16)
    assert (32 * plan.vec_elems * src.itemsize) % 128 == 0
    assert plan.threads % 32 == 0
