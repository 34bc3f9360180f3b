"""``sass_diff.py``'s kernel names and pairing, on the CPU (no toolkit):
the demangled signatures are as ``cu++filt`` prints those of
``lz4jpeg_tpu_torch/csrc/expand16_kernel.cu`` and
``expand16_probe_kernel.cu``."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import sass_diff  # noqa: E402

PARAMS = "(const unsigned short *, const int *, short *, long long, long long, bool)"


def plane(k: int, phase=None) -> str:
    args = f"(int){k}" + ("" if phase is None else f", (<unnamed>::Phase){phase}")
    return f"void <unnamed>::expand16_plane_kernel<{args}>{PARAMS}"


ROWS = ("<unnamed>::expand16_rows_kernel(const unsigned short *, const int *, "
        "int *, long long, int, int)")


def keyed(names):
    return {sass_diff.kernel_key(n): i for i, n in enumerate(names)}


def test_kernel_key_keeps_every_template_argument():
    a, b = sass_diff.kernel_key(plane(64, 0)), sass_diff.kernel_key(plane(64, 4))
    assert a == ("expand16_plane_kernel", ("(int)64", "(Phase)0"))
    assert b == ("expand16_plane_kernel", ("(int)64", "(Phase)4"))
    assert a != b
    assert sass_diff.kernel_key(ROWS) == ("expand16_rows_kernel", ())
    assert sass_diff.kernel_key(
        "void (anonymous namespace)::k<(bool)1>(const short *)") == (
            "k", ("(bool)1",))


def test_a_defaulted_trailing_argument_pairs_with_the_old_template():
    this = keyed([plane(32, 4), plane(64, 4), ROWS])
    other = keyed([plane(32), plane(64), ROWS])
    pairs, here, there, ambiguous = sass_diff.pair_kernels(this, other)
    assert (here, there, ambiguous) == ([], [], [])
    assert sorted((a[1], b[1]) for a, b in pairs) == [
        ((), ()), (("(int)32", "(Phase)4"), ("(int)32",)),
        (("(int)64", "(Phase)4"), ("(int)64",))]


def test_two_instantiations_against_one_old_kernel_are_ambiguous():
    this = keyed([plane(64, 0), plane(64, 4)])
    other = keyed([plane(64)])
    pairs, here, there, ambiguous = sass_diff.pair_kernels(this, other)
    assert pairs == [] and ambiguous == [sass_diff.kernel_key(plane(64))]
    assert here == [] and there == []


@pytest.mark.parametrize("phases", [range(4), range(5)])
def test_every_instantiation_pairs_with_itself(phases):
    names = [plane(k, p) for k in (32, 64) for p in phases]
    this = keyed(names)
    assert len(this) == len(names)  # no two share a key
    pairs, here, there, ambiguous = sass_diff.pair_kernels(this, keyed(names))
    assert len(pairs) == len(names) and all(a == b for a, b in pairs)
    assert (here, there, ambiguous) == ([], [], [])


def test_a_kernel_on_one_side_only_is_reported():
    pairs, here, there, ambiguous = sass_diff.pair_kernels(
        keyed([plane(64, 4), ROWS]), keyed([plane(32)]))
    assert pairs == [] and ambiguous == []
    assert sorted(here) == sorted([sass_diff.kernel_key(plane(64, 4)),
                                   sass_diff.kernel_key(ROWS)])
    assert there == [sass_diff.kernel_key(plane(32))]
