"""The packed16 pair layout's compaction and expansion kernels.

Port of ``lz4jpeg_tpu/ops/pallas_rle.py``.  A packed16 word holds one
[count, value] run pair as ``(count - 1) << 10 | (value + 512)``; a block's
runs are front-compacted and the slots past them are 0, with the symbol count
(2·runs) in a side channel of lengths.  Four wrappers, each with a plain torch
version of the same function:

* ``pack16_encode``: (N, L) values → (N, L) packed words + lengths
  (K4, ``_rle_pack16_kernel``);
* ``pack16_encode_kt``: the same from the plane (KT) layout (R, K, C)
  (K5, ``_rle_pack16_kt_kernel``);
* ``pack16_decode``: packed words + lengths → (N, out_size) int32 values
  (K6, ``_rle_decode_kt_kernel``);
* ``pack16_decode_plane``: the same into the plane layout (bh, K, bw) int16
  (K7, ``_rle_decode_kt_plane_kernel``);
* ``pack16_decode_wide``: K6 with out_size = K, int16 out, lane-dense over
  the flat word stream (K8, ``_rle_decode_wide_kernel``).

A CPU tensor runs the plain version; a CUDA tensor launches the Hopper kernel
(``csrc/pack16_kernel.cu``, ``csrc/expand16_kernel.cu``,
``csrc/expand16_wide_kernel.cu``) or raises.  Packed
words are int16 tensors holding the uint16 bit patterns (``torch.uint16``
supports few operations), viewed as uint16 only at the numpy boundary.

The decoders compute ``lz4jpeg_tpu/ops/rle.py::rle_decode_packed16`` on every
input: validity comes from ``lengths // 2`` (a word of 0 is value -512 with
count 1 when it is valid), runs past ``out_size`` are cut, and positions no
run covers are 0.  The Pallas decoders ignore ``lengths`` and treat word 0 as
padding; the two agree on canonical streams.  The TPU's 128-lane gates (row
padding, ``C % 128``, ``N % 128``, ``bw % 128``, K8's ``N·K % 2048``) are
gone: any N, C and bw work.  Only the format's own limit stays: a segment is a power of two of at
most 64 slots, because the count field has 6 bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library

PACK16_VALUE_BIAS = 512  # value + 512 in the low 10 bits, count - 1 above
MAX_SEG = 64


def _check_seg(seg: int) -> None:
    if seg < 1 or seg & (seg - 1) or seg > MAX_SEG:
        raise ValueError(
            f"segment length {seg} must be a power of two ≤ {MAX_SEG} "
            "(6-bit count field of the packed word)"
        )


def _check_device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("inputs lie on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _values(x: torch.Tensor, dims: int) -> torch.Tensor:
    if x.dim() != dims:
        raise ValueError(f"expected {dims} dimensions, got {tuple(x.shape)}")
    if x.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"expected int16 or int32 values, got {x.dtype}")
    return x.contiguous()


def _packed(packed: torch.Tensor, lengths: torch.Tensor):
    if packed.dim() != 2:
        raise ValueError(f"expected (N, K) packed words, got {tuple(packed.shape)}")
    if packed.dtype == torch.uint16:
        packed = packed.view(torch.int16)
    if packed.dtype != torch.int16:
        raise TypeError(f"expected int16 (uint16 bits) words, got {packed.dtype}")
    if lengths.shape != packed.shape[:1]:
        raise ValueError(
            f"lengths {tuple(lengths.shape)} do not match {tuple(packed.shape)}"
        )
    _check_seg(packed.shape[1])
    return packed.contiguous(), lengths.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _rle_runs(values: torch.Tensor):
    """(N, L) blocks → (counts, run_values, num_runs): (N, L), (N, L), (N,)
    int32, valid runs front-compacted, invalid slots zero.

    Sort-diff compaction (``lz4jpeg_tpu/ops/rle.py::_rle_runs``): run starts
    keyed by position (non-starts keyed L) sort to the front in order, the
    run's value rides along, and each run's count is the gap to the next
    sorted start."""
    x = values.to(torch.int32)
    length = x.shape[1]
    idx = torch.arange(length, dtype=torch.int32, device=x.device)
    starts = torch.ones_like(x, dtype=torch.bool)
    starts[:, 1:] = x[:, 1:] != x[:, :-1]
    key_sorted, order = torch.sort(torch.where(starts, idx, length), dim=1,
                                   stable=True)
    nxt = torch.full_like(key_sorted, length)
    nxt[:, :-1] = key_sorted[:, 1:]
    valid_run = key_sorted < length
    counts = torch.where(valid_run, nxt - key_sorted, 0)
    run_values = torch.where(valid_run, torch.gather(x, 1, order), 0)
    return counts, run_values, starts.sum(dim=1, dtype=torch.int32)


def pack_words(counts: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Run counts and values → int16 packed words; slots of count 0 (padding)
    are 0."""
    words = ((counts - 1).clamp(min=0) << 10) | (values + PACK16_VALUE_BIAS)
    return torch.where(counts > 0, words, 0).to(torch.int16)


def pack16_encode_ref(values: torch.Tensor):
    """Plain version of K4: (N, L) int blocks → ((N, L) int16 packed words,
    (N,) int32 lengths = 2·runs), for any L."""
    counts, run_values, num_runs = _rle_runs(values)
    return pack_words(counts, run_values), 2 * num_runs


def pack16_encode_kt_ref(zz_kt: torch.Tensor):
    """Plain version of K5: (R, K, C) blocks (block positions along the middle
    axis) → ((R·C, K) packed words, (R·C,) lengths) in block-row-major order."""
    r, k, c = zz_kt.shape
    return pack16_encode_ref(zz_kt.transpose(1, 2).reshape(r * c, k))


def expand_runs(counts: torch.Tensor, values: torch.Tensor,
                lengths: torch.Tensor, out_size: int) -> torch.Tensor:
    """(N, K) run counts and values, (N,) symbol lengths → (N, out_size) int32.

    Pair slots below ``lengths // 2`` are valid; run k covers positions
    [begin_k, begin_k + count_k) with begins the exclusive prefix sum of the
    valid counts.  Position p takes the value of the last valid run that
    begins at or before p, and 0 at or past the covered total.  Works in
    (N, K) and (N, out_size) memory (the JAX spec builds an (N, out_size, K)
    membership tensor)."""
    n, k = counts.shape
    dev = counts.device
    if k == 0:
        return torch.zeros((n, out_size), dtype=torch.int32, device=dev)
    valid = torch.arange(k, device=dev)[None, :] < torch.div(
        lengths.to(torch.int64), 2, rounding_mode="floor")[:, None]
    counts = torch.where(valid, counts.to(torch.int64), 0)
    ends = torch.cumsum(counts, dim=1)
    begins = (ends - counts).contiguous()  # non-decreasing; invalid = total
    pos = torch.arange(out_size, dtype=torch.int64, device=dev)
    pos = pos.expand(n, out_size).contiguous()
    rank = torch.searchsorted(begins, pos, right=True) - 1
    picked = torch.gather(values.to(torch.int32), 1, rank.clamp(min=0))
    return torch.where(pos < ends[:, -1:], picked, 0)


def unpack16_pairs(packed: torch.Tensor):
    """(N, K) packed words → (counts, values), each (N, K) int32.  Padding
    slots decode to count 1, value -512; the lengths say which slots are
    valid."""
    p = packed.to(torch.int32) & 0xFFFF
    return (p >> 10) + 1, (p & 0x3FF) - PACK16_VALUE_BIAS


def pack16_decode_ref(packed: torch.Tensor, lengths: torch.Tensor,
                      out_size: int) -> torch.Tensor:
    """Plain version of K6: (N, K) packed words + (N,) lengths → (N,
    out_size) int32 values, as ``rle_decode_packed16``, for any K and
    out_size."""
    counts, vals = unpack16_pairs(packed)
    return expand_runs(counts, vals, lengths, out_size)


def pack16_decode_plane_ref(packed: torch.Tensor, lengths: torch.Tensor,
                            bw: int) -> torch.Tensor:
    """Plain version of K7: (bh·bw, K) packed words → (bh, K, bw) int16."""
    n, k = packed.shape
    zz = pack16_decode_ref(packed, lengths, k)
    return zz.reshape(n // bw, bw, k).transpose(1, 2).contiguous().to(torch.int16)


def pack16_decode_wide_ref(packed: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: (N, K) packed words + (N,) lengths → (N, K)
    int16 values, K6's plain version at out_size = K."""
    packed, lengths = _packed(packed, lengths)
    return pack16_decode_ref(packed, lengths, packed.shape[1]).to(torch.int16)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def load_pack_kernels() -> ctypes.CDLL:
    """Build ``csrc/pack16_kernel.cu`` (K4, K5) at first use and bind it."""
    lib = load_cuda_library("pack16_kernel")
    lib.pack16_rows_launch.restype = ctypes.c_int
    lib.pack16_rows_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.pack16_kt_launch.restype = ctypes.c_int
    lib.pack16_kt_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.pack16_kernel_error_string.restype = ctypes.c_char_p
    lib.pack16_kernel_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def load_expand_kernels() -> ctypes.CDLL:
    """Build ``csrc/expand16_kernel.cu`` (K6, K7) at first use and bind it."""
    lib = load_cuda_library("expand16_kernel")
    lib.expand16_rows_launch.restype = ctypes.c_int
    lib.expand16_rows_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.expand16_plane_launch.restype = ctypes.c_int
    lib.expand16_plane_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.expand16_plane_attributes.restype = ctypes.c_int
    lib.expand16_plane_attributes.argtypes = (
        [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3)
    lib.expand16_kernel_error_string.restype = ctypes.c_char_p
    lib.expand16_kernel_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def load_wide_kernel() -> ctypes.CDLL:
    """Build ``csrc/expand16_wide_kernel.cu`` (K8) at first use and bind it."""
    lib = load_cuda_library("expand16_wide_kernel")
    lib.expand16_wide_launch.restype = ctypes.c_int
    lib.expand16_wide_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.expand16_wide_error_string.restype = ctypes.c_char_p
    lib.expand16_wide_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch(lib, fn_name: str, err_name: str, dev: torch.device, *args):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        msg = getattr(lib, err_name)(rc).decode()
        raise RuntimeError(f"{fn_name} failed: {msg} ({rc})")


def _elem_code(x: torch.Tensor) -> int:
    return 2 if x.dtype == torch.int16 else 4


def pack16_encode(values: torch.Tensor):
    """(N, L) int16/int32 blocks → ((N, L) int16 packed words, (N,) int32
    lengths = 2·runs); L a power of two ≤ 64.

    A CPU tensor runs ``pack16_encode_ref``.  A CUDA tensor launches K4 on
    the current stream and adds one to ``pack16_encode.launches``."""
    x = _values(values, 2)
    _check_seg(x.shape[1])
    dev = _check_device(x)
    if dev.type == "cpu":
        return pack16_encode_ref(x)
    if x.data_ptr() % 16:  # the kernel loads 16 bytes a lane
        x = x.clone()
    n, seg = x.shape
    packed = torch.empty((n, seg), dtype=torch.int16, device=dev)
    lengths = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        _launch(load_pack_kernels(), "pack16_rows_launch",
                "pack16_kernel_error_string", dev, x.data_ptr(), _elem_code(x),
                packed.data_ptr(), lengths.data_ptr(), n, seg)
        pack16_encode.launches += 1
    return packed, lengths


def pack16_encode_kt(zz_kt: torch.Tensor):
    """(R, K, C) int16/int32 blocks in the plane layout → ((R·C, K) int16
    packed words, (R·C,) int32 lengths) in block-row-major order.

    A CPU tensor runs ``pack16_encode_kt_ref``.  A CUDA tensor launches K5
    and adds one to ``pack16_encode_kt.launches``."""
    x = _values(zz_kt, 3)
    r, seg, c = x.shape
    _check_seg(seg)
    dev = _check_device(x)
    if dev.type == "cpu":
        return pack16_encode_kt_ref(x)
    packed = torch.empty((r * c, seg), dtype=torch.int16, device=dev)
    lengths = torch.empty((r * c,), dtype=torch.int32, device=dev)
    if r * c:
        _launch(load_pack_kernels(), "pack16_kt_launch",
                "pack16_kernel_error_string", dev, x.data_ptr(), _elem_code(x),
                packed.data_ptr(), lengths.data_ptr(), r, seg, c)
        pack16_encode_kt.launches += 1
    return packed, lengths


def pack16_decode(packed: torch.Tensor, lengths: torch.Tensor,
                  out_size: int) -> torch.Tensor:
    """(N, K) packed words + (N,) lengths → (N, out_size) int32 values;
    K a power of two ≤ 64 and 1 ≤ out_size ≤ 64.

    A CPU tensor runs ``pack16_decode_ref``.  A CUDA tensor launches K6 and
    adds one to ``pack16_decode.launches``."""
    packed, lengths = _packed(packed, lengths)
    if not 1 <= out_size <= MAX_SEG:
        raise ValueError(f"out_size {out_size} must lie in [1, {MAX_SEG}]")
    dev = _check_device(packed, lengths)
    if dev.type == "cpu":
        return pack16_decode_ref(packed, lengths, out_size)
    n, seg = packed.shape
    out = torch.empty((n, out_size), dtype=torch.int32, device=dev)
    if n:
        _launch(load_expand_kernels(), "expand16_rows_launch",
                "expand16_kernel_error_string", dev, packed.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), n, seg, out_size)
        pack16_decode.launches += 1
    return out


def pack16_decode_plane(packed: torch.Tensor, lengths: torch.Tensor,
                        bw: int) -> torch.Tensor:
    """(bh·bw, K) packed words (block-row-major) + lengths → (bh, K, bw)
    int16 values in the plane layout.

    A CPU tensor runs ``pack16_decode_plane_ref``.  A CUDA tensor launches
    K7 and adds one to ``pack16_decode_plane.launches``."""
    packed, lengths = _packed(packed, lengths)
    n, seg = packed.shape
    if bw < 1 or n % bw:
        raise ValueError(f"bad plane shape: N={n}, bw={bw}")
    dev = _check_device(packed, lengths)
    if dev.type == "cpu":
        return pack16_decode_plane_ref(packed, lengths, bw)
    if packed.data_ptr() % 16:  # the kernel loads up to 16 bytes a lane
        packed = packed.clone()
    out = torch.empty((n // bw, seg, bw), dtype=torch.int16, device=dev)
    if n:
        _launch(load_expand_kernels(), "expand16_plane_launch",
                "expand16_kernel_error_string", dev, packed.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), n // bw, bw, seg)
        pack16_decode_plane.launches += 1
    return out


def pack16_decode_wide(packed: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """(N, K) packed words + (N,) lengths → (N, K) int16 values, K a power
    of two ≤ 64: ``pack16_decode`` at out_size = K, read lane-dense.

    A CPU tensor runs ``pack16_decode_wide_ref``.  A CUDA tensor launches K8
    and adds one to ``pack16_decode_wide.launches``."""
    packed, lengths = _packed(packed, lengths)
    dev = _check_device(packed, lengths)
    if dev.type == "cpu":
        return pack16_decode_wide_ref(packed, lengths)
    if packed.data_ptr() % 16:  # the kernel loads up to 16 bytes a lane
        packed = packed.clone()
    n, seg = packed.shape
    out = torch.empty((n, seg), dtype=torch.int16, device=dev)
    if n:
        _launch(load_wide_kernel(), "expand16_wide_launch",
                "expand16_wide_error_string", dev, packed.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), n, seg)
        pack16_decode_wide.launches += 1
    return out


for _wrapper in (pack16_encode, pack16_encode_kt, pack16_decode,
                 pack16_decode_plane, pack16_decode_wide):
    _wrapper.launches = 0
