"""The fused LZ4 matcher: one kernel for keys → sort → candidates → un-sort.

Port of ``lz4jpeg_tpu/ops/pallas_match.py``.  ``match_candidates`` maps
(B, P) uint8 blocks and their lengths to the (B, P/stride) int32 packed
words ``(lcp << pos_bits) | dist_anchors`` (or 0) per anchor in original
order — the contract of the TPU kernel ``_match_kernel`` with its key and
payload pre-pass folded in.  On a CUDA tensor it launches the hand-written
Hopper kernel ``csrc/match_kernel.cu``; on a CPU tensor it runs
``match_candidates_ref``, the plain torch version.  There is no fallback
between the two: a CUDA call launches the kernel or raises.

``fast_match_blocks_fused`` wraps it with the Pallas wrapper's post-pass
(distance, segment and block-end caps; the greedy parse on the anchor grid;
stride expansion to the byte grid), ``ops/lz4_parse.py::parse_candidates``
(K10 on a CUDA tensor), and returns byte-level ``(is_match, emit_len,
emit_dist)`` fields, as ``ops/lz4_fast.py::fast_match_blocks``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.lz4_fast import (
    INVALID_BUCKET,
    _lcp_from_payloads,
    _shift_back,
    hash16,
)
from lz4jpeg_tpu_torch.ops.lz4_parse import parse_candidates


def _geometry(p: int, stride: int, lcp_words: int):
    """(Pa, pos_bits) of a block of P bytes; raises on what the kernel does
    not take (the Pallas wrapper's gate, ``pallas_match.py:233-238``, with
    the int32 key bound in place of its (8, 128) tiling)."""
    if stride < 1 or p % stride:
        raise ValueError(f"block size {p} is not a multiple of stride {stride}")
    if lcp_words not in (1, 2, 3, 4):
        raise ValueError(f"lcp_words must be in 1..4: {lcp_words}")
    pa = p // stride
    if pa < 1 or pa & (pa - 1):
        raise ValueError(f"anchors per block ({pa}) must be a power of two")
    pos_bits = (pa - 1).bit_length()
    if (INVALID_BUCKET + pa) << pos_bits >= 1 << 31:
        raise ValueError(f"{pa} anchors per block overflow the int32 keys")
    return pa, pos_bits


def _check(blocks: torch.Tensor, lengths: torch.Tensor):
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise TypeError(f"expected (B, P) uint8 blocks, got {blocks.dtype} "
                        f"{tuple(blocks.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != blocks.shape[:1]:
        raise TypeError(f"expected ({blocks.shape[0]},) int32 lengths, got "
                        f"{lengths.dtype} {tuple(lengths.shape)}")
    if lengths.device != blocks.device:
        raise ValueError("blocks and lengths lie on different devices")
    if not (blocks.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("blocks and lengths must be contiguous")


def match_candidates_ref(
    blocks: torch.Tensor, lengths: torch.Tensor, stride: int, lcp_words: int
) -> torch.Tensor:
    """Plain torch version: the Pallas wrapper's pre-pass (strided window
    words, hash, unique invalid buckets), ``torch.sort`` of the keys with a
    gather of the payload words, the 1-back/2-back candidates, and a
    scatter back to anchor order.  (B, P) uint8 → (B, Pa) int32."""
    _check(blocks, lengths)
    b, p = blocks.shape
    pa, pos_bits = _geometry(p, stride, lcp_words)
    dev = blocks.device
    x = blocks.to(torch.int64)
    aidx = torch.arange(pa, dtype=torch.int64, device=dev)

    def byte_at(c):
        """(B, Pa): byte ``stride·a + c`` per anchor a, 0 past the end."""
        col = x[:, c::stride][:, :pa]
        return torch.nn.functional.pad(col, (0, pa - col.shape[1]))

    def pack_anchor(k):
        return (byte_at(4 * k) | (byte_at(4 * k + 1) << 8)
                | (byte_at(4 * k + 2) << 16) | (byte_at(4 * k + 3) << 24))

    pays = [pack_anchor(k) for k in range(lcp_words)]
    ok = aidx[None, :] * stride + 4 <= lengths.to(torch.int64)[:, None]
    h = torch.where(ok, hash16(pays[0]), INVALID_BUCKET + aidx[None, :])
    key_s, order = torch.sort((h << pos_bits) | aidx[None, :], dim=1)
    pays_s = [torch.gather(w, 1, order) for w in pays]
    bucket = key_s >> pos_bits
    pos = key_s & ((1 << pos_bits) - 1)

    def candidate(shift):
        same = (bucket == _shift_back(bucket, shift, -1)) & (
            bucket < INVALID_BUCKET
        )
        dist = pos - _shift_back(pos, shift, 0)
        lcp = _lcp_from_payloads(pays_s, shift)
        good = same & (lcp >= 4)
        return torch.where(good, lcp, 0).to(torch.int64), torch.where(good, dist, 0)

    len1, dist1 = candidate(1)
    len2, dist2 = candidate(2)
    better2 = len2 > len1  # ties keep the nearer (1-back) neighbor
    cand = torch.where(better2, (len2 << pos_bits) | dist2,
                       (len1 << pos_bits) | dist1)
    cand = torch.where((cand & ((1 << pos_bits) - 1)) > 0, cand, 0)
    return torch.empty_like(cand).scatter_(1, pos, cand).to(torch.int32)


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/match_kernel.cu`` (at first use), load and bind it."""
    lib = load_cuda_library("match_kernel")
    lib.match_candidates_launch.restype = ctypes.c_int
    lib.match_candidates_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.match_kernel_error_string.restype = ctypes.c_char_p
    lib.match_kernel_error_string.argtypes = [ctypes.c_int]
    return lib


def match_candidates(
    blocks: torch.Tensor, lengths: torch.Tensor, stride: int, lcp_words: int
) -> torch.Tensor:
    """(B, P) uint8 blocks + (B,) int32 lengths → (B, P/stride) int32
    packed candidate words.

    A CPU tensor runs ``match_candidates_ref``.  A CUDA tensor launches the
    Hopper kernel on the current stream and adds one to
    ``match_candidates.launches``; a refused launch raises."""
    _check(blocks, lengths)
    if blocks.device.type == "cpu":
        return match_candidates_ref(blocks, lengths, stride, lcp_words)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    b, p = blocks.shape
    pa, pos_bits = _geometry(p, stride, lcp_words)
    out = torch.empty((b, pa), dtype=torch.int32, device=blocks.device)
    if b == 0:
        return out
    lib = load_kernel()
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        rc = lib.match_candidates_launch(
            blocks.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, p,
            stride, pa, pos_bits, 4 * lcp_words, stream,
        )
    if rc != 0:
        msg = lib.match_kernel_error_string(rc).decode()
        raise RuntimeError(f"match_kernel launch failed: {msg} ({rc})")
    match_candidates.launches += 1
    return out


match_candidates.launches = 0


def fast_match_blocks_fused(
    blocks: torch.Tensor,
    lengths: torch.Tensor,
    max_dist: int = 65535,
    stride: int = 1,
    lcp_words: int = 2,
    seg: int = 512,
):
    """Drop-in for ``ops/lz4_fast.py::fast_match_blocks`` built on
    ``match_candidates``.  Returns byte-level ``(is_match, emit_len,
    emit_dist)`` (B, P) int32 fields; matches start only on anchors
    (multiples of ``stride``) and are capped at ``4·lcp_words`` bytes —
    emission extends them greedily, as with the sort matcher."""
    x = blocks if blocks.dtype == torch.uint8 else blocks.to(torch.uint8)
    lengths = lengths.to(device=blocks.device, dtype=torch.int32)
    packed = match_candidates(
        x.contiguous(), lengths.contiguous(), stride, lcp_words
    )
    return parse_candidates(packed, lengths, blocks.shape[1], max_dist,
                            stride, seg)
