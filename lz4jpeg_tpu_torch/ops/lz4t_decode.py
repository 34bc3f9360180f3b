"""Device decode of the fast (LZ4T) frame.

Port of ``lz4jpeg_tpu/ops/lz4t_decode.py``:

1. **Framing + parse (host).**  One native pass
   (``lz4core.cpp::lz4t_build_copy_program``) turns the frame into a copy
   program: a dense (B, P) grid where every output byte is a literal or
   the intra-block index it copies from (``src == -1`` marks literals).
   ``_parse_payload`` is the Python spec of the same walk.
2. **Match resolution (device).**  On a CUDA device the program is built
   fully rooted (``depth_cap=1``: every match points at a literal) and
   ``resolve_rooted`` gathers it in one pass — the hand-written Hopper
   kernel ``csrc/resolve_kernel.cu``, replacing the TPU's one-hot matmul
   resolve (``_mxu_resolve_kernel``).  It takes any P, so the TPU's
   ``P % 4096`` gate does not carry over.  On the CPU the JAX package's
   non-TPU route stays: ``depth_cap=4`` and ``resolve_blocks``, batched
   pointer doubling with ``torch.gather``.

Every route verifies the frame's content checksum after the resolve.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import Tuple

import numpy as np
import torch

from lz4jpeg_tpu_torch.formats.fast_frame import (
    MAGIC,
    RAW_FLAG,
    VERSION,
    FastFormatError,
    verify_frame_checksum,
)
from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.native import native_backend

# The host pre-roots chains deeper than this during the program build, so
# pointer doubling runs at most ceil(log2(cap)) gather steps.
DEVICE_DEPTH_CAP = 4


def build_copy_program_fast(
    frame: bytes, depth_cap: int = DEVICE_DEPTH_CAP, engine: str = "native"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """LZ4T frame → ``(lit (B, P) u8, src (B, P) i32, raw_sizes (B,), P,
    max_depth)``.

    ``src == -1`` marks literal positions; match positions hold their
    intra-block source index.  Self-overlapping (periodic) matches collapse
    to one hop into the source period, chains deeper than ``depth_cap`` are
    pre-rooted, and ``max_depth`` is the longest remaining chain.
    ``engine="native"`` runs the C++ builder, ``"python"`` the spec walk
    (same output).  Malformed frames raise ``FastFormatError``."""
    if engine not in ("native", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    if len(frame) < 20:
        raise FastFormatError("frame too short")
    magic, version, block_log, _res, raw_size, block_count = struct.unpack_from(
        "<IBBHQI", frame, 0
    )
    if magic != MAGIC:
        raise FastFormatError("bad magic")
    if version != VERSION:
        raise FastFormatError(f"unsupported version {version}")
    p = 1 << block_log
    if block_count == 0:
        return (
            np.zeros((0, p), np.uint8),
            np.full((0, p), -1, np.int32),
            np.zeros(0, np.int64),
            p,
            0,
        )
    if engine == "native":
        try:
            lit, src, sizes, depth = native_backend().build_copy_program(
                frame, block_count, p, depth_cap
            )
        except RuntimeError as e:
            raise FastFormatError(str(e)) from e
        return lit, src, sizes, p, depth

    try:
        sizes_tab = struct.unpack_from(f"<{block_count}I", frame, 20)
    except struct.error as e:
        raise FastFormatError(f"truncated size table: {e}") from e
    # Prefix-sum framing: the up-front size table gives every payload's
    # offset without touching the payloads.
    payload_lens = np.asarray(
        [s & ~RAW_FLAG if s & RAW_FLAG else s for s in sizes_tab], np.int64
    )
    offsets = 20 + 4 * block_count + np.concatenate(
        [[0], np.cumsum(payload_lens[:-1])]
    )
    lit = np.zeros((block_count, p), np.uint8)
    src = np.full((block_count, p), -1, np.int32)
    raw_sizes = np.zeros(block_count, np.int64)
    done = 0
    max_depth = 0
    for b, rec in enumerate(sizes_tab):
        expected = min(p, raw_size - done)
        start = int(offsets[b])
        if rec & RAW_FLAG:
            length = rec & ~RAW_FLAG
            if length != expected:
                raise FastFormatError(f"raw block {b} size mismatch")
            lit[b, :length] = np.frombuffer(frame, np.uint8, length, start)
        else:
            d = _parse_payload(
                frame[start : start + rec], lit[b], src[b], expected,
                depth_cap,
            )
            max_depth = max(max_depth, d)
        raw_sizes[b] = expected
        done += expected
    if done != raw_size:
        raise FastFormatError("frame size mismatch")
    return lit, src, raw_sizes, p, max_depth


def _parse_payload(
    payload: bytes, lit_row: np.ndarray, src_row: np.ndarray, expected: int,
    depth_cap: int = DEVICE_DEPTH_CAP,
) -> int:
    """One block's payload → its copy-program row (Python spec path).
    Returns the block's maximum (post-cap) chain depth."""
    depth = np.zeros(expected, np.int32)
    root = np.arange(expected, dtype=np.int32)
    depth_cap = max(1, depth_cap)
    q, w, n = 0, 0, len(payload)
    while q < n:
        token = payload[q]
        q += 1
        run = token >> 4
        if run == 15:
            while True:
                if q >= n:
                    raise FastFormatError("truncated literal extension")
                e = payload[q]
                q += 1
                run += e
                if e != 255:
                    break
        if q + run > n or w + run > expected:
            raise FastFormatError("truncated literals")
        lit_row[w : w + run] = np.frombuffer(payload, np.uint8, run, q)
        q += run
        w += run
        if q == n:
            break  # final literals-only sequence
        if q + 2 > n:
            raise FastFormatError("truncated offset")
        offset = payload[q] | (payload[q + 1] << 8)
        q += 2
        if offset == 0 or offset > w:
            raise FastFormatError("bad match offset")
        ml = (token & 0xF) + 4
        if token & 0xF == 15:
            while True:
                if q >= n:
                    raise FastFormatError("truncated match extension")
                e = payload[q]
                q += 1
                ml += e
                if e != 255:
                    break
        if w + ml > expected:
            raise FastFormatError("match overruns block")
        # Periodic self-overlap collapses to one hop into the source period.
        j = np.arange(ml, dtype=np.int32)
        s = w - offset + np.where(j < offset, j, j % offset)
        d = depth[s] + 1
        deep = d > depth_cap
        s = np.where(deep, root[s], s)  # pre-root deep chains
        d = np.where(deep, 1, d)
        src_row[w : w + ml] = s
        depth[w : w + ml] = d
        root[w : w + ml] = root[s]
        w += ml
    if w != expected:
        raise FastFormatError("decoded size mismatch")
    return int(depth.max(initial=0))


def depth_to_steps(max_depth: int) -> int:
    """Doubling steps needed to root chains of the given depth
    (2**steps ≥ depth; depth ≤ 1 is already rooted by the initial hop)."""
    return max(0, max_depth - 1).bit_length()


def root_program(src: torch.Tensor) -> torch.Tensor:
    """(B, P) int32 ``src`` → roots with literals rooted at themselves
    (``src == -1`` → own index)."""
    idx = torch.arange(src.shape[1], dtype=src.dtype, device=src.device)
    return torch.where(src < 0, idx[None, :], src)


def resolve_blocks(lit: torch.Tensor, src: torch.Tensor, steps: int):
    """Batched per-block pointer doubling: (B, P) copy program → bytes.

    After k doublings every chain of depth ≤ 2^k is rooted, so ``steps =
    depth_to_steps(max_depth)``; literals root at themselves (the
    doubling fixpoint)."""
    root = root_program(src).long()
    for _ in range(steps):
        root = torch.gather(root, 1, root)
    return torch.gather(lit, 1, root)


def _check(lit: torch.Tensor, root: torch.Tensor):
    if lit.dtype != torch.uint8 or root.dtype != torch.int32:
        raise TypeError(f"expected uint8 literals and int32 roots, got "
                        f"{lit.dtype} and {root.dtype}")
    if lit.dim() != 2 or lit.shape != root.shape:
        raise ValueError(f"expected equal (B, P) shapes, got "
                         f"{tuple(lit.shape)} and {tuple(root.shape)}")
    if lit.device != root.device:
        raise ValueError("literals and roots lie on different devices")
    if not (lit.is_contiguous() and root.is_contiguous()):
        raise ValueError("literals and roots must be contiguous")


def resolve_rooted_ref(lit: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the rooted resolve: one gather."""
    _check(lit, root)
    return torch.gather(lit, 1, root.long())


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/resolve_kernel.cu`` (at first use), load and bind it."""
    lib = load_cuda_library("resolve_kernel")
    lib.resolve_rooted_launch.restype = ctypes.c_int
    lib.resolve_rooted_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.resolve_kernel_error_string.restype = ctypes.c_char_p
    lib.resolve_kernel_error_string.argtypes = [ctypes.c_int]
    return lib


def resolve_rooted(lit: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
    """(B, P) uint8 literals + (B, P) int32 fully rooted sources → bytes
    ``lit[b, root[b, i]]``.

    A CPU tensor runs ``resolve_rooted_ref``.  A CUDA tensor launches the
    Hopper kernel on the current stream and adds one to
    ``resolve_rooted.launches``; a refused launch raises."""
    _check(lit, root)
    if lit.device.type == "cpu":
        return resolve_rooted_ref(lit, root)
    if lit.device.type != "cuda":
        raise ValueError(f"unsupported device {lit.device}")
    b, p = lit.shape
    out = torch.empty_like(lit)
    if out.numel() == 0:
        return out
    lib = load_kernel()
    with torch.cuda.device(lit.device):
        stream = torch.cuda.current_stream(lit.device).cuda_stream
        rc = lib.resolve_rooted_launch(
            lit.data_ptr(), root.data_ptr(), out.data_ptr(), b, p, stream
        )
    if rc != 0:
        msg = lib.resolve_kernel_error_string(rc).decode()
        raise RuntimeError(f"resolve_kernel launch failed: {msg} ({rc})")
    resolve_rooted.launches += 1
    return out


resolve_rooted.launches = 0


def device_depth_cap(device) -> int:
    """Program depth for a decode on ``device``: fully rooted (1) for the
    kernel on a CUDA device, ``DEVICE_DEPTH_CAP`` for pointer doubling on
    the CPU."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return 1 if device.type == "cuda" else DEVICE_DEPTH_CAP


def resolve_on_device(lit: torch.Tensor, src: torch.Tensor, steps: int):
    """(B, P) uint8 literals + int32 sources on one device → bytes there.

    CUDA: ``steps`` doublings root the program (none for a program built
    with ``device_depth_cap``), then ``resolve_rooted`` launches the
    kernel.  CPU: ``resolve_blocks``."""
    if lit.device.type != "cuda":
        return resolve_blocks(lit, src, steps)
    root = root_program(src)
    if steps:
        root = root.long()
        for _ in range(steps):
            root = torch.gather(root, 1, root)
        root = root.to(torch.int32)
    return resolve_rooted(lit, root.contiguous())


def decode_fast_device(frame: bytes, device) -> bytes:
    """Full LZ4T decode with the match resolution on ``device``: the copy
    program built to ``device_depth_cap``, literals and sources go up,
    ``resolve_on_device`` (the kernel on a CUDA device), the bytes come
    back."""
    device = torch.device(device)
    lit, src, raw_sizes, p, max_depth = build_copy_program_fast(
        frame, depth_cap=device_depth_cap(device)
    )
    if lit.shape[0] == 0:
        return b""
    out = resolve_on_device(
        torch.from_numpy(lit).to(device), torch.from_numpy(src).to(device),
        depth_to_steps(max_depth),
    )
    decoded = _trim_rows(out.cpu().numpy(), raw_sizes)
    verify_frame_checksum(frame, decoded)
    return decoded


def _trim_rows(out: np.ndarray, raw_sizes: np.ndarray) -> bytes:
    if int(raw_sizes.min(initial=out.shape[1])) == out.shape[1]:
        return out.tobytes()  # only full blocks — no ragged tail
    parts = [out[b, : int(n)].tobytes() for b, n in enumerate(raw_sizes)]
    return b"".join(parts)
