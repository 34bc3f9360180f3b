"""Sharded LZ4 block parsing and decoding: blocks split over the mesh.

Port of ``lz4jpeg_tpu/parallel/lz4.py``.  It replaces the reference's
thread-per-block encode (``parallel_LZ4_encode``,
``Algorithms/parallel/LZ4/LZ4.c:680-779``): each shard of the block axis is
parsed on its device, and the ordered gather of the per-block results
(``parallel_add_block_to_frame``'s ``frame_blocks[index] = *block`` under a
lock, :495-514) is the in-order concatenation of the shards
(``mesh.py::gather_shards``).

Per shard, on a CUDA mesh:

* ``sharded_block_parse``: ``ops/lz4_parse.py::parity_parse``, the
  parity matcher K11 (``match_tables`` and ``greedy_parse`` as torch ops
  on a CPU mesh);
* ``sharded_fast_parse``: the Hopper kernels K2 and K10
  (``ops/fused_match.py::fast_match_blocks_fused``, stride 1 and 2 lcp
  words, the defaults of the JAX package's TPU route); on a CPU mesh the
  sort matcher with ``LCP_WORDS`` (4) words, as JAX runs off a TPU, so the
  fields depend on the platform as the reference's do;
* ``sharded_resolve_blocks``, ``sharded_fast_decode``,
  ``multihost_fast_decode``: ``ops/lz4t_decode.py::resolve_on_device``,
  the rooted-resolve kernel K3; on the CPU the pointer doubling of
  ``resolve_blocks``, as in JAX.

``multihost_fast_encode`` / ``multihost_fast_decode`` split the blocks over
the processes of a ``torch.distributed`` group (``parallel/multihost.py``)
and run on one device per process.  The encode runs the fast codec's own
device path (``LZ4Codec.block_payloads``: K2 on a card) on each process's
blocks.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from lz4jpeg_tpu_torch.config import LZ4Config
from lz4jpeg_tpu_torch.formats.fast_frame import (
    assemble_frame,
    verify_frame_checksum,
)
from lz4jpeg_tpu_torch.models.lz4 import LZ4Codec
from lz4jpeg_tpu_torch.ops.fused_match import fast_match_blocks_fused
from lz4jpeg_tpu_torch.ops.lz4_fast import (
    TPU_BLOCK_LOG,
    fast_match_blocks,
    pad_blocks_fast,
)
from lz4jpeg_tpu_torch.ops.lz4t_decode import (
    _trim_rows,
    build_copy_program_fast,
    depth_to_steps,
    device_depth_cap,
    resolve_on_device,
)
from lz4jpeg_tpu_torch.ops.lz4_parse import parity_parse
from lz4jpeg_tpu_torch.parallel.mesh import (
    CodecMesh,
    gather_shards,
    pad_to_devices,
    shard_leading_axis,
)
from lz4jpeg_tpu_torch.parallel.multihost import (
    ordered_allgather_payloads,
    process_count,
    process_index,
)

# The fused matcher's arguments on a CUDA mesh: the JAX package's TPU route
# (``fast_match_blocks_pallas`` defaults, ``ops/pallas_match.py:217-225``).
FUSED_STRIDE = 1
FUSED_LCP_WORDS = 2


def _stack_fields(is_match, emit_len, emit_dist) -> torch.Tensor:
    return torch.stack([is_match.to(torch.int32), emit_len, emit_dist], dim=1)


def _split_fields(gathered: np.ndarray):
    return gathered[:, 0].astype(bool), gathered[:, 1], gathered[:, 2]


def sharded_block_parse(
    blocks: np.ndarray, mesh: CodecMesh, max_match: int = 1024
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(B, P) padded int32 blocks → (is_match, emit_len, emit_dist).

    ``B`` must be a multiple of the mesh size (see ``pad_to_devices``).
    Each device parses its block shard independently; the results gather
    in the original block order."""
    (shards,) = shard_leading_axis([np.asarray(blocks, np.int32)], mesh)
    parts = []
    for shard in shards:
        parts.append(_stack_fields(*parity_parse(shard, max_match=max_match)))
    return _split_fields(gather_shards(parts))


def sharded_fast_parse(
    blocks: np.ndarray, lengths: np.ndarray, mesh: CodecMesh
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fast-mode (LZ4T) match finding with the block axis sharded: (B, P)
    blocks of byte values and (B,) lengths → byte-level ``(is_match,
    emit_len, emit_dist)``.  The row count must be a multiple of the mesh
    size.  A CUDA mesh launches K2 and K10 once per shard."""
    use_fused = mesh.device_type == "cuda"
    block_shards, length_shards = shard_leading_axis(
        [np.asarray(blocks).astype(np.uint8), np.asarray(lengths, np.int32)],
        mesh,
    )
    parts = []
    for shard, shard_lengths in zip(block_shards, length_shards):
        if use_fused:
            fields = fast_match_blocks_fused(
                shard, shard_lengths, stride=FUSED_STRIDE,
                lcp_words=FUSED_LCP_WORDS,
            )
        else:
            fields = fast_match_blocks(shard, shard_lengths)
        parts.append(_stack_fields(*fields))
    return _split_fields(gather_shards(parts))


def sharded_compressed_sizes(
    emit_len: np.ndarray, is_match: np.ndarray, mesh: CodecMesh
) -> np.ndarray:
    """The number of match sequences, summed per shard and then over the
    mesh (the psum the multi-host frame writer uses to pre-size its output
    before the payload gather).  ``emit_len`` is unused, as in JAX."""
    (shards,) = shard_leading_axis([np.asarray(is_match)], mesh)
    local = [s.to(torch.int32).sum(dtype=torch.int32) for s in shards]
    return np.asarray(sum(int(x) for x in local), np.int32)


def sharded_resolve_blocks(
    lit: np.ndarray, src: np.ndarray, mesh: CodecMesh, steps: int = None
) -> np.ndarray:
    """Device-parallel LZ4T match resolution with the block axis sharded:
    (B, P) uint8 literals and int32 sources → (B, P) uint8 bytes.

    Every device resolves its rows of the copy program, and the blocks
    gather in the original order.  Legal because LZ4T match chains never
    cross a block — the capability match for the reference's
    thread-per-block decode (``Algorithms/parallel/LZ4/LZ4.c:1105-1222``),
    whose create/wait pair had serialized it.  The row count must be a
    multiple of the mesh size (``pad_to_devices``; all-literal padding rows
    resolve to themselves).  ``steps`` doublings root the program (default:
    enough for any chain of P); on a CUDA mesh the final gather is K3."""
    if steps is None:
        steps = (src.shape[1] - 1).bit_length()
    lit_shards, src_shards = shard_leading_axis(
        [np.asarray(lit, np.uint8), np.asarray(src, np.int32)], mesh
    )
    parts = [resolve_on_device(l, s, steps)
             for l, s in zip(lit_shards, src_shards)]
    return gather_shards(parts)


def sharded_fast_decode(frame: bytes, mesh: CodecMesh) -> bytes:
    """Full LZ4T decode with match resolution sharded over ``mesh``.

    The host does the linear framing/parse pass (prefix-summable thanks to
    the up-front size table), the mesh resolves all match chains in
    parallel, and the frame checksum is verified after the gather."""
    lit, src, raw_sizes, _, max_depth = build_copy_program_fast(
        frame, depth_cap=device_depth_cap(mesh.devices[0])
    )
    if lit.shape[0] == 0:
        return b""
    lit_p, n_blocks = pad_to_devices(lit, mesh.size, pad_value=0)
    src_p, _ = pad_to_devices(src, mesh.size, pad_value=-1)
    out = sharded_resolve_blocks(
        lit_p, src_p, mesh, steps=depth_to_steps(max_depth)
    )[:n_blocks]
    decoded = _trim_rows(out, raw_sizes)
    verify_frame_checksum(frame, decoded)
    return decoded


def multihost_fast_decode(frame: bytes, device="cuda") -> bytes:
    """Cross-process LZ4T decode: the frame's up-front size table gives
    every process the full framing for free, each process resolves its
    strided stripe of blocks on ``device``, and the decoded blocks gather
    in the original order.

    The multi-host realization of the reference's block-parallel decode
    intent (``Algorithms/parallel/LZ4/LZ4.c:1105-1222`` — thread per block,
    accidentally serialized by its create/wait pair).  Byte-equal to a local
    decode on every process; verified against the frame's checksum.  Without
    a process group it decodes locally."""
    device = torch.device(device)
    pid, nproc = process_index(), process_count()
    lit, src, raw_sizes, _, max_depth = build_copy_program_fast(
        frame, depth_cap=device_depth_cap(device)
    )
    num_blocks = lit.shape[0]
    if num_blocks == 0:
        return b""
    mine = list(range(pid, num_blocks, nproc))
    local_payloads: List[bytes] = []
    if mine:
        out = resolve_on_device(
            torch.from_numpy(lit[mine]).to(device),
            torch.from_numpy(src[mine]).to(device),
            depth_to_steps(max_depth),
        ).cpu().numpy()
        local_payloads = [
            out[row, : int(raw_sizes[bi])].tobytes()
            for row, bi in enumerate(mine)
        ]
    blocks = ordered_allgather_payloads(local_payloads, mine, num_blocks)
    decoded = b"".join(blocks)
    verify_frame_checksum(frame, decoded)
    return decoded


def multihost_fast_encode(data: bytes, device="cuda") -> bytes:
    """Cross-process fast-mode LZ4 encode: every process encodes its
    strided slice of the 16 KiB blocks with the fast codec's device path
    (``LZ4Codec.block_payloads`` on ``device``), the payloads gather in the
    original block order, and every process returns the identical LZ4T
    frame.

    The multi-host version of the reference's pre-sized ordered gather
    (``parallel_add_block_to_frame``, Algorithms/parallel/LZ4/LZ4.c:495-514)
    — block independence makes the frame equal to a single-process
    ``LZ4Codec(LZ4Config(mode="fast"), device).encode(data,
    engine="device")``.  Without a process group it encodes locally."""
    codec = LZ4Codec(LZ4Config(mode="fast"), device)
    pid, nproc = process_index(), process_count()
    padded, lengths = pad_blocks_fast(data, TPU_BLOCK_LOG)
    num_blocks = padded.shape[0]
    mine = list(range(pid, num_blocks, nproc))
    data_u8 = padded.astype(np.uint8)
    local_payloads: List[bytes] = []
    if mine:
        local_payloads = codec.block_payloads(data_u8[mine], lengths[mine])
    payloads = ordered_allgather_payloads(local_payloads, mine, num_blocks)
    raws = [
        data_u8[bi, : int(lengths[bi])].tobytes() for bi in range(num_blocks)
    ]
    return assemble_frame(payloads, raws, len(data), TPU_BLOCK_LOG)
