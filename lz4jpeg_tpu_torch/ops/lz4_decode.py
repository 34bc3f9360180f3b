"""Parity-frame LZ4 decode on a device: vectorized literal placement +
log-depth match copy.

Port of ``lz4jpeg_tpu/ops/lz4_decode.py``.  The reference decodes
serially: literals appended, then each match byte copied one at a time
against the global output buffer (``interpret_sequence``, LZ4.c:937-982) —
an inherently sequential chain when matches overlap (offset < length).
Here the reconstruction becomes data-parallel passes:

1. host framing scan (cheap, linear) produces a *copy program*: for every
   output position either its literal byte or the index it copies from —
   exactly the reference's global-buffer semantics;
2. match chains resolve by **pointer doubling** on the device:
   ``root ← root[root]`` until every position roots at a literal —
   ⌈log₂ n⌉ + 1 gathers instead of a byte-serial walk;
3. one gather of the literal bytes through the roots.

Chains may legally reach across block boundaries (decoder semantics are
global, SURVEY.md §2.1.5), so the doubling runs over the whole output
vector, never per block.  Indices are int64 (torch's index dtype); the JAX
package's int32 holds every position of a parity frame (n ≤ 255 blocks).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from lz4jpeg_tpu_torch.formats.lz4_frame import Block, unpack_frame


def build_copy_program(blocks: List[Block]) -> Tuple[np.ndarray, np.ndarray]:
    """Blocks → (lit_val u8[N], src i64[N]) with src == -1 at literals."""
    total = sum(
        len(s.literals) + (s.match_length if s.match_offset else 0)
        for b in blocks
        for s in b.sequences
    )
    lit_val = np.zeros(total, np.uint8)
    src = np.full(total, -1, np.int64)
    pos = 0
    for block in blocks:
        for seq in block.sequences:
            n_lit = len(seq.literals)
            lit_val[pos : pos + n_lit] = np.frombuffer(seq.literals, np.uint8)
            pos += n_lit
            if seq.match_offset:
                ml = seq.match_length
                idx = np.arange(pos, pos + ml)
                src[pos : pos + ml] = idx - seq.match_offset
                if seq.match_offset > pos:
                    raise ValueError("match offset reaches before stream start")
                pos += ml
    return lit_val, src


def resolve_copies(
    lit_val: torch.Tensor, src: torch.Tensor, steps: int
) -> torch.Tensor:
    """Pointer-double ``src`` (int64, -1 at literals) to its literal roots
    in ``steps`` rounds, then gather the bytes of ``lit_val``."""
    idx = torch.arange(src.shape[0], dtype=torch.int64, device=src.device)
    # Literals root at themselves — the doubling fixpoint.
    root = torch.where(src < 0, idx, src)
    for _ in range(steps):
        root = root[root]
    return lit_val[root]


def doubling_steps(n: int) -> int:
    """Rounds of ``resolve_copies`` that root every chain of an n-byte
    output (a chain is at most n - 1 links long): ⌈log₂ n⌉ + 1, as the JAX
    decoder takes."""
    return (n - 1).bit_length() + 1


def decode_frame_device(compressed: bytes, device) -> bytes:
    """Full parity-frame decode: host framing, match resolution on
    ``device``."""
    lit_val, src = build_copy_program(unpack_frame(compressed))
    n = len(lit_val)
    if n == 0:
        return b""
    device = torch.device(device)
    out = resolve_copies(
        torch.from_numpy(lit_val).to(device),
        torch.from_numpy(src).to(device),
        doubling_steps(n),
    )
    return out.cpu().numpy().tobytes()
