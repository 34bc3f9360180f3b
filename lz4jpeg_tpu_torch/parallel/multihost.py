"""Cross-process start-up and the ordered payload gather, on
``torch.distributed``.

Port of ``lz4jpeg_tpu/parallel/multihost.py``.  The reference's world is
one process with shared memory; its "gather" is ``frame_blocks[index] =
*block`` under a critical section (``Algorithms/parallel/LZ4/LZ4.c:495-514``).
Across processes:

* ``initialize`` starts a process group (NCCL for ``device="cuda"``, gloo
  for ``"cpu"``; the backend follows the device the caller names and is
  never swapped), or with no arguments starts nothing and reports the world
  size, 1 without a group;
* ``ordered_allgather_payloads`` gathers variable-length byte payloads
  (compressed blocks, bitstreams, image bands) from every process in their
  original order: the global maximum width by all-reduce MAX, rows padded to
  it and to the largest per-process count, data and ``(index, length)``
  meta all-gathered, reassembly by index.

Without a group, rank and world size are 0 and 1, and every function here
runs locally with no collective, as JAX's do in one process.  With a group
the collectives run at any world size, 1 included (the same results, one
process).  Collective tensors live on the group's device: the current card
under NCCL, the CPU under gloo.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank, 0 without a group."""
    return dist.get_rank() if _group() else 0


def process_count() -> int:
    """The world size, 1 without a group."""
    return dist.get_world_size() if _group() else 1


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> int:
    """Start the process group; returns the world size.

    With no arguments it starts nothing and returns the world size of the
    group that exists, 1 if none does.  Otherwise ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id`` go to
    ``init_process_group`` with ``init_method="tcp://host:port"``: on NCCL
    for a CUDA ``device`` (after ``torch.cuda.set_device``: the card the
    device names, else card ``process_id % device_count``), on gloo for
    ``"cpu"``.  A CUDA device without a card raises."""
    if coordinator_address is None and num_processes is None:
        return process_count()
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize needs coordinator_address, num_processes and process_id"
        )
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL was requested but CUDA is not available")
        index = device.index
        if index is None:
            index = process_id % torch.cuda.device_count()
        torch.cuda.set_device(index)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device}")
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )
    return dist.get_world_size()


def _collective_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_allgather(x: np.ndarray) -> np.ndarray:
    """Every process's same-shaped ``x`` stacked along a new leading axis
    in rank order (JAX's ``multihost_utils.process_allgather``)."""
    x = np.ascontiguousarray(x)
    if not _group():
        return x[None]
    t = torch.from_numpy(x).to(_collective_device())
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def process_allreduce(x: np.ndarray, op=dist.ReduceOp.SUM) -> np.ndarray:
    """``x`` reduced over every process with ``op`` (all-reduce)."""
    x = np.ascontiguousarray(x)
    if not _group():
        return x
    t = torch.from_numpy(x.copy()).to(_collective_device())
    dist.all_reduce(t, op=op)
    return t.cpu().numpy()


def ordered_allgather_payloads(
    local_payloads: List[bytes],
    local_indices: List[int],
    total_count: int,
) -> List[bytes]:
    """Gather per-block byte payloads from all processes, ordered by their
    original block index.

    Each process holds the payloads of the blocks it encoded (its shard of
    the block axis) plus their global indices.  Payloads are padded to the
    global max length, all-gathered together with (index, length) side
    channels, and reassembled in index order — the collective version of
    the reference's pre-sized ordered gather array.  Raises ``ValueError``
    when a block is missing after the gather."""
    # Payload width must be identical on every process for the all-gather;
    # take the global maximum first.
    max_len = int(process_allreduce(
        np.asarray([max((len(p) for p in local_payloads), default=0)], np.int64),
        dist.ReduceOp.MAX,
    )[0])
    local_n = len(local_payloads)
    padded = np.zeros((local_n, max(max_len, 1)), np.uint8)
    meta = np.zeros((local_n, 2), np.int64)  # (global index, length)
    for i, (payload, gi) in enumerate(zip(local_payloads, local_indices)):
        padded[i, : len(payload)] = np.frombuffer(payload, np.uint8)
        meta[i] = (gi, len(payload))

    if not _group():
        gathered_data, gathered_meta = padded, meta
    else:
        # Ragged per-process counts: pad to the largest count first, with
        # meta (-1, -1) on the padding rows.
        max_n = int(process_allgather(np.asarray([local_n], np.int64)).max())
        pad_rows = max_n - local_n
        if pad_rows:
            padded = np.pad(padded, ((0, pad_rows), (0, 0)))
            meta = np.pad(meta, ((0, pad_rows), (0, 0)), constant_values=-1)
        gathered_data = process_allgather(padded).reshape(-1, padded.shape[1])
        gathered_meta = process_allgather(meta).reshape(-1, 2)

    out: List[Optional[bytes]] = [None] * total_count
    for row, (gi, length) in zip(gathered_data, gathered_meta):
        if gi < 0:
            continue  # padding row
        out[int(gi)] = bytes(row[: int(length)])
    missing = [i for i, p in enumerate(out) if p is None]
    if missing:
        raise ValueError(f"blocks missing after gather: {missing[:5]}")
    return out  # type: ignore[return-value]
