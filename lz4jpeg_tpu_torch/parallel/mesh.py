"""The device mesh and the batch-axis helpers of the sharded paths.

Port of ``lz4jpeg_tpu/parallel/mesh.py``.  JAX's ``Mesh`` runs under one
controller: one process drives every local device.  ``CodecMesh`` keeps
that model: an ordered tuple of ``torch.device``s over the data axis.  A
sharded function splits the leading axis into ``mesh.size`` contiguous
shards, launches every shard on its device before it copies anything back
(so that distinct cards overlap), and concatenates the shards in order:
shard i lands at rows ``[i·s, (i+1)·s)``, where JAX's ``all_gather(...,
tiled=True)`` puts it.  A mesh may repeat a device: several shards then
share one card or the CPU, and still run one launch each.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from lz4jpeg_tpu_torch.config import MeshConfig


@dataclasses.dataclass(frozen=True)
class CodecMesh:
    """A 1-D mesh: the devices of the data axis, in shard order."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh spans one device type, not {devices}")
        if devices[0].type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {devices[0]}")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type


def codec_mesh(config: MeshConfig = MeshConfig(), device="cuda") -> CodecMesh:
    """A mesh over the data axis.  ``"cuda"``: the visible cards ``cuda:0 …
    cuda:n-1``, all of them by default; raises without a card, and when
    ``config.num_devices`` exceeds the cards.  ``"cpu"``: ``num_devices``
    shards (default 1) on the one CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh was requested but CUDA is not available")
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        n = config.num_devices or len(visible)
        if n > len(visible):
            raise ValueError(f"requested {n} devices, only {len(visible)} visible")
        return CodecMesh(tuple(visible[:n]))
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return CodecMesh((device,) * (config.num_devices or 1))


def pad_to_devices(
    batch: np.ndarray, n_devices: int, pad_value=0
) -> Tuple[np.ndarray, int]:
    """Right-pad the leading (block/MCU) axis to a multiple of the mesh size.

    Returns ``(padded, original_length)``.  Padding rows are masked out after
    the ordered gather — the moral equivalent of the reference's pre-sized
    ``frame_blocks`` array indexed by block id (LZ4.c:708).  A copy of the
    JAX package's."""
    n = batch.shape[0]
    padded_n = -(-n // n_devices) * n_devices
    if padded_n == n:
        return batch, n
    pad_width = [(0, padded_n - n)] + [(0, 0)] * (batch.ndim - 1)
    return np.pad(batch, pad_width, constant_values=pad_value), n


def shard_leading_axis(
    tensors: Sequence, mesh: CodecMesh
) -> List[List[torch.Tensor]]:
    """Each tensor (or numpy array) split into ``mesh.size`` contiguous
    shards of its leading axis, shard i on ``mesh.devices[i]``.  The leading
    axis must be a multiple of the mesh size (``pad_to_devices``)."""
    out = []
    for t in tensors:
        t = torch.as_tensor(t)
        if t.shape[0] % mesh.size:
            raise ValueError(
                f"leading axis {t.shape[0]} is no multiple of the mesh size "
                f"{mesh.size}; pad it with pad_to_devices"
            )
        s = t.shape[0] // mesh.size
        out.append([t[i * s : (i + 1) * s].to(dev).contiguous()
                    for i, dev in enumerate(mesh.devices)])
    return out


def gather_shards(shards: Sequence[torch.Tensor]) -> np.ndarray:
    """Per-shard results → one host array, shard i at its rows (the ordered
    all_gather): each shard is copied once, straight into its rows.  Called
    once every shard has been launched."""
    rows = sum(s.shape[0] for s in shards)
    out = torch.empty((rows, *shards[0].shape[1:]), dtype=shards[0].dtype)
    at = 0
    for s in shards:
        out[at : at + s.shape[0]].copy_(s)
        at += s.shape[0]
    return out.numpy()
