"""Device-mesh data parallelism for the codec pipelines.

Port of ``lz4jpeg_tpu/parallel/``.  The reference's entire parallel
repertoire is one Win32 thread per block/MCU with lock-guarded shared
structs and an index-addressed ordered gather
(``Algorithms/parallel/LZ4/LZ4.c:495-514, :742``;
``Algorithms/parallel/JPEG/JPEG.c:1297-1304``).  Here:

* a 1-D mesh of devices over the data axis, driven by one process
  (``mesh.py``);
* the block/MCU batch axis split into one contiguous shard per mesh device,
  each running the kernels of the single-device path (``jpeg.py``,
  ``lz4.py``);
* the ordered gather is the in-order concatenation of the shards, and
  across processes ``torch.distributed`` collectives (``multihost.py``),
  in place of the reference's ``frame_blocks[index] = *block`` under a
  critical section;
* shared tables (quant tables, codebooks) are the same on every shard.
"""

from lz4jpeg_tpu_torch.parallel.mesh import codec_mesh, pad_to_devices  # noqa: F401
from lz4jpeg_tpu_torch.parallel.jpeg import (  # noqa: F401
    ShardedJPEGForward,
    ShardedSparseJPEG,
)
from lz4jpeg_tpu_torch.parallel.lz4 import sharded_block_parse  # noqa: F401
