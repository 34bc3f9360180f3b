"""numpy oracles of the reference codec semantics (copies of
``lz4jpeg_tpu/oracle``)."""

from lz4jpeg_tpu_torch.oracle.jpeg_oracle import (  # noqa: F401
    jpeg_forward_oracle,
    jpeg_roundtrip_oracle,
)
