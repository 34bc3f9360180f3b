"""numpy and Python oracles of the reference codec semantics (copies of
``lz4jpeg_tpu/oracle``)."""

from lz4jpeg_tpu_torch.oracle.jpeg_oracle import (  # noqa: F401
    jpeg_forward_oracle,
    jpeg_roundtrip_oracle,
)
from lz4jpeg_tpu_torch.oracle.lz4_oracle import (  # noqa: F401
    block_encode_oracle,
    find_longest_match_oracle,
    lz4_decode_oracle,
    lz4_decode_to_text,
    lz4_encode_oracle,
)
