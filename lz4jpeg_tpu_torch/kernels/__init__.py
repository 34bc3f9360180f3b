"""kernels of lz4jpeg_tpu_torch."""
