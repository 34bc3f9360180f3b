"""Stage visualization images (JPEG.c:219-300).

A copy of ``lz4jpeg_tpu/utils/visualize.py`` (framework-free;
``tests/test_torch_lz4_parity.py`` holds its outputs equal to the
original's).

The reference writes three debug PNGs after the color transform: the
luminance plane as grayscale and each chroma plane false-colored through
the inverse transform with the other chroma fixed at 128.  These return
the RGB arrays; pass them to ``utils.io.write_png`` to get the files.

The chroma renderers use the reference's *visualization* coefficients
(1.402 / 0.344 / 0.714 / 1.772 — note 0.344/0.714, not the reconstruction
path's 0.344136/0.714136) and C float→uint8 truncation.
"""

from __future__ import annotations

import numpy as np


def _clamp_u8(x: np.ndarray) -> np.ndarray:
    # The C assigns the double expression straight into uint8_t members —
    # truncation mod 256 after the implicit conversion; values here stay in
    # [-51, 306] so a clip matches the visible behavior for all real inputs
    # while avoiding the UB wraparound.
    return np.clip(np.trunc(x), 0, 255).astype(np.uint8)


def luminance_image(y_plane: np.ndarray) -> np.ndarray:
    """Grayscale rendering (``create_luminance_image``, JPEG.c:219-240)."""
    return np.repeat(y_plane[..., None], 3, axis=2)


def r_chrominance_image(cr_plane: np.ndarray) -> np.ndarray:
    """(``create_rChrominance_image``, JPEG.c:254-276)."""
    v = cr_plane.astype(np.float64)
    r = 128 + 1.402 * (v - 128)
    g = 128 - 0.714 * (v - 128)
    b = np.full_like(v, 128.0)
    return np.stack([_clamp_u8(r), _clamp_u8(g), _clamp_u8(b)], axis=-1)


def b_chrominance_image(cb_plane: np.ndarray) -> np.ndarray:
    """(``create_bChrominance_image``, JPEG.c:278-300)."""
    v = cb_plane.astype(np.float64)
    r = np.full_like(v, 128.0)
    g = 128 - 0.344 * (v - 128)
    b = 128 + 1.772 * (v - 128)
    return np.stack([_clamp_u8(r), _clamp_u8(g), _clamp_u8(b)], axis=-1)


def reconstruct_chrominance_matrix(
    tiles: np.ndarray, bpc: int, bpr: int, height: int, width: int
) -> np.ndarray:
    """Full-width chroma plane from (N, 8, 4) subsampled MCU tiles.

    The reference's disabled debug path (``reconstruct_chrominance_matrix``,
    JPEG.c:640-691): each subsampled chroma sample fills its two local
    columns 2k and 2k+1; positions whose *pair* would cross the right edge
    stay zero (the ``global_col + 1 >= width`` break), as do rows past the
    bottom edge.  Vectorized: merge tiles → duplicate columns → mask the
    ragged edge.
    """
    n, th, tw = tiles.shape
    plane = (
        tiles.reshape(bpc, bpr, th, tw)
        .transpose(0, 2, 1, 3)
        .reshape(bpc * th, bpr * tw)
    )
    full = np.repeat(plane, 2, axis=1)[:height, : 2 * bpr * tw]
    out = np.zeros((height, width), np.uint8)
    # Only sample pairs fully inside the image are written (the C breaks
    # when global_col + 1 >= width, leaving a zero column at odd widths).
    usable = min(full.shape[1], width - (width % 2))
    out[:, :usable] = full[:, :usable]
    return out
