"""Color transforms and chroma subsampling as torch ops.

Port of ``lz4jpeg_tpu/ops/color.py`` with the reference's semantics:

* ``rgb_to_ycbcr``: Y truncated on uint8 assignment (JPEG.c:127), Cr/Cb
  truncated via ``(int)`` then clamped (JPEG.c:157, :180, :132-139);
* ``chroma_subsample_422``: horizontal 4:2:2 keeping odd columns
  (JPEG.c:327-333);
* ``ycbcr_planes_to_rgb`` and ``ycbcr_to_rgb_mcus`` (which first merges
  MCU tiles into planes, ``merge_mcus``): per-term ``(int)`` truncation with
  the 1.402 / 0.344136 / 0.714136 / 1.772 coefficients (JPEG.c:598-604).

Every function takes leading batch dimensions: a plane is ``(..., H, W)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _snap_trunc(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Truncate toward zero, snapping values within ``eps`` of an integer.

    All color coefficients have ≤3 decimals, so true values lie on a 1/1000
    grid: a non-integer true value is ≥1e-3 from any integer, which makes
    ``eps=1e-4`` snapping exact for any float32 association or FMA
    contraction of the sum.
    """
    nearest = torch.round(x)
    return torch.trunc(torch.where((x - nearest).abs() <= eps, nearest, x))


def rgb_to_ycbcr(rgb: torch.Tensor, dtype=torch.float32):
    """(..., H, W, 3) uint8 → (Y, Cr, Cb) (..., H, W) uint8 planes, computed
    in ``dtype`` (float64 for the exact path)."""
    r = rgb[..., 0].to(dtype)
    g = rgb[..., 1].to(dtype)
    b = rgb[..., 2].to(dtype)
    y = _snap_trunc(0.299 * r + 0.587 * g + 0.114 * b)
    cr = torch.clamp(_snap_trunc(0.439 * r - 0.368 * g - 0.071 * b + 128), 0, 255)
    cb = torch.clamp(_snap_trunc(-0.148 * r - 0.291 * g + 0.439 * b + 128), 0, 255)
    return y.to(torch.uint8), cr.to(torch.uint8), cb.to(torch.uint8)


def chroma_subsample_422(plane: torch.Tensor) -> torch.Tensor:
    """Keep odd columns: (..., H, W) → (..., H, W//2)."""
    w = plane.shape[-1]
    return plane[..., 1::2][..., : w // 2]


def split_mcus(y: torch.Tensor, cr_sub: torch.Tensor, cb_sub: torch.Tensor):
    """Planes → MCU tiles, frames outermost, then block-row-major.

    Returns ``(lum (N,8,8), r (N,8,4), b (N,8,4))`` uint8 with N = frames ·
    bpc · bpr.  Ragged edges are zero-padded in the PLANE domain, like
    ``divide_image`` (JPEG.c:512-523): a padded pixel has Y = Cr = Cb = 0.
    """
    h, w = y.shape[-2:]
    bpc, bpr = -(-h // 8), -(-w // 8)

    def tile(plane, th, tw):
        ph, pw = bpc * th - plane.shape[-2], bpr * tw - plane.shape[-1]
        if ph or pw:
            plane = F.pad(plane, (0, pw, 0, ph))
        lead = plane.shape[:-2]
        return (
            plane.reshape(*lead, bpc, th, bpr, tw)
            .transpose(-3, -2)
            .reshape(-1, th, tw)
        )

    return tile(y, 8, 8), tile(cr_sub, 8, 4), tile(cb_sub, 8, 4)


def merge_mcus(tiles: torch.Tensor, bpc: int, bpr: int) -> torch.Tensor:
    """(..., bpc·bpr, th, tw) tiles → (..., bpc·th, bpr·tw) planes (the
    inverse of ``split_mcus``)."""
    *lead, _, th, tw = tiles.shape
    return (
        tiles.reshape(*lead, bpc, bpr, th, tw)
        .transpose(-3, -2)
        .reshape(*lead, bpc * th, bpr * tw)
    )


def ycbcr_to_rgb_mcus(
    lum: torch.Tensor,
    r: torch.Tensor,
    b: torch.Tensor,
    bpc: int,
    bpr: int,
    height: int,
    width: int,
    dtype=torch.float32,
) -> torch.Tensor:
    """MCU tiles (..., N, 8, 8) luma and (..., N, 8, 4) chroma → (...,
    height, width, 3) uint8 RGB (``assemble_image``).  Chroma columns are
    duplicated (4:2:2 upsampling: each sample serves columns 2k and 2k+1,
    JPEG.c:590-595), then the planes merge as in ``ycbcr_planes_to_rgb``."""
    return ycbcr_planes_to_rgb(
        merge_mcus(lum, bpc, bpr),
        torch.repeat_interleave(merge_mcus(r, bpc, bpr), 2, dim=-1),
        torch.repeat_interleave(merge_mcus(b, bpc, bpr), 2, dim=-1),
        height, width, dtype,
    )


def ycbcr_planes_to_rgb(
    y_plane: torch.Tensor,
    cr_plane: torch.Tensor,
    cb_plane: torch.Tensor,
    height: int,
    width: int,
    dtype=torch.float32,
) -> torch.Tensor:
    """Plane-view YCbCr → (..., height, width, 3) uint8 RGB
    (``assemble_image``, JPEG.c:598-604): per-term ``(int)`` truncation,
    each channel clamped.  The chroma planes come full width: the decode
    folds the 4:2:2 upsample into the inverse basis (``ops/fused.py``), the
    JAX package's ``chroma_upsampled=True``.  The products run in ``dtype``."""
    y = y_plane.to(torch.int32)
    cr = cr_plane.to(dtype)
    cb = cb_plane.to(dtype)

    cr_term = torch.trunc(1.402 * (cr - 128)).to(torch.int32)
    g_cb = torch.trunc(0.344136 * (cb - 128)).to(torch.int32)
    g_cr = torch.trunc(0.714136 * (cr - 128)).to(torch.int32)
    cb_term = torch.trunc(1.772 * (cb - 128)).to(torch.int32)

    rr = torch.clamp(y + cr_term, 0, 255)
    gg = torch.clamp(y - g_cb - g_cr, 0, 255)
    bb = torch.clamp(y + cb_term, 0, 255)
    rgb = torch.stack([rr, gg, bb], dim=-1).to(torch.uint8)
    return rgb[..., :height, :width, :]
