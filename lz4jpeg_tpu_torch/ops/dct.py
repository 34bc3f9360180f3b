"""Batched 2-D DCT-II / IDCT as torch products.

Port of ``lz4jpeg_tpu/ops/dct.py``.  The reference evaluates each
coefficient with a quadruple loop and ``cos()`` in double
(``discrete_cosine_transform``, JPEG.c:451-494); here the orthonormal basis
is built once in float64 and the batch is one einsum,

    C = (α_h α_wᵀ) ⊙ (A_h · (X − 128) · A_wᵀ).

The staged exact path runs it in float64 (real float64 on every device; a
CUDA card runs it through cuBLAS's double-precision product), the fast
path's staged tile inverse in float32 with TF32 off.  The JAX package has no
kernel here, so neither has the port.
"""

from __future__ import annotations

import numpy as np
import torch


def dct_basis(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Returns ``(A, alpha)``: ``A[u, x] = cos(pi (2x+1) u / 2n)`` and the
    orthonormal scale ``alpha[u]`` (sqrt(1/n) for u=0, else sqrt(2/n))."""
    u = np.arange(n, dtype=np.float64)[:, None]
    x = np.arange(n, dtype=np.float64)[None, :]
    basis = np.cos(np.pi * (2 * x + 1) * u / (2.0 * n))
    alpha = np.full(n, np.sqrt(2.0 / n))
    alpha[0] = np.sqrt(1.0 / n)
    return basis, alpha


def _on(a: np.ndarray, like: torch.Tensor, dtype) -> torch.Tensor:
    return torch.from_numpy(a).to(device=like.device, dtype=dtype)


def dct2_batched(values: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, H, W) uint8 pixel tiles → (N, H, W) DCT coefficients in ``dtype``.

    Level-shifts by −128 first (JPEG.c:465-468), then applies the separable
    orthonormal transform."""
    _, h, w = values.shape
    ah, alpha_h = dct_basis(h)
    aw, alpha_w = dct_basis(w)
    x = values.to(dtype) - 128.0
    coeff = torch.einsum("ux,nxy,vy->nuv", _on(ah, x, dtype), x,
                         _on(aw, x, dtype))
    return coeff * _on(np.outer(alpha_h, alpha_w), x, dtype)


def idct2_batched(coefficients: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, H, W) coefficients → (N, H, W) uint8 pixels.

    Applies the transposed basis, shifts +128, rounds half away from zero
    (C ``round()``; ``torch.round`` rounds half to even) and clamps to
    [0, 255] (JPEG.c:439-445)."""
    _, h, w = coefficients.shape
    ah, alpha_h = dct_basis(h)
    aw, alpha_w = dct_basis(w)
    c = coefficients.to(dtype)
    c = c * _on(np.outer(alpha_h, alpha_w), c, dtype)
    x = torch.einsum("ux,nuv,vy->nxy", _on(ah, c, dtype), c, _on(aw, c, dtype))
    shifted = x + 128.0
    rounded = torch.sign(shifted) * torch.floor(shifted.abs() + 0.5)
    return torch.clamp(rounded, 0, 255).to(torch.uint8)
