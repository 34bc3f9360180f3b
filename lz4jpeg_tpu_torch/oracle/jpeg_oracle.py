"""Executable specification of the reference JPEG-style pipeline.

A copy of ``lz4jpeg_tpu/oracle/jpeg_oracle.py`` (pure numpy, so the port
carries a ground truth onto machines without JAX; ``tests/test_torch_exact.py``
holds its outputs equal to the original's): a faithful float64 transcription
of the reference's ``Algorithms/sequential/JPEG/JPEG.c``, the ground truth
the batched kernels in ``ops/`` are verified against, coefficient-exact.

Reference semantics reproduced here (citations into the reference file):

* color transform with C truncation: ``Y = 0.299R+0.587G+0.114B`` assigned to
  ``uint8_t`` (truncates, :127); ``Cr/Cb`` truncated via ``(int)`` then
  clamped to [0,255] (:157, :180, :132-139);
* 4:2:2 horizontal subsampling keeping the *odd* columns x=1,3,5,…
  (``chroma_subsample`` :327-333) → chroma planes are H×(W//2);
* 8×8 luma MCUs and co-sited 8-row × 4-col chroma blocks, zero-padded at
  ragged edges (``divide_image`` :496-550);
* orthonormal DCT-II in double with level shift −128 first, summing x-major
  then y within each (u,v) (``discrete_cosine_transform`` :451-494) — the
  oracle preserves the exact sequential summation order via ``np.cumsum``;
* quantization = divide by table then truncate toward zero via ``(int)``
  cast — *not* round (``Quantize`` :621-629); 64-entry luminance table
  (:12-20) and 32-entry chrominance table for the 8×4 chroma block (:22-27);
* zigzag generalized to W×H blocks (:693-728) with its literal reverse
  (:729-764);
* RLE as ``[count, value]`` int pairs over the zigzag stream, runs compared
  after ``(int)`` truncation, DC included, no DC prediction (:767-809);
* per-block per-channel Huffman with the reference's exact (unbalanced) heap:
  frequencies in first-seen order with a +1000 symbol offset (:864-885),
  Floyd build-heap (:913-934), and a tree loop whose re-insertion is *not*
  sifted up (``heapify`` at the last index is a no-op, :936-961) — tree
  shapes, hence emitted bitstrings, depend on this quirk;
* inverse chain: inverse RLE (:811-842), reverse zigzag, dequantize
  (:631-638), IDCT with +128 shift, round-half-away-from-zero and clamp
  (:399-448), then YCbCr→RGB with *separately truncated* ``(int)`` terms and
  1.402/0.344136/0.714136/1.772 coefficients (``assemble_image`` :552-619).

The reference only ever runs on power-of-two square noise images
(``Experiment/random_image.c:58``); for those its ``ceil(pixels/64)`` block
count (JPEG.c:1131) equals the grid size.  This oracle processes the full
block grid, which is identical on every input the reference can handle.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

LUMINANCE_QUANTIZATION_TABLE = np.array(
    [
        8, 6, 6, 8, 10, 14, 18, 22,
        6, 6, 7, 9, 12, 20, 22, 20,
        6, 7, 8, 10, 14, 22, 25, 22,
        8, 9, 10, 14, 18, 28, 27, 22,
        10, 12, 14, 18, 22, 35, 33, 26,
        14, 18, 22, 22, 27, 33, 36, 30,
        18, 22, 26, 28, 33, 40, 40, 34,
        22, 26, 28, 30, 36, 34, 35, 33,
    ],
    dtype=np.int64,
)

CHROMINANCE_QUANTIZATION_TABLE = np.array(
    [
        17, 18, 24, 47, 18, 21, 26, 66,
        24, 26, 56, 99, 47, 66, 99, 99,
        66, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    dtype=np.int64,
)


# ---------------------------------------------------------------------------
# Color transform (JPEG.c:114-185)
# ---------------------------------------------------------------------------

def _snap(x: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Snap values within ``eps`` of an integer onto it.

    The color coefficients all have ≤3 decimals, so every *true* transform
    value lies on a 1/1000 grid: a non-integer true value is ≥1e-3 from any
    integer and snapping with eps=1e-4 is provably exact.  At exact-integer
    true values the C's literal double expression may itself land an ulp
    below the integer (e.g. 0.299·R+0.587·G+0.114·B for an exact 110.0) and
    truncate "wrong" — snapping defines the deterministic semantics the TPU
    pipeline uses.
    """
    nearest = np.round(x)
    return np.where(np.abs(x - nearest) <= eps, nearest, x)


def build_ycbcr_planes(
    rgb: np.ndarray, snap_ties: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RGB (H,W,3) uint8 → (Y, Cr, Cb) uint8 planes with exact C truncation.

    ``snap_ties=False`` is the bug-compatible C behavior (truncate the raw
    double expression); ``snap_ties=True`` snaps exact-integer ties first
    (see ``_snap``) — the deterministic semantics of the TPU pipeline.
    """
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    yf = 0.299 * r + 0.587 * g + 0.114 * b
    crf = 0.439 * r - 0.368 * g - 0.071 * b + 128
    cbf = -0.148 * r - 0.291 * g + 0.439 * b + 128
    if snap_ties:
        yf, crf, cbf = _snap(yf), _snap(crf), _snap(cbf)
    y = np.trunc(yf).astype(np.uint8)  # double→uint8 trunc
    cr = np.clip(np.trunc(crf), 0, 255)
    cb = np.clip(np.trunc(cbf), 0, 255)
    return y, cr.astype(np.uint8), cb.astype(np.uint8)


def chroma_subsample(plane: np.ndarray) -> np.ndarray:
    """4:2:2 horizontal, keeping odd columns (JPEG.c:327-333): H×(W//2)."""
    w = plane.shape[1]
    return plane[:, 1::2][:, : w // 2]


# ---------------------------------------------------------------------------
# MCU split / reassembly (JPEG.c:496-550, :552-619)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MCUPlanes:
    """Batched MCU pixel data: (N,64) luma and (N,32) chroma uint8 arrays in
    block_row-major order, mirroring ``PixelGroup`` (JPEG.c:42-55)."""

    lum: np.ndarray
    r: np.ndarray
    b: np.ndarray
    blocks_per_row: int
    blocks_per_col: int
    height: int
    width: int


def divide_image(y: np.ndarray, cr_sub: np.ndarray, cb_sub: np.ndarray) -> MCUPlanes:
    h, w = y.shape
    bpr = (w + 7) // 8
    bpc = (h + 7) // 8
    lum = np.zeros((bpc * bpr, 64), dtype=np.uint8)
    rv = np.zeros((bpc * bpr, 32), dtype=np.uint8)
    bv = np.zeros((bpc * bpr, 32), dtype=np.uint8)
    for row in range(h):
        for col in range(w):
            bi = (row // 8) * bpr + (col // 8)
            lr, lc = row % 8, col % 8
            lum[bi, lr * 8 + lc] = y[row, col]
            if lc % 2 == 0:
                ci = lr * 4 + lc // 2
                # The reference reads plane[row][col/2]; for W<2 the chroma
                # plane is empty and the C read is UB — we define it as 0.
                if col // 2 < cr_sub.shape[1]:
                    rv[bi, ci] = cr_sub[row, col // 2]
                    bv[bi, ci] = cb_sub[row, col // 2]
    return MCUPlanes(lum, rv, bv, bpr, bpc, h, w)


def assemble_image(planes: MCUPlanes) -> np.ndarray:
    """YCbCr MCU batch → RGB image, with separately truncated int terms
    (JPEG.c:598-604)."""
    h, w = planes.height, planes.width
    out = np.zeros((h, w, 3), dtype=np.uint8)
    for br in range(planes.blocks_per_col):
        for bc in range(planes.blocks_per_row):
            bi = br * planes.blocks_per_row + bc
            for lr in range(8):
                for lc in range(8):
                    gr, gc = br * 8 + lr, bc * 8 + lc
                    if gr >= h or gc >= w:
                        continue
                    yv = int(planes.lum[bi, lr * 8 + lc])
                    ci = lr * 4 + lc // 2
                    cb = int(planes.b[bi, ci])
                    cr = int(planes.r[bi, ci])
                    rr = yv + int(1.402 * (cr - 128))
                    gg = yv - int(0.344136 * (cb - 128)) - int(0.714136 * (cr - 128))
                    bb = yv + int(1.772 * (cb - 128))
                    out[gr, gc, 0] = min(max(rr, 0), 255)
                    out[gr, gc, 1] = min(max(gg, 0), 255)
                    out[gr, gc, 2] = min(max(bb, 0), 255)
    return out


# ---------------------------------------------------------------------------
# DCT / IDCT (JPEG.c:451-494, :399-448)
# ---------------------------------------------------------------------------

def _cos_basis(n: int) -> np.ndarray:
    """cos(pi*(2x+1)*u / (2n)) as [u, x]."""
    u = np.arange(n, dtype=np.float64)[:, None]
    x = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(np.pi * (2 * x + 1) * u / (2.0 * n))


def _alpha(n: int) -> np.ndarray:
    a = np.full(n, np.sqrt(2.0 / n))
    a[0] = np.sqrt(1.0 / n)
    return a


def dct2d_oracle(values: np.ndarray, width: int, height: int) -> np.ndarray:
    """DCT-II of one block with the C's exact summation order.

    ``values``: flat uint8 array of length height*width (row-major).
    Returns flat float64 coefficients.  The per-(u,v) accumulation runs
    x-major then y (JPEG.c:477-484); ``np.cumsum`` reproduces sequential
    left-to-right float64 addition exactly.
    """
    corrected = values.astype(np.int64).reshape(height, width) - 128
    cos_u = _cos_basis(height)  # [u, x]
    cos_v = _cos_basis(width)   # [v, y]
    # term[u,v,x,y] = (corrected[x,y] * cos_x) * cos_y, matching the C's
    # two-multiply evaluation order per term (JPEG.c:483).
    t = corrected[None, None, :, :].astype(np.float64) * cos_u[:, None, :, None]
    t = t * cos_v[None, :, None, :]
    sums = np.cumsum(t.reshape(height, width, height * width), axis=-1)[..., -1]
    au = _alpha(height)[:, None]
    av = _alpha(width)[None, :]
    return ((au * av) * sums).reshape(-1)


def idct2d_oracle(coefficients: np.ndarray, width: int, height: int) -> np.ndarray:
    """IDCT-II of one block → uint8 values, C order (JPEG.c:414-445).

    Per-term evaluation: ``alpha_u * alpha_v * coeff * cos_x * cos_y`` is
    multiplied left-to-right; summation runs u-major then v; the result is
    shifted +128, rounded half-away-from-zero and clamped.
    """
    coef = coefficients.astype(np.float64).reshape(height, width)
    cos_u = _cos_basis(height)  # [u, x]
    cos_v = _cos_basis(width)   # [v, y]
    au = _alpha(height)[:, None]
    av = _alpha(width)[None, :]
    scaled = (au * av) * coef  # ((alpha_u * alpha_v) * coeff), per (u,v)
    # term[x,y,u,v] = ((scaled[u,v]) * cos_x[u,x]) * cos_y[v,y]
    t = scaled[None, None, :, :] * np.transpose(cos_u)[:, None, :, None]
    t = t * np.transpose(cos_v)[None, :, None, :]
    sums = np.cumsum(t.reshape(height, width, height * width), axis=-1)[..., -1]
    shifted = sums + 128.0
    rounded = np.sign(shifted) * np.floor(np.abs(shifted) + 0.5)  # C round()
    return np.clip(rounded, 0, 255).astype(np.uint8).reshape(-1)


# ---------------------------------------------------------------------------
# Quantization (JPEG.c:621-638)
# ---------------------------------------------------------------------------

def quantize_oracle(
    coefficients: np.ndarray, table: np.ndarray, snap_ties: bool = False
) -> np.ndarray:
    """Divide then truncate toward zero — not round (JPEG.c:626-627).

    With ``snap_ties=True``, ratios within 1e-9 of an integer are snapped to
    it first.  At such *quantization ties* the true coefficient is an exact
    multiple of the table entry and the C's result is an order/libm-dependent
    ulp artifact (see ``ops/quantize.py``); snapping makes the result
    deterministic and is what the TPU pipeline does.  ``snap_ties=False`` is
    the bug-compatible C behavior.
    """
    ratio = coefficients / table.astype(np.float64)
    if snap_ties:
        nearest = np.round(ratio)
        ratio = np.where(np.abs(ratio - nearest) <= 1e-9, nearest, ratio)
    return np.trunc(ratio)


def dequantize_oracle(coefficients: np.ndarray, table: np.ndarray) -> np.ndarray:
    return coefficients * table.astype(np.float64)


# ---------------------------------------------------------------------------
# Zigzag (JPEG.c:693-764)
# ---------------------------------------------------------------------------

def zigzag_indices(width: int, height: int) -> np.ndarray:
    """Gather permutation of the reference's generalized zigzag: transcribed
    literally from ``zigzag_pattern`` (JPEG.c:693-728).  ``out[k] =
    flat_input[perm[k]]``."""
    perm: List[int] = []
    for s in range(width + height - 1):
        start_row = 0 if s < width else s - width + 1
        end_row = s if s < height else height - 1
        if s % 2 == 0:
            rows = range(end_row, start_row - 1, -1)
        else:
            rows = range(start_row, end_row + 1)
        for row in rows:
            col = s - row
            if 0 <= col < width:
                perm.append(row * width + col)
    return np.array(perm, dtype=np.int64)


def reverse_zigzag_indices(width: int, height: int) -> np.ndarray:
    """Scatter permutation of ``reverse_zigzag_pattern`` (JPEG.c:729-764):
    ``out[sperm[k]] = zigzag_input[k]``.  Transcribed literally — its
    start/end formulas differ from the forward pass but enumerate the same
    cells in the same order for every block shape the reference uses.

    Quirk (found by property testing): the formulas are only complete for
    ``width <= height`` — for wide blocks they enumerate just ``height²``
    cells, so the reference's inverse would drop coefficients.  The
    reference never hits this (its blocks are 8×8 and 4×8, both w ≤ h);
    the transcription preserves the behavior."""
    sperm: List[int] = []
    for s in range(width + height - 1):
        start = 0 if s < height else s - height + 1
        end = s if s < width else height - 1
        if s % 2 == 0:
            rows = range(end, start - 1, -1)
        else:
            rows = range(start, end + 1)
        for row in rows:
            if not (0 <= row < height):
                continue
            col = s - row
            if 0 <= col < width:
                sperm.append(row * width + col)
    return np.array(sperm, dtype=np.int64)


def zigzag_oracle(block: np.ndarray, width: int, height: int) -> np.ndarray:
    return block[zigzag_indices(width, height)]


def reverse_zigzag_oracle(zz: np.ndarray, width: int, height: int) -> np.ndarray:
    out = np.zeros_like(zz)
    out[reverse_zigzag_indices(width, height)] = zz
    return out


# ---------------------------------------------------------------------------
# RLE (JPEG.c:767-842)
# ---------------------------------------------------------------------------

def rle_oracle(values: np.ndarray) -> List[int]:
    """``[count, value]`` int pairs; runs compared after int truncation."""
    if len(values) == 0:
        return []
    out: List[int] = []
    current = values[0]
    count = 1
    for i in range(1, len(values) + 1):
        if i < len(values) and int(values[i]) == int(current):
            count += 1
        else:
            out.append(int(count))
            out.append(int(current))
            if i < len(values):
                current = values[i]
                count = 1
    return out


def inverse_rle_oracle(pairs: List[int], max_size: int) -> np.ndarray:
    """(JPEG.c:811-842): expand, cap at ``max_size``, zero-pad the tail."""
    out = np.zeros(max_size, dtype=np.float64)
    index = 0
    for i in range(0, len(pairs), 2):
        count, value = pairs[i], pairs[i + 1]
        count = min(count, max_size - index)
        for _ in range(count):
            if index < max_size:
                out[index] = float(value)
                index += 1
    return out


# ---------------------------------------------------------------------------
# Huffman (JPEG.c:844-1097)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HuffNode:
    count: int
    value: int  # symbol (input + 1000), or -1 for internal
    left: "HuffNode | None" = None
    right: "HuffNode | None" = None

    def copy(self) -> "HuffNode":
        return HuffNode(self.count, self.value, self.left, self.right)


def _calculate_frequency(symbols: List[int]) -> List[Tuple[int, int]]:
    """First-seen-order (value+1000, count) pairs (JPEG.c:864-885)."""
    order: List[int] = []
    counts: Dict[int, int] = {}
    for s in symbols:
        v = s + 1000
        if v not in counts:
            counts[v] = 0
            order.append(v)
        counts[v] += 1
    return [(v, counts[v]) for v in order]


def _heapify(heap: List[HuffNode], size: int, i: int) -> None:
    smallest = i
    left, right = 2 * i + 1, 2 * i + 2
    if left < size and heap[left].count < heap[smallest].count:
        smallest = left
    if right < size and heap[right].count < heap[smallest].count:
        smallest = right
    if smallest != i:
        heap[i], heap[smallest] = heap[smallest], heap[i]
        _heapify(heap, size, smallest)


def build_huffman_tree_oracle(symbols: List[int]) -> HuffNode:
    """Exact transcription of build_heap + build_huffman_tree
    (JPEG.c:913-961), *including* the missing sift-up on re-insertion —
    tree shapes (and therefore code strings) depend on it."""
    freqs = _calculate_frequency(symbols)
    heap = [HuffNode(c, v) for v, c in freqs]
    size = len(heap)
    for i in range(size // 2 - 1, -1, -1):
        _heapify(heap, size, i)
    while size > 1:
        left = heap[0].copy()
        size -= 1
        heap[0] = heap[size]
        _heapify(heap, size, 0)
        right = heap[0].copy()
        size -= 1
        heap[0] = heap[size]
        _heapify(heap, size, 0)
        node = HuffNode(left.count + right.count, -1, left, right)
        if size < len(heap):
            heap[size] = node
        else:
            heap.append(node)
        size += 1
        _heapify(heap, size, size - 1)  # sift-down at a leaf: no-op (quirk)
    return heap[0]


def assign_codes_oracle(root: HuffNode) -> List[Tuple[int, str]]:
    """DFS left='0' right='1', leaves in DFS order (JPEG.c:963-982).
    A single-leaf tree gets the empty code, exactly like the reference."""
    codes: List[Tuple[int, str]] = []

    def walk(node: HuffNode, prefix: str) -> None:
        if node.value != -1:
            codes.append((node.value, prefix))
            return
        walk(node.left, prefix + "0")
        walk(node.right, prefix + "1")

    walk(root, "")
    return codes


def encode_huffman_oracle(symbols: List[int]) -> Tuple[str, HuffNode, List[Tuple[int, str]]]:
    """RLE ints → ('0'/'1' bitstring, tree, code table) (JPEG.c:993-1007)."""
    root = build_huffman_tree_oracle(symbols)
    codes = assign_codes_oracle(root)
    table = dict(codes)
    bits = "".join(table[s + 1000] for s in symbols)
    return bits, root, codes


def decode_huffman_oracle(root: HuffNode, bits: str) -> List[int]:
    """Tree walk (JPEG.c:1009-1034); returns RLE ints (offset removed)."""
    out: List[int] = []
    node = root
    for ch in bits:
        node = node.left if ch == "0" else node.right
        if node.left is None and node.right is None:
            out.append(node.value - 1000)
            node = root
    return out


# ---------------------------------------------------------------------------
# Full pipelines
# ---------------------------------------------------------------------------

def jpeg_forward_oracle(rgb: np.ndarray, snap_ties: bool = False) -> Dict[str, object]:
    """PNG pixels → quantized+zigzagged coefficients and RLE streams.

    Mirrors JPEG.c main():1103-1220 (encode half).  Returns every
    intermediate needed to verify TPU kernels stage by stage.
    ``snap_ties`` selects deterministic tie handling (see
    ``quantize_oracle``); False is the bug-compatible C behavior.
    """
    y, cr, cb = build_ycbcr_planes(rgb, snap_ties)
    cr_sub = chroma_subsample(cr)
    cb_sub = chroma_subsample(cb)
    planes = divide_image(y, cr_sub, cb_sub)
    n = planes.lum.shape[0]
    lum_q = np.zeros((n, 64))
    r_q = np.zeros((n, 32))
    b_q = np.zeros((n, 32))
    for i in range(n):
        lum_q[i] = quantize_oracle(
            dct2d_oracle(planes.lum[i], 8, 8),
            LUMINANCE_QUANTIZATION_TABLE,
            snap_ties,
        )
        r_q[i] = quantize_oracle(
            dct2d_oracle(planes.r[i], 4, 8),
            CHROMINANCE_QUANTIZATION_TABLE,
            snap_ties,
        )
        b_q[i] = quantize_oracle(
            dct2d_oracle(planes.b[i], 4, 8),
            CHROMINANCE_QUANTIZATION_TABLE,
            snap_ties,
        )
    zz_lum = lum_q[:, zigzag_indices(8, 8)]
    zz_r = r_q[:, zigzag_indices(4, 8)]
    zz_b = b_q[:, zigzag_indices(4, 8)]
    rle_lum = [rle_oracle(zz_lum[i]) for i in range(n)]
    rle_r = [rle_oracle(zz_r[i]) for i in range(n)]
    rle_b = [rle_oracle(zz_b[i]) for i in range(n)]
    return {
        "y": y, "cr": cr, "cb": cb,
        "cr_sub": cr_sub, "cb_sub": cb_sub,
        "planes": planes,
        "lum_q": lum_q, "r_q": r_q, "b_q": b_q,
        "zz_lum": zz_lum, "zz_r": zz_r, "zz_b": zz_b,
        "rle_lum": rle_lum, "rle_r": rle_r, "rle_b": rle_b,
    }


def jpeg_roundtrip_oracle(
    rgb: np.ndarray, snap_ties: bool = False
) -> Tuple[np.ndarray, Dict[str, object]]:
    """Full encode→decode round trip (JPEG.c main():1099-1428), returning the
    reconstructed RGB image and all intermediates."""
    fwd = jpeg_forward_oracle(rgb, snap_ties)
    planes: MCUPlanes = fwd["planes"]
    n = planes.lum.shape[0]
    out_lum = np.zeros_like(planes.lum)
    out_r = np.zeros_like(planes.r)
    out_b = np.zeros_like(planes.b)
    huff_bits = {"lum": [], "r": [], "b": []}
    for i in range(n):
        rec = {}
        for key, rle, width, size, table in (
            ("lum", fwd["rle_lum"][i], 8, 64, LUMINANCE_QUANTIZATION_TABLE),
            ("r", fwd["rle_r"][i], 4, 32, CHROMINANCE_QUANTIZATION_TABLE),
            ("b", fwd["rle_b"][i], 4, 32, CHROMINANCE_QUANTIZATION_TABLE),
        ):
            bits, root, _codes = encode_huffman_oracle(rle)
            huff_bits[key].append(bits)
            decoded = decode_huffman_oracle(root, bits)
            # JPEG.c:1264-1267 overwrites the RLE buffer with the decode
            # output; for the degenerate single-symbol tree the code is empty
            # and the original buffer survives, exactly like the reference.
            if len(decoded) < len(rle):
                decoded = decoded + rle[len(decoded):]
            zz = inverse_rle_oracle(decoded, size)
            deq = dequantize_oracle(
                reverse_zigzag_oracle(zz, width, 8), table
            )
            rec[key] = idct2d_oracle(deq, width, 8)
        out_lum[i], out_r[i], out_b[i] = rec["lum"], rec["r"], rec["b"]
    rec_planes = MCUPlanes(
        out_lum, out_r, out_b,
        planes.blocks_per_row, planes.blocks_per_col,
        planes.height, planes.width,
    )
    reconstructed = assemble_image(rec_planes)
    result = dict(fwd)
    result["huff_bits"] = huff_bits
    result["rec_planes"] = rec_planes
    return reconstructed, result
