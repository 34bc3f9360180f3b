"""Random benchmark inputs.

* ``extract_random_passage`` — a random substring of a text corpus with
  newlines replaced by spaces so every byte stays printable, which the
  parity LZ4 text path requires (``Experiment/random_extract.c:8-71``);
  ``load_corpus`` reads the corpus (the reference's ``Metamorphosis.txt``
  by default); copies of ``lz4jpeg_tpu/utils/inputs.py``'s;
* ``generate_noise_image`` — per-pixel uniform RGB noise, as the
  reference's generator makes (``Experiment/random_image.c:58-77``); a
  copy of ``lz4jpeg_tpu/utils/inputs.py``'s;
* ``generate_text`` — seeded text for the LZ4 codecs: Zipf-distributed
  words of a seeded lowercase vocabulary, joined by spaces.  It stands in
  for the reference's text corpus, which the repository does not carry;
  uniform noise has no matches and only exercises the raw-stored path;
* ``crafted_packed16_rows`` — packed16 run words and lengths that no
  canonical encoder writes but the decoders must take as the spec does;
* ``crafted_match_blocks`` — LZ4 blocks at the edges of the matcher's sort;
* ``smooth_tiles`` — 8-row image tiles of a ramp plus a little noise, whose
  quantized coefficients under a quality-100 table reach the hundreds and
  past 256 (the DC and the low AC terms) while their pixels stay in range.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

TEXT_VOCABULARY = 4096  # distinct words
TEXT_MAX_WORD = 10      # letters per word, at most
TEXT_ZIPF_S = 1.1       # word rank r is drawn with weight r**-s

# A checkout of the reference repository (its corpus and images): the
# directory ``$LZ4JPEG_REFERENCE``, else ``reference/`` at this checkout's
# root.  This repository carries none of its files.
REFERENCE_ROOT = os.environ.get(
    "LZ4JPEG_REFERENCE", str(Path(__file__).resolve().parents[2] / "reference")
)
METAMORPHOSIS_PATH = os.path.join(
    REFERENCE_ROOT, "Output-Input", "input", "Metamorphosis.txt"
)


def extract_random_passage(
    corpus: bytes, length: int, rng: np.random.Generator
) -> bytes:
    if length > len(corpus):
        raise ValueError(f"passage of {length} exceeds corpus ({len(corpus)})")
    start = int(rng.integers(0, len(corpus) - length + 1))
    passage = corpus[start : start + length]
    return passage.replace(b"\r", b" ").replace(b"\n", b" ")


def load_corpus(path: str = METAMORPHOSIS_PATH) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def generate_noise_image(
    height: int, width: int, rng: np.random.Generator
) -> np.ndarray:
    return rng.integers(0, 256, size=(height, width, 3), dtype=np.uint8)


def generate_text(n_bytes: int, rng: np.random.Generator) -> bytes:
    """``n_bytes`` of lowercase words separated by single spaces.

    The vocabulary (word lengths 1..``TEXT_MAX_WORD``) and the word stream
    both come from ``rng``, so one seed gives the same bytes everywhere.
    Word ranks follow a Zipf law of exponent ``TEXT_ZIPF_S``, so frequent
    words repeat at short distances as in natural text."""
    if n_bytes < 0:
        raise ValueError(f"n_bytes must be ≥ 0: {n_bytes}")
    lens = rng.integers(1, TEXT_MAX_WORD + 1, TEXT_VOCABULARY)
    letters = rng.integers(ord("a"), ord("z") + 1, int(lens.sum()),
                           dtype=np.uint8)
    # Vocabulary as one byte string: each word followed by a space.
    word_len = lens + 1
    word_end = np.cumsum(word_len)
    word_start = word_end - word_len
    vocab = np.full(int(word_end[-1]), ord(" "), np.uint8)
    letter_start = np.cumsum(lens) - lens
    for_letters = np.repeat(word_start - letter_start, lens) + np.arange(
        int(lens.sum())
    )
    vocab[for_letters] = letters

    weights = np.arange(1, TEXT_VOCABULARY + 1, dtype=np.float64) ** -TEXT_ZIPF_S
    p = weights / weights.sum()
    mean_len = float((p * word_len).sum())
    parts, total = [], 0
    while total < n_bytes:
        n_words = int((n_bytes - total) / mean_len * 1.05) + 16
        idx = rng.choice(TEXT_VOCABULARY, size=n_words, p=p)
        wl = word_len[idx]
        ends = np.cumsum(wl)
        pos = np.repeat(word_start[idx] - (ends - wl), wl) + np.arange(
            int(ends[-1])
        )
        parts.append(vocab[pos])
        total += int(ends[-1])
    return np.concatenate(parts)[:n_bytes].tobytes() if parts else b""


def crafted_packed16_rows(k: int, rng: np.random.Generator, n_random: int = 40):
    """(rows, k) packed16 words (int16 bits) and int32 symbol lengths: lengths
    shorter than the nonzero words, count sums below and above k, value -512
    with count 1 (word 0) mid-row and in every slot, the value limits ±511,
    odd, negative and oversized lengths, no valid slot; then ``n_random``
    random words with lengths in [-2, 2k + 2]."""
    def word(count, value):
        return ((count - 1) << 10) | (value + 512)

    full = [word(1, int(v)) for v in rng.integers(-511, 512, size=k)]
    rows = [
        (full, 6),
        ([word(5, 3), word(5, -4), word(5, 7)], 6),
        ([word(40, 3), word(40, -9)], 4),
        ([word(64, 11), word(3, 2)], 4),
        ([word(9, 5), 0, word(20, -1)], 6),
        ([0], 2),
        ([0] * k, 2 * k),
        ([word(2, 511), word(3, -511)], 4),
        (full, 7),
        (full, -3),
        (full, 2 * k + 10),
        ([word(1, 0)] * k, 0),
    ]
    words = rng.integers(0, 1 << 16, size=(len(rows) + n_random, k))
    lengths = rng.integers(-2, 2 * k + 3, size=len(rows) + n_random)
    for i, (w, n) in enumerate(rows):
        words[i] = 0
        words[i, : len(w)] = w[:k]
        lengths[i] = n
    return words.astype(np.uint16).view(np.int16), lengths.astype(np.int32)


def crafted_rle_rows(n: int, length: int, rng: np.random.Generator):
    """(n, length) int16 rows for run-length compaction: each value repeats
    the one before it with probability 0.6 (runs of every length) and takes
    one of 7 small values or, one time in eight, any int16; the first rows
    (as many as ``n`` holds) are all equal, all distinct, the int16 limits
    alternating, and all -32768."""
    vals = rng.integers(-3, 4, size=(n, length))
    wide = rng.random((n, length)) < 0.125
    vals[wide] = rng.integers(-32768, 32768, size=int(wide.sum()))
    repeat = rng.random((n, length)) < 0.6
    for j in range(1, length):
        vals[:, j] = np.where(repeat[:, j], vals[:, j - 1], vals[:, j])
    crafted = [
        np.full(length, 7),
        np.arange(length) - length // 2,
        np.where(np.arange(length) % 2 == 0, 32767, -32768),
        np.full(length, -32768),
    ]
    for i, row in enumerate(crafted[:n]):
        vals[i] = row
    return vals.astype(np.int16)


MATCH_BLOCK_KINDS = ("one_byte", "period4", "short", "zeros", "padding",
                     "ragged")


def crafted_match_blocks(p: int, rng: np.random.Generator):
    """(6, p) uint8 blocks and (6,) int32 lengths, in ``MATCH_BLOCK_KINDS``
    order: one repeated byte (every valid anchor in one hash bucket); a
    4-byte period; 3 bytes of text, shorter than a hash window; a full block
    of zeros; an all-zero padding block of length 0; and text that ends at
    p/2 + 3 before zero padding.  No length exceeds p."""
    text = np.frombuffer(generate_text(p, rng), np.uint8)
    blocks = np.zeros((len(MATCH_BLOCK_KINDS), p), np.uint8)
    blocks[0] = ord("a")
    blocks[1] = np.resize(np.frombuffer(b"abcd", np.uint8), p)
    short, half = min(3, p), min(p // 2 + 3, p)
    blocks[2, :short] = text[:short]
    blocks[5, :half] = text[:half]
    lengths = np.array([p, p, short, p, 0, half], np.int32)
    return blocks, lengths


def crafted_parity_bytes(p: int) -> bytes:
    """Rows of ``p`` bytes for the parity matcher: a run of c equal bytes
    after one distinct byte for c in 256, 257, 260, 261, 512 and 513 where
    it fits (best lengths 256, 257, 260, 512 at the run's second byte:
    the uint8 truncation makes 256 and 512 literals and 257 a match of 1),
    a row of ties between distances, and a periodic row."""
    rows = []
    for run in (256, 257, 260, 261, 512, 513):
        if run + 2 > p:
            continue
        row = bytearray(range(1, p + 1)) if p <= 255 else bytearray(
            (i * 7 + 3) % 251 for i in range(p))
        row[1 : 1 + run] = b"a" * run
        rows.append(bytes(row))
    tie = (b"abcdX" + b"abcdY" + b"abcdZ" + b"abcdabcd" + b"xyzw") * p
    rows.append(tie[:p])
    rows.append((b"0123456789" * p)[:p])
    return b"".join(rows)


def segment_end_candidates(p: int, stride: int, rng: np.random.Generator):
    """(4, p / stride) int32 packed match candidates, as K2 writes them
    (``(lcp << pos_bits) | distance in anchors``), and (4,) int32 lengths,
    for the LZ4T parse's edge cases with 512-byte segments: row 0's every
    anchor reaches exactly its segment's end (lcp 16, or the bytes left
    where fewer), so chains of matches end on each segment's end; row 1
    random words, every seventh without a candidate, and a ragged length;
    row 2 lcp 16 at the largest distance (past low ``max_dist`` caps) and
    a length that ends mid-segment; row 3 random words and a length of 3."""
    pa = p // stride
    pos_bits = (pa - 1).bit_length()
    lcp = rng.integers(0, 17, (4, pa))
    dist = rng.integers(0, pa, (4, pa))
    left = 512 - (np.arange(pa) * stride) % 512
    lcp[0] = np.minimum(left, 16)
    dist[0] = 1
    dist[1, ::7] = 0
    lcp[2] = 16
    dist[2] = pa - 1
    packed = ((lcp << pos_bits) | dist).astype(np.int32)
    lengths = np.array([p, p - 13, p - 700, 3], np.int32)
    return packed, lengths


def smooth_tiles(n: int, width: int, rng: np.random.Generator) -> np.ndarray:
    """(n, 8, width) uint8 tiles, each a ramp (a level in [16, 240], a slope
    of up to ±6 a pixel down and across) plus integer noise in [-3, 3],
    clipped to [0, 255]."""
    rows = np.arange(8, dtype=np.float64)[:, None]
    cols = np.arange(width, dtype=np.float64)[None, :]
    level = rng.uniform(16, 240, (n, 1, 1))
    down, across = (rng.uniform(-6, 6, (n, 1, 1)) for _ in range(2))
    noise = rng.integers(-3, 4, (n, 8, width))
    tiles = level + down * (rows - 3.5) + across * (cols - (width - 1) / 2)
    return np.clip(np.rint(tiles) + noise, 0, 255).astype(np.uint8)

