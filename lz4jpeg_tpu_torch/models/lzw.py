"""LZW codec.

A copy of ``lz4jpeg_tpu/models/lzw.py`` (framework-free;
``tests/test_torch_lz4_parity.py`` holds its outputs equal to the
original's).

The reference ships a sequential LZW *encoder only*
(``Algorithms/sequential/LZW/LZW.c``): a 128-entry base dictionary, grown by
one entry per emitted code, longest-prefix lookup by linear ``strcmp`` scan
(O(dict·len) per step, LZW.c:91-98), output as space-separated decimal
indices with a trailing space (``concatenateEncodedValue``, LZW.c:100-120).

``lzw_encode`` reproduces that byte-for-byte, including the reference's base
alphabet quirks (LZW.c:228-235): indices 0-13 are the C escapes
``\\0..\\r``, 14-108 are ``' '..'~'``, 109 is DEL, and the remaining 18
slots are NUL padding (the array has 110 initializers for 128 slots) — so
bytes 14-31 are *not* in the base dictionary and a lone occurrence encodes
as ``-1``, exactly like the C.

``lzw_decode`` is a framework extension (the reference has no decoder):
standard LZW decoding over the same alphabet, inverting ``lzw_encode`` for
any input whose bytes are all in the base dictionary.

The dictionary search is replaced by a hash map — same emitted indices
(the linear scan always finds patterns at their unique first index for
in-alphabet inputs), minus the O(n²) scan.
"""

from __future__ import annotations

from typing import Dict, List

# Reference base alphabet (LZW.c:228-235): 110 explicit entries + 18 NULs.
# The patterns are C strings, so the '\0' entry at index 0 *is* the empty
# string — as are the 18 zero-padded tail slots.  ``dictionarySearch``'s
# linear scan therefore resolves both "" and any padding hit to index 0,
# which is what the encoder emits for the initial empty ``w`` when the
# first character is out-of-alphabet.
_BASE_CHARS = (
    [b""]                                      # '\0' == empty C string
    + [bytes([i]) for i in range(1, 14)]       # '\1'..'\r'
    + [bytes([i]) for i in range(32, 127)]     # ' '..'~'
    + [b"\x7f"]                                # '\177'
    + [b""] * 18                               # zero-padded tail
)


def _base_dictionary() -> Dict[bytes, int]:
    d: Dict[bytes, int] = {}
    for i, ch in enumerate(_BASE_CHARS):
        # Linear scan returns the FIRST match (LZW.c:92-97): keep index 0
        # for the duplicated NUL padding entries.
        d.setdefault(ch, i)
    return d


def lzw_encode(data: bytes) -> str:
    """Encode to the reference's output format: decimal indices, each
    followed by one space (LZW.c:103)."""
    dictionary = _base_dictionary()
    next_index = 128
    out: List[str] = []
    w = b""
    for i in range(len(data)):
        c = data[i : i + 1]
        w_prime = w + c
        if w_prime in dictionary:
            w = w_prime
        else:
            out.append(str(dictionary.get(w, -1)))
            dictionary[w_prime] = next_index
            next_index += 1
            w = c
    if w:
        out.append(str(dictionary.get(w, -1)))
    return "".join(s + " " for s in out)


def lzw_decode(encoded: str) -> bytes:
    """Invert ``lzw_encode`` (framework extension; no reference decoder).

    Handles the standard LZW corner case where a code refers to the entry
    being defined (``cScSc`` pattern).
    """
    codes = [int(tok) for tok in encoded.split()]
    if not codes:
        return b""
    patterns: Dict[int, bytes] = {}
    for i, ch in enumerate(_BASE_CHARS):
        patterns[i] = ch
    next_index = 128
    first = codes[0]
    if first not in patterns:
        raise ValueError(f"invalid first code {first}")
    w = patterns[first]
    out = bytearray(w)
    for code in codes[1:]:
        if code in patterns:
            entry = patterns[code]
        elif code == next_index:
            entry = w + w[:1]
        else:
            raise ValueError(f"invalid code {code}")
        out += entry
        patterns[next_index] = w + entry[:1]
        next_index += 1
        w = entry
    return bytes(out)
