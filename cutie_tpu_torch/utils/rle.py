"""COCO compressed-RLE codec in pure numpy (the port's copy of
cutie_tpu/utils/rle.py; pycocotools is not needed).

Implements the standard COCO mask API wire format: column-major (Fortran)
binary masks, run lengths alternating starting with zeros, LEB128-style
varint packing with a delta on every other count. Used by the BURST reader
and result handler (reference uses pycocotools.mask encode/decode).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def _counts_from_mask(mask: np.ndarray) -> List[int]:
    """Column-major run lengths, starting with the count of zeros."""
    flat = np.asfortranarray(mask.astype(np.uint8)).flatten(order="F")
    if flat.size == 0:
        return [0]
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return runs


def _mask_from_counts(counts: List[int], h: int, w: int) -> np.ndarray:
    total = h * w
    flat = np.zeros(total, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    assert pos == total, (pos, total)
    return flat.reshape((h, w), order="F")


def counts_to_string(counts: List[int]) -> str:
    """COCO rleToString: 5-bit varint with sign continuation; counts at index
    >= 2 are delta-encoded against counts[i-2]."""
    s = []
    for i, x in enumerate(counts):
        if i > 2:  # strict: deltas start at the 4th count (COCO rleToString)
            x = x - counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return "".join(s)


def string_to_counts(s: str) -> List[int]:
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode(mask: np.ndarray) -> Dict:
    """binary HxW mask -> {'size': [h, w], 'counts': str}."""
    h, w = mask.shape
    return {"size": [h, w], "counts": counts_to_string(_counts_from_mask(mask))}


def decode(rle: Dict) -> np.ndarray:
    """{'size': [h, w], 'counts': str} -> binary HxW uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, bytes):
            counts = counts.decode("utf-8")
        counts = string_to_counts(counts)
    return _mask_from_counts(list(counts), h, w)
