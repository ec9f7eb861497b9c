"""Sequence word-packing for the LCP-extension step of the wavefront engine.

The reference extends diagonals by XOR-ing unaligned 64-bit words and
counting trailing zero bytes (wf_extend1_padded, miniwfa.c:212-226).  A
vector lane cannot load an unaligned word, so we precompute all CPW rotations of
the packed word stream ("ways"): way ``r`` holds, at word index ``m``, the
CPW characters starting at position ``m*CPW + r``.  Any 16-char (2-bit
packing) or 4-char (byte packing) probe anywhere in the sequence is then
ONE int32 word gather: ``way = pos % CPW, index = pos // CPW``.

Packing modes:
  * cpw=16 — 2 bits/char, valid only when every byte is in {A,C,G,T}
    (exact bytes; case-sensitive like the reference's byte compare).
  * cpw=4  — 8 bits/char (raw bytes), always valid.

Equality of packed words ⟺ equality of the underlying byte runs because
both mappings are injective on the allowed alphabet.  Out-of-range reads
are prevented by the engine's per-diagonal advance cap (min(tl-1-k,
ql-1-i)), so no sentinel characters are needed.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

_NT2 = np.zeros(256, dtype=np.uint32)
_NT2[ord("A")] = 0
_NT2[ord("C")] = 1
_NT2[ord("G")] = 2
_NT2[ord("T")] = 3
_ACGT = frozenset(b"ACGT")


def can_pack2(seqs: Sequence[bytes]) -> bool:
    """True iff every byte of every sequence is uppercase A/C/G/T."""
    return all(not (set(s) - _ACGT) for s in seqs)


def n_words(cap: int, cpw: int) -> int:
    """Word-array length per way for a length bucket ``cap``."""
    return cap // cpw + 2


def pack_ways(seqs: Sequence[bytes], cap: int, cpw: int) -> np.ndarray:
    """Pack a batch of sequences into all-rotations word form.

    Returns int32 [B, cpw * n_words(cap, cpw)]; way r occupies the slice
    [r*NW, (r+1)*NW) and holds words of CPW chars starting at char r.
    """
    assert cpw in (4, 16)
    bits = 2 if cpw == 16 else 8
    nw = n_words(cap, cpw)
    b = len(seqs)
    # char codes, zero-padded to (nw+1) whole words
    codes = np.zeros((b, (nw + 1) * cpw), dtype=np.uint32)
    for i, s in enumerate(seqs):
        if not len(s):
            continue
        raw = np.frombuffer(s, dtype=np.uint8)
        codes[i, : len(s)] = _NT2[raw] if cpw == 16 else raw.astype(np.uint32)
    # base (way-0) words, little-endian chars within the word
    v = codes.reshape(b, nw + 1, cpw)
    w0 = np.zeros((b, nw + 1), dtype=np.uint32)
    for j in range(cpw):
        w0 |= v[:, :, j] << np.uint32(bits * j)
    # way r = base stream shifted right by r chars
    out = np.empty((b, cpw, nw), dtype=np.uint32)
    out[:, 0] = w0[:, :nw]
    for r in range(1, cpw):
        sh = np.uint32(bits * r)
        out[:, r] = (w0[:, :nw] >> sh) | (w0[:, 1 : nw + 1] << np.uint32(32 - bits * r))
    return out.reshape(b, cpw * nw).view(np.int32)
