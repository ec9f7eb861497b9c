"""Alignment options for the batched WFA engine.

Mirrors the semantics of the reference's ``mwf_opt_t`` / ``mwf_opt_init``
(reference: miniwfa.h:36-44, miniwfa.c:11-18) while using an idiomatic,
hashable Python dataclass so an ``Options`` value can key jit caches.

Scoring model: mismatch costs ``x``, a gap of length ``l`` costs
``min(o1 + l*e1, o2 + l*e2)`` (dual / two-piece affine), matches cost 0.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class Options:
    """Scoring + mode parameters.

    Defaults match the reference (miniwfa.c:14-17):
    x=4, o1=4, e1=2, o2=15, e2=1; kmer=13, max_occ=2, min_len=30.
    """

    # scoring
    x: int = 4
    o1: int = 4
    e1: int = 2
    o2: int = 15
    e2: int = 1

    # whether to produce a CIGAR (reference flag MWF_F_CIGAR)
    cigar: bool = False

    # distance between checkpoints in the low-memory mode; 0 disables
    # (reference mwf_opt_t.step).  step > 0 implies cigar.
    step: int = 0

    # stop the alignment early when the score exceeds this (<=0: no limit)
    max_s: int = 0

    # stop when the total number of wavefront cells exceeds this (<=0: none)
    max_iter: int = 0

    # chaining heuristics (reference miniwfa.c:17)
    kmer: int = 13
    max_occ: int = 2
    min_len: int = 30

    @property
    def max_pen(self) -> int:
        """Largest single-step penalty; the wavefront ring needs
        max_pen+1 slices (reference miniwfa.c:390-392)."""
        return max(self.x, self.o1 + self.e1, self.o2 + self.e2)

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)

    def as_edit_distance(self) -> "Options":
        """Mimic edit distance (reference main.c:35, flag -e)."""
        return self.replace(x=1, o1=0, o2=0, e1=1, e2=1)

    def as_single_affine(self) -> "Options":
        """Mimic plain affine gap cost (reference main.c:34, flag -a)."""
        return self.replace(o2=self.o1, e2=self.e1)

    def gap_cost(self, length: int) -> int:
        """Cost of one gap run of ``length`` under the dual affine model."""
        if length <= 0:
            return 0
        return min(self.o1 + length * self.e1, self.o2 + length * self.e2)
