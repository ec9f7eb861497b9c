"""Auto mode: try the exact algorithm with a 100M-cell budget; fall back to
the chaining heuristic (reference mwf_wfa_auto, miniwfa.c:898-908)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..options import Options
from .chain import align_chain_batch
from .exact import Result, align_batch, as_bytes


def align_auto_batch(pairs: Sequence[Tuple[object, object]],
                     opt: Options) -> List[Result]:
    """Auto policy over a batch: the exact attempt with the 100M-cell
    budget (per-lane early stop), then one batched chain pass over the
    lanes that gave up.

    The exact attempt is probed in SCORE mode first: score mode
    allocates no tb buffer and takes the full cycle budget upfront, so a
    doomed attempt on a Mb-scale pair costs an early-stopped score run
    instead of a W/S_CAP escalation ladder dragging multi-GB tb
    buffers.  Lanes that succeed re-run in TB
    mode sized exactly from the known score — output (score, CIGAR,
    n_iter) is identical to a direct CIGAR attempt because both runs
    compute the same cells."""
    o = opt.replace(step=0, max_iter=100_000_000)
    res = align_batch(pairs, o.replace(cigar=False), band_limit="stop",
                      w0=512)
    if opt.cigar:
        ok = [i for i, r in enumerate(res) if r.s >= 0]
        if ok:
            ns = opt.max_pen + 1
            smax = max(res[i].s for i in ok)
            dmax = max(abs(len(as_bytes(pairs[i][0]))
                           - len(as_bytes(pairs[i][1]))) for i in ok)
            # the probe already enforced the cell budget and the re-run
            # computes the same cells, so drop max_iter here: with the
            # budget as a runtime scalar this is cosmetic for compile
            # sharing, but it removes the stop-at-the-edge corner when
            # the budget lands mid-band (n_iter within one band width)
            sub = align_batch([pairs[i] for i in ok],
                              o.replace(max_iter=0), band_limit="stop",
                              w0=2 * smax + dmax + 2 * ns + 24,
                              s0=smax + 8)
            for i, r in zip(ok, sub):
                res[i] = r
    failed = [i for i, r in enumerate(res) if r.s < 0]
    if failed:
        oc = opt.replace(step=5000 if opt.cigar else 0, max_iter=0)
        chained = align_chain_batch([pairs[i] for i in failed], oc)
        for i, r in zip(failed, chained):
            res[i] = r
    return res


def align_auto(ts, qs, opt: Options) -> Result:
    return align_auto_batch([(ts, qs)], opt)[0]
