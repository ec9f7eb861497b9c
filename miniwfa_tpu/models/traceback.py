"""Host-side sequential decoders: traceback walk and checkpoint recovery.

Both are O(n + s) pointer chases — inherently serial and tiny next to the
O(n·s) wavefront work, so they run on the host over buffers fetched from the
device (SURVEY.md §2 C10/C13 mapping).  A native C++ implementation is used
when available (miniwfa_tpu.utils.native); this module is the always-correct
pure-Python fallback and the semantic specification.

Traceback semantics replicate the reference walker exactly
(wf_traceback, miniwfa.c:329-377): the 7-bit byte per cell is
``extD2<<6|extI2<<5|extD1<<4|extI1<<3|fromState``; the ext bit decides
whether a gap step costs e or o+e; leading overhang is emitted as I/D.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..options import Options
from .. import cigar as C


def _check(cond: bool, msg: str) -> None:
    """Data-integrity check that survives ``python -O`` (these guard
    device-produced buffers, not programmer invariants — a corrupted
    pointer chain must raise, matching the engine-inconsistency errors
    in models/exact.py)."""
    if not cond:
        raise RuntimeError(msg)


def traceback_walk(
    opt: Options,
    tb_bits: np.ndarray,   # [n_rows, W] uint8; row r ↔ score r+1
    tb_lo: np.ndarray,     # [n_rows] int32; row band lo (anchor = lo - m1)
    m1: int,               # pad width used by the engine (max_pen + 1)
    ts: bytes,
    qs: bytes,
    s_final: int,
    last_state: int,
) -> List[int]:
    """Walk the packed traceback buffer into a packed CIGAR."""
    try:
        from ..utils import native
        if native.available():
            out = native.traceback(tb_bits, tb_lo, m1, ts, qs, s_final,
                                   last_state, opt.x, opt.o1, opt.e1,
                                   opt.o2, opt.e2)
            if out is not None:
                return [int(v) for v in out]
    except Exception:
        pass
    tl, ql = len(ts), len(qs)
    i, k = ql - 1, tl - 1
    srow = s_final - 1
    last = int(last_state)
    cig: List[int] = []
    while i >= 0 and k >= 0:
        if last == 0:
            # consume exact matches (miniwfa.c:334-340)
            k0 = k
            while i >= 0 and k >= 0 and qs[i] == ts[k]:
                i -= 1
                k -= 1
            if k0 - k > 0:
                C.push(cig, C.OP_EQ, k0 - k)
            if i < 0 or k < 0:
                break
        _check(srow >= 0, "traceback ran past score 0")
        col = (i - k) - int(tb_lo[srow]) + m1
        x = int(tb_bits[srow, col])
        state = (x & 7) if last == 0 else last
        ext = ((x >> (state + 2)) & 1) if state > 0 else 0
        if state == 0:
            C.push(cig, C.OP_X, 1)
            i -= 1
            k -= 1
            srow -= opt.x
        elif state == 1:
            C.push(cig, C.OP_I, 1)
            i -= 1
            srow -= opt.e1 if ext else opt.o1 + opt.e1
        elif state == 3:
            C.push(cig, C.OP_I, 1)
            i -= 1
            srow -= opt.e2 if ext else opt.o2 + opt.e2
        elif state == 2:
            C.push(cig, C.OP_D, 1)
            k -= 1
            srow -= opt.e1 if ext else opt.o1 + opt.e1
        elif state == 4:
            C.push(cig, C.OP_D, 1)
            k -= 1
            srow -= opt.e2 if ext else opt.o2 + opt.e2
        else:
            raise AssertionError(f"bad traceback state {state}")
        last = state if (state > 0 and ext) else 0
    # leading overhang (miniwfa.c:368-369)
    if i >= 0:
        C.push(cig, C.OP_I, i + 1)
    elif k >= 0:
        C.push(cig, C.OP_D, k + 1)
    cig.reverse()
    return cig


def decode_checkpoints(
    snap_x: np.ndarray,    # [n_snap_cap, NS*5*W] int32
    snap_anc: np.ndarray,  # [n_snap_cap] int32 window anchor per snapshot
    snap_cnt: int,
    last_ptr: int,
    ns: int,
    w_cap: int,
    step: int,
) -> List[Tuple[int, int]]:
    """Recover the (score, diagonal) checkpoints the optimal path crosses
    at each snapshot, newest → oldest pointer jumping
    (reference wf_traceback_seg, miniwfa.c:528-549).

    Flat pointer encoding (matches ops.wavefront.snapshot):
    idx = (slot*5 + state)*W + w, where w is the window index at the
    snapshot's recorded anchor.  Snapshot c was taken at score
    snap_s = step*(c+1)-1; the ring slot holding score s is s % NS, so
    s = snap_s - ((snap_s - slot) mod NS).
    """
    segs: List[Tuple[int, int]] = []
    last = int(last_ptr)
    for c in range(snap_cnt - 1, -1, -1):
        _check(last >= 0, f"pointer chain broke at snapshot {c}: {last}")
        slot = last // (5 * w_cap)
        w = last % w_cap
        snap_s = step * (c + 1) - 1
        s = snap_s - ((snap_s - slot) % ns)
        d = int(snap_anc[c]) + w
        segs.append((s, d))
        last = int(snap_x[c, last])
    _check(last == -1, f"pointer chain did not reach origin: {last}")
    segs.reverse()
    return segs
