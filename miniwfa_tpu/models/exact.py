"""Exact WFA alignment driver (host orchestration around the device loop).

Implements the reference's ``mwf_wfa_exact`` behavior (miniwfa.c:603-615):
score-only, high-memory CIGAR traceback, and the two-pass low-memory stripe
mode, with identical scores, CIGARs and cell counts — batched.

Host responsibilities (cheap, O(n+s) per pair): sequence encoding, capacity
bucket selection with escalate-and-retry on overflow, traceback walking,
checkpoint decoding.  Device responsibilities (the O(n·s) work): the whole
wavefront loop over a batch of pairs, compiled once per capacity bucket.

Batching model: pairs are padded into a lane bucket and advance in lockstep
(one while-loop iteration = one wavefront cycle for every still-running
lane).  Lanes that outgrow the band window (W), score budget (S_CAP) or
snapshot capacity re-run in an escalated bucket; completed lanes' results
are bit-identical to a solo run because every per-lane update is masked.
"""

from __future__ import annotations

import os
import time

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax

from ..options import Options
from ..ops import pack
from ..ops.wavefront import (
    MODE_PASS1,
    MODE_SCORE,
    MODE_TB,
    WfSpec,
    get_aligner,
)
from . import traceback as tbk

Seg = List[Tuple[int, int]]


@dataclass
class Result:
    """Alignment result (reference mwf_rst_t, miniwfa.h:46-51)."""

    s: int                       # score; -1 when stopped by max_s/max_iter
    cigar: Optional[List[int]]   # packed len<<4|op, or None in score mode
    n_iter: int = 0              # total wavefront cells (Σ band widths)

    @property
    def cigar_str(self) -> Optional[str]:
        from .. import cigar as C
        return None if self.cigar is None else C.to_string(self.cigar)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _prev_pow2(n: int) -> int:
    """Largest power of two <= n (n >= 1).  Lane-budget caps must be
    pow2-floored: dispatch batches are pow2-rounded up (_next_pow2), so a
    non-pow2 cap would let the rounded batch outgrow the device budget the
    cap was computed against (e.g. cap=5 -> B=8 -> 1.6x the budget)."""
    p = 1
    while p * 2 <= n:
        p <<= 1
    return p


def as_bytes(s) -> bytes:
    if isinstance(s, bytes):
        return s
    if isinstance(s, str):
        return s.encode("latin1")
    return bytes(s)


def _cpw_for(ts_list: Sequence[bytes], qs_list: Sequence[bytes]) -> int:
    """Packing mode for a batch: 16 chars/word (2-bit) when every byte is
    uppercase ACGT, else 4 chars/word (raw bytes)."""
    return 16 if pack.can_pack2(ts_list) and pack.can_pack2(qs_list) else 4


@dataclass(frozen=True)
class _Buckets:
    B: int
    LT: int
    LQ: int
    W: int
    S_CAP: int
    W_full: int   # band can never exceed this
    S_full: int   # score can never exceed this


def _buckets_for(opt: Options, ts_list, qs_list, w0: int, s0: int) -> _Buckets:
    ns = opt.max_pen + 1
    LT = _next_pow2(max(128, max((len(t) for t in ts_list), default=1)))
    LQ = _next_pow2(max(128, max((len(q) for q in qs_list), default=1)))
    # caps derived from the *buckets* so equal-bucket batches share one jit
    w_full = _next_pow2(LT + LQ + 1 + 2 * ns + 18)
    s_bound = opt.x * min(LT, LQ) + opt.gap_cost(LT + LQ) + 4
    if opt.max_s > 0:
        s_bound = min(s_bound, opt.max_s + 2)
    s_full = _next_pow2(s_bound)
    return _Buckets(
        B=_next_pow2(max(1, len(ts_list))),
        LT=LT, LQ=LQ,
        W=min(_next_pow2(max(w0, 2 * ns + 24)), w_full),
        S_CAP=min(_next_pow2(s0), s_full),
        W_full=w_full, S_full=s_full,
    )


def _escalate(bk: _Buckets, ovf_band: bool, ovf_scap: bool) -> _Buckets:
    W, S = bk.W, bk.S_CAP
    if ovf_band:
        W = min(W * 4, bk.W_full)
    if ovf_scap:
        S = min(S * 4, bk.S_full)
    if (W, S) == (bk.W, bk.S_CAP):
        raise RuntimeError("bucket escalation stuck — engine bug")
    return _Buckets(bk.B, bk.LT, bk.LQ, W, S, bk.W_full, bk.S_full)


def _run_device(opt: Options, mode: int, bk: _Buckets,
                ts_list: List[bytes], qs_list: List[bytes],
                segs: Optional[List[Optional[Seg]]] = None):
    from ..utils import hbm
    n = len(ts_list)
    B = bk.B
    use_seg = segs is not None and any(segs)
    seg_cap = max((len(s) for s in segs if s), default=0) + 1 if use_seg else 1
    spec = WfSpec(
        B=B, W=bk.W, S_CAP=bk.S_CAP, LT=bk.LT, LQ=bk.LQ,
        x=opt.x, o1=opt.o1, e1=opt.e1, o2=opt.o2, e2=opt.e2,
        mode=mode, cpw=_cpw_for(ts_list, qs_list),
        step=opt.step if mode == MODE_PASS1 else 0,
        n_snap=(bk.S_CAP // opt.step + 2) if mode == MODE_PASS1 else 0,
        seg_cap=seg_cap, use_seg=use_seg,
        max_s=opt.max_s if mode != MODE_PASS1 else 0,
        max_iter=opt.max_iter if mode != MODE_PASS1 else 0,
    )
    fn = get_aligner(spec)
    pad_t = ts_list + [b""] * (B - n)
    pad_q = qs_list + [b""] * (B - n)
    t_pad = pack.pack_ways(pad_t, bk.LT, spec.cpw)
    q_pad = pack.pack_ways(pad_q, bk.LQ, spec.cpw)
    tl = np.array([len(t) for t in pad_t], np.int32)
    ql = np.array([len(q) for q in pad_q], np.int32)
    seg_s = np.full((B, seg_cap), -9, np.int32)
    seg_d = np.zeros((B, seg_cap), np.int32)
    n_seg = np.zeros((B,), np.int32)
    if use_seg:
        for i, sg in enumerate(segs):
            if sg:
                seg_s[i, : len(sg)] = [s for s, _ in sg]
                seg_d[i, : len(sg)] = [d for _, d in sg]
                n_seg[i] = len(sg)
    out = fn(t_pad, q_pad, tl, ql, seg_s, seg_d, n_seg)
    hbm.note_arrays(f"lax mode={mode} B={B} W={bk.W} S_CAP={bk.S_CAP}",
                    dict(out), spec=spec)
    return out, spec


# Device-buffer budgets.  On an accelerator each is 30 % of what the
# runtime lets this process allocate (memory_stats()["bytes_limit"]): the
# compiled loop holds a second copy of its carried tb table
# (memory_analysis: temp ~ output) and the host fetch slices a third copy
# of up to its size, so three copies leave a tenth of the device for the
# DP planes, packed sequences and XLA's scratch.  The CPU backend reports
# no limit and keeps fixed host-RAM budgets.
CPU_TB_LANE_BUDGET = 4 << 30      # high-mem tb table, B * S_CAP * W bytes
CPU_PASS1_SNAP_BUDGET = 6 << 30   # pass-1 snapshots, B * n_snap * NS*5*W * 4


def budgets(limit: Optional[int]) -> Tuple[int, int]:
    """(tb_lane_budget, pass1_snap_budget) in bytes for a device whose
    runtime allocation limit is ``limit`` (None: the CPU backend)."""
    if limit is None:
        return CPU_TB_LANE_BUDGET, CPU_PASS1_SNAP_BUDGET
    return 3 * limit // 10, 3 * limit // 10


def _budgets() -> Tuple[int, int]:
    from ..utils import hbm
    return budgets(hbm.device_limit())


def _pass1_lane_cap(opt: Options, bk: _Buckets) -> int:
    ns = opt.max_pen + 1
    n_snap = bk.S_CAP // opt.step + 2
    per_lane = n_snap * ns * 5 * bk.W * 4
    return _prev_pow2(max(1, _budgets()[1] // max(per_lane, 1)))


def w_cap_for(opt: Options, mode: int, tb_budget: int,
              snap_budget: int) -> int:
    """Largest band window ONE lane can hold within the budgets.

    A lane whose band needs W diagonals has run ~W/2 cycles (the band
    grows by at most one diagonal per side per cycle), so its S_CAP is at
    least W/2: the high-mem tb table is then W*W/2 bytes, and pass 1 keeps
    W/(2*step)+2 snapshot rows of NS*5*W int32.  Score mode allocates no
    W*S buffer and is not capped."""
    ns = opt.max_pen + 1
    if mode == MODE_TB:
        def need(w):
            return w * (w // 2)
        budget = tb_budget
    elif mode == MODE_PASS1:
        def need(w):
            return (w // (2 * opt.step) + 2) * ns * 5 * w * 4
        budget = snap_budget
    else:
        return 1 << 30
    w = 1024
    while need(2 * w) <= budget:
        w *= 2
    return w


def _w_cap(opt: Options, mode: int) -> int:
    return w_cap_for(opt, mode, *_budgets())


def _first_rung(opt: Options, mode: int, bk: _Buckets
                ) -> Tuple[_Buckets, int]:
    """The first rung of a batch's ladder and the mode's band cap.

    Score mode allocates no buffer that scales with S_CAP (tb and
    snapshot buffers exist only in TB/PASS1 modes), so it takes the full
    score bound upfront: its ladder then only re-runs for the band
    window, never for the cycle budget.  The window starts within the
    device cap."""
    w_cap = _w_cap(opt, mode)
    S = bk.S_full if mode == MODE_SCORE else bk.S_CAP
    return (_Buckets(bk.B, bk.LT, bk.LQ, min(bk.W, w_cap), S,
                     bk.W_full, bk.S_full), w_cap)


def _tb_lane_cap(opt: Options, mode: int, bk: _Buckets, w_cap: int) -> int:
    """Lanes one high-mem traceback dispatch may hold on one device.

    The tb buffer is B * S_CAP * W bytes (1 B/cell); the batch is chunked
    so one dispatch never outgrows the device (the reference's high-mem
    mode has the same footprint in host RAM, README.md:98 — batching
    multiplies it by the lanes).  A lane that alone exceeds the budget
    raises the documented band-limit error."""
    per_lane = max(1, bk.S_CAP * bk.W)
    tb_budget = _budgets()[0]
    if per_lane > tb_budget:
        raise _band_limit_error(opt, mode, bk.W, w_cap)
    return _prev_pow2(max(1, tb_budget // per_lane))


def _pass2_buckets(opt: Options, bk: _Buckets, s_p1: Sequence[Optional[int]],
                   ts_list, qs_list) -> _Buckets:
    """Low-mem pass 2's rung, sized from pass 1's optimal scores.

    Pass 2 runs with the band collapsed to <= 2*step+1 at checkpoints
    (miniwfa.c:413) and reaches exactly pass 1's optimal score, so its
    cycle budget is sized from that instead of the pow2 ladder (a pow2
    jump would double a multi-GB tb buffer).  The band window takes the
    TIGHTER of the collapse bound and the uncollapsed 2s bound: when
    step > s no checkpoint ever fires and sizing from step alone would
    allocate a tb buffer for a band the run cannot reach (B=256 lanes at
    step=5000 with s~850 meant a 17 GB buffer).  Lanes without a pass-1
    score (None) do not size the rung."""
    ns = opt.max_pen + 1
    s_vals = [s for s in s_p1 if s is not None and s >= 0]
    w2 = _next_pow2(2 * opt.step + 2 * ns + 24)
    s_cap2 = bk.S_CAP
    if s_vals:
        s_cap2 = -(-(max(s_vals) + 4) // 4096) * 4096
        d_span = max((abs(len(q) - len(t))
                      for t, q in zip(ts_list, qs_list)), default=0)
        w2 = min(w2, _next_pow2(2 * max(s_vals) + d_span + 2 * ns + 24))
    return _Buckets(bk.B, bk.LT, bk.LQ, W=min(w2, bk.W_full),
                    S_CAP=min(s_cap2, bk.S_full),
                    W_full=bk.W_full, S_full=bk.S_full)


def _run_pass1(opt: Options, bk: _Buckets, ts_list, qs_list
               ) -> Tuple[List[Seg], List[int]]:
    """Low-mem pass 1 for a batch; returns per-pair checkpoint lists
    (reference mwf_wfa_seg, miniwfa.c:551-601) plus each pair's optimal
    score (pass 2 reaches exactly the same score, so its cycle budget
    can be sized precisely instead of laddered)."""
    ns = opt.max_pen + 1
    w_cap = _w_cap(opt, MODE_PASS1)
    if bk.W > w_cap:
        bk = _Buckets(bk.B, bk.LT, bk.LQ, w_cap, bk.S_CAP,
                      bk.W_full, bk.S_full)
    idx = list(range(len(ts_list)))
    segs: List[Optional[Seg]] = [None] * len(ts_list)
    s_fin: List[int] = [0] * len(ts_list)
    prof = os.environ.get("MWF_PROF")
    while idx:
        cap = _pass1_lane_cap(opt, bk)
        chunk, idx_rest = idx[:cap], idx[cap:]
        bk = _Buckets(_next_pow2(max(1, len(chunk))), bk.LT, bk.LQ, bk.W,
                      bk.S_CAP, bk.W_full, bk.S_full)
        idx = chunk
        if prof:
            _t0 = time.perf_counter()
        out, spec = _run_device(opt, MODE_PASS1, bk,
                                [ts_list[i] for i in idx],
                                [qs_list[i] for i in idx])
        fetched = jax.device_get(
            {k: out[k] for k in ("overflow", "snap_cnt", "last_ptr",
                                 "final_s", "ovf_band", "ovf_scap")})
        if prof:
            print(f"[prof] pass1 B={len(idx)} W={bk.W} S_CAP={bk.S_CAP} "
                  f"dispatch={time.perf_counter() - _t0:.3f}s", flush=True)
        ovf = fetched["overflow"][: len(idx)]
        snap_cnt = fetched["snap_cnt"]
        last_ptr = fetched["last_ptr"]
        fs = fetched["final_s"]
        snap_x = None
        retry = []
        for j, i in enumerate(idx):
            if ovf[j]:
                retry.append(i)
                continue
            s_fin[i] = int(fs[j])
            if snap_x is None:
                snap_x = np.asarray(jax.device_get(out["snap_x"]))
                snap_anc = np.asarray(jax.device_get(out["snap_anc"]))
            segs[i] = tbk.decode_checkpoints(
                snap_x[j], snap_anc[j], int(snap_cnt[j]),
                int(last_ptr[j]), ns, spec.W, opt.step)
        if retry:
            need_band = bool(fetched["ovf_band"][: len(idx)].any())
            if need_band and bk.W >= min(bk.W_full, w_cap):
                raise RuntimeError(
                    f"low-mem pass-1 band exceeded the device limit "
                    f"(W={bk.W}, cap {w_cap}) — use a larger step, or the "
                    f"chain or auto mode for this pair")
            bk = _escalate(bk, need_band,
                           bool(fetched["ovf_scap"][: len(idx)].any()))
            bk = _Buckets(_next_pow2(max(1, len(retry))), bk.LT, bk.LQ,
                          min(bk.W, w_cap), bk.S_CAP, bk.W_full, bk.S_full)
        # free the snapshot buffer BEFORE the next dispatch — pass 2's tb
        # buffer must not coexist with it
        out = snap_x = None
        idx = retry + idx_rest
    return segs, s_fin  # type: ignore[return-value]


def _band_limit_error(opt: Options, mode: int, W: int,
                      w_cap: int) -> RuntimeError:
    """The band outgrew the largest device-servable window.

    For high-mem CIGAR mode this is a DOCUMENTED capability boundary,
    not a failure to route around: the 1 B/cell traceback table at
    multi-Mb scale is tens-to-hundreds of GB (the reference itself
    needs 50.6 GB of host RAM for its 5 Mb pair, README.md:98).  The
    supported routes are the ones the reference documents for the same
    wall: the low-mem stripe mode (bit-identical score AND CIGAR, 'use
    -p') or the chain/auto heuristics."""
    if mode == MODE_TB and opt.step <= 0 and opt.cigar:
        return RuntimeError(
            f"high-mem CIGAR traceback exceeds device memory at this "
            f"scale (band W={W} > device cap {w_cap}; the tb table is "
            f"1 byte/cell — the reference needs 50.6 GB host RAM for "
            f"its 5 Mb pair).  Use the low-mem stripe mode (-p / "
            f"Options(step=5000): bit-identical score and CIGAR) or "
            f"the chain/auto mode (-u / -t).")
    return RuntimeError(
        f"band window exceeded the device limit (W={W}, cap {w_cap}) "
        f"— use the chain or auto mode for this pair, or the CPU "
        f"backend")


def align_batch(pairs: Sequence[Tuple[object, object]], opt: Options,
                *, w0: int = 512, s0: int = 512,
                band_limit: str = "raise") -> List[Result]:
    """Exact alignment of a batch of (target, query) pairs.

    ``band_limit`` controls what happens when a pair's band outgrows the
    largest window the device can serve: "raise" (default) raises a
    RuntimeError; "stop" returns s=-1 for those pairs like a max_iter
    stop (the auto driver's policy — it falls back to chaining,
    mirroring mwf_wfa_auto's treatment of failure, miniwfa.c:903-907)."""
    ts_list = [as_bytes(t) for t, _ in pairs]
    qs_list = [as_bytes(q) for _, q in pairs]
    n = len(pairs)
    results: List[Optional[Result]] = [None] * n
    if n == 0:
        return []
    mode = MODE_TB if opt.cigar else MODE_SCORE
    bk, w_cap = _first_rung(opt, mode,
                            _buckets_for(opt, ts_list, qs_list, w0, s0))

    segs: Optional[List[Optional[Seg]]] = None
    run_pass1 = opt.step > 0 and opt.cigar
    if run_pass1:
        # stripe-mode shortcut: when every pair's score UPPER BOUND (the
        # trivial alignment: min(tl,ql) mismatches + one |tl-ql| gap) is
        # below the snapshot period, pass 1 cannot fire a single
        # snapshot ((t+1) % step == 0 needs t+1 >= step > s), so there
        # are no checkpoints and pass 2 IS the plain high-mem run —
        # provably identical output (incl. n_iter: the reference counts
        # pass-2 cells only, mwf_wfa_core miniwfa.c:421).  This is the
        # chain driver's common case (gap fills inherit step=5000,
        # miniwfa.c:905, with gap scores far below it) and skips a
        # whole PASS1 spec compile + dispatch per fill batch.
        s_ub = max(opt.x * min(len(t), len(q))
                   + (opt.gap_cost(abs(len(t) - len(q)))
                      if len(t) != len(q) else 0)
                   for t, q in zip(ts_list, qs_list))
        if s_ub < opt.step:
            run_pass1 = False
    if run_pass1:
        segs, s_p1 = _run_pass1(opt, bk, ts_list, qs_list)
        bk = _pass2_buckets(opt, bk, s_p1, ts_list, qs_list)

    prof = os.environ.get("MWF_PROF")
    idx = list(range(n))
    cur_bk = bk
    while idx:
        cap = len(idx)
        if mode == MODE_TB:
            cap = _tb_lane_cap(opt, mode, cur_bk, w_cap)
        chunk, idx_rest = idx[:cap], idx[cap:]
        idx = chunk
        cur_bk = _Buckets(_next_pow2(max(1, len(idx))), cur_bk.LT,
                          cur_bk.LQ, cur_bk.W, cur_bk.S_CAP,
                          cur_bk.W_full, cur_bk.S_full)
        sub_segs = [segs[i] for i in idx] if segs is not None else None
        if prof:
            _t0 = time.perf_counter()
        out, spec = _run_device(opt, mode, cur_bk,
                                [ts_list[i] for i in idx],
                                [qs_list[i] for i in idx], sub_segs)
        # fetch all small per-lane outputs in one device_get
        fetched = jax.device_get(
            {k: out[k] for k in ("overflow", "stopped", "final_s",
                                 "n_iter_lo", "n_iter_hi", "last_state",
                                 "ovf_band", "ovf_scap")})
        if prof:
            _td = time.perf_counter()
        ovf = fetched["overflow"][: len(idx)]
        stopped = fetched["stopped"][: len(idx)]
        final_s = fetched["final_s"][: len(idx)]
        ni_lo = fetched["n_iter_lo"]
        ni_hi = fetched["n_iter_hi"]
        last_state = fetched["last_state"]
        tb_bits = tb_lo = None
        retry = []
        for j, i in enumerate(idx):
            if ovf[j]:
                retry.append(i)
                continue
            n_iter = (int(ni_hi[j]) << 30) | int(ni_lo[j])
            if stopped[j]:
                results[i] = Result(s=-1, cigar=None, n_iter=n_iter)
                continue
            s = int(final_s[j])
            cig = None
            if opt.cigar:
                if tb_bits is None:
                    _tf = time.perf_counter()
                    smax = max(int(final_s.max()), 0)
                    tb_bits = np.asarray(
                        jax.device_get(out["tb_bits"][:, :smax]))
                    tb_lo = np.asarray(jax.device_get(out["tb_anc"][:, :smax]))
                    if prof:
                        print(f"[prof] tb fetch {tb_bits.nbytes} B "
                              f"{time.perf_counter() - _tf:.3f}s", flush=True)
                # rows are anchored at the window anchor: col = d - anc,
                # i.e. the walker's (tb_lo, m1) with m1 = 0
                cig = tbk.traceback_walk(opt, tb_bits[j], tb_lo[j], 0,
                                         ts_list[i], qs_list[i], s,
                                         int(last_state[j]))
            if cig is not None and os.environ.get("MWF_VALIDATE"):
                # runtime self-validation on every alignment (the
                # reference's per-pair oracle, main.c:72 / mwf-dbg.c):
                # CIGAR must consume exactly (tl, ql), re-score to s,
                # and '='/'X' runs must match the actual bases
                from .. import cigar as _C
                _C.assert_cigar(opt, cig, len(ts_list[i]), len(qs_list[i]),
                                s, ts_list[i], qs_list[i])
            results[i] = Result(s=s, cigar=cig, n_iter=n_iter)
        if prof:
            print(f"[prof] mode={mode} B={len(idx)} W={cur_bk.W} "
                  f"S_CAP={cur_bk.S_CAP} dispatch={_td - _t0:.3f}s "
                  f"walk={time.perf_counter() - _td:.3f}s", flush=True)
        out = tb_bits = tb_lo = None
        if retry:
            ovf_b = fetched["ovf_band"][: len(idx)]
            need_band = bool(ovf_b.any())
            need_scap = bool(fetched["ovf_scap"][: len(idx)].any())
            if need_band and cur_bk.W >= min(cur_bk.W_full, w_cap):
                # the band outgrew the largest device-servable window
                if band_limit != "stop":
                    raise _band_limit_error(opt, mode, cur_bk.W, w_cap)
                kept = []
                for j, i in enumerate(idx):
                    if ovf_b[j]:
                        n_iter = (int(ni_hi[j]) << 30) | int(ni_lo[j])
                        results[i] = Result(s=-1, cigar=None, n_iter=n_iter)
                    elif i in retry:
                        kept.append(i)
                retry = kept
                need_band = False
            if retry:
                cur_bk = _escalate(cur_bk, need_band, need_scap)
                cur_bk = _Buckets(_next_pow2(max(1, len(retry))),
                                  cur_bk.LT, cur_bk.LQ,
                                  min(cur_bk.W, w_cap), cur_bk.S_CAP,
                                  cur_bk.W_full, cur_bk.S_full)
        idx = retry + idx_rest
    return results  # type: ignore[return-value]


def align_exact(ts, qs, opt: Options, *, w0: int = 512, s0: int = 512) -> Result:
    """Exact alignment of one pair; mirrors mwf_wfa_exact (miniwfa.c:603)."""
    return align_batch([(ts, qs)], opt, w0=w0, s0=s0)[0]
