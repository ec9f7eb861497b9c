"""Batched WFA wavefront engine — the device core.

From-scratch JAX/XLA design of the WaveFront Alignment recurrence under a
dual affine gap cost.  Replicates the *semantics* of the reference engine
(lh3/miniwfa: miniwfa.c:380-435 ``mwf_wfa_core``, miniwfa.c:551-601
``mwf_wfa_seg``) including every tie-break that pins the canonical
co-optimal CIGAR (miniwfa.c:287-307), but the architecture is built for
XLA's static-shape compilation model and wide vector hardware.  It is
plain ``lax``: one jitted ``while_loop`` per static spec, no hand-written
kernel, so it compiles for any XLA backend (the GPU is the deployment
target; the CPU runs the tests).

* **Dense anchored windows, zero hot-loop gathers for state.**  Each of the
  5 DP states lives in a ring ``[B, NS, W]`` (NS = max_pen+1 slices × a
  W-diagonal window) plus a separate *top register* ``[B, W]`` holding the
  newest slice.  A per-lane window anchor maps window index w to absolute
  diagonal ``anc + w``; ALL slices share the lane's anchor, so the d±1
  neighbour reads of the recurrence are static shifts (pad-and-slice).
  The top registers exist because the extension step is a read-modify-write
  of the newest slice: doing that in-place at a *dynamic* ring offset made
  XLA serialize the whole loop; as plain 2D carries it fuses cleanly.
  Each cycle retires the top into the ring at
  slot ``t % NS`` (write-only — every ring *read* this cycle is at a
  different slot; age-1 sources come from the top registers directly).
  When the band nears a window edge, a rare ``lax.cond`` re-anchors the
  lane by rolling its planes.  Out-of-band cells hold WF_NEG_INF, making
  edge reads safe (mirrors the reference's ±(max_pen+1) slice padding,
  miniwfa.c:96-100).

* **Match extension** (the LCP scan, reference miniwfa.c:212-226) probes
  CPW characters per diagonal with ONE packed-word gather per side: the
  sequences are pre-rotated into CPW "ways" of packed words (ops/pack.py),
  so the unaligned CPW-char window at any position is a single int32
  element; first mismatch = trailing-zero count of the XOR (popcount
  trick).  Diagonals that consume the whole probe continue through masked
  full-band multi-word rounds (no top_k/scatter — those resist fusion).
  Advance is capped at min(tl-1-k, ql-1-i) per diagonal, so no sentinel
  characters are needed.

* **Batch-first.**  The whole machine carries a leading batch dimension;
  one ``lax.while_loop`` advances every pair in lockstep (one iteration ==
  one wavefront cycle == one score increment).  W (band window), S_CAP
  (score budget) and sequence-length buckets are static; a lane that
  outgrows its bucket raises an overflow flag and the host re-runs it in a
  larger bucket.  Append-only outputs (traceback rows, low-mem snapshots)
  are dense row writes into device-resident buffers.

Modes: score-only, traceback (7-bit packed bits per cell, one row per
cycle, reference README.md:47-48), low-mem pass 1 (snapshot stripes +
pointer jumping, miniwfa.c:440-526) and pass-2 band collapse at checkpoints
(miniwfa.c:413-416).  The traceback walk itself is O(n+s) sequential and
runs on the host (miniwfa_tpu/models/traceback.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import lax

WF_NEG_INF = -0x40000000  # matches the reference sentinel (miniwfa.c:67)

MODE_SCORE = 0
MODE_TB = 1
MODE_PASS1 = 2


@dataclass(frozen=True)
class WfSpec:
    """Static (trace-time) configuration of the wavefront machine."""

    B: int          # batch lanes
    W: int          # band window capacity (diagonals incl. growth slack)
    S_CAP: int      # max score + 1 (cycle budget / tb rows)
    LT: int         # padded target length bucket
    LQ: int         # padded query length bucket
    x: int
    o1: int
    e1: int
    o2: int
    e2: int
    mode: int = MODE_SCORE
    cpw: int = 16        # chars per packed word: 16 (2-bit ACGT) or 4 (bytes)
    step: int = 0        # snapshot period (pass 1)
    n_snap: int = 0      # snapshot capacity (pass 1)
    seg_cap: int = 1     # checkpoint list capacity (pass 2)
    use_seg: bool = False  # pass-2 band collapse at checkpoints enabled
    max_s: int = 0
    max_iter: int = 0
    # miss-probe shape: words per round and compacted slots per round.
    # Both were tuned on the engine's first accelerator and are not yet
    # measured on the GPU
    kw: int = 4
    a_active: int = 64

    @property
    def NS(self) -> int:  # ring depth = max_pen + 1 (miniwfa.c:390-392)
        return max(self.x, self.o1 + self.e1, self.o2 + self.e2) + 1

    @property
    def NWT(self) -> int:  # packed words per way, target
        return self.LT // self.cpw + 2

    @property
    def NWQ(self) -> int:
        return self.LQ // self.cpw + 2

    def replace_b(self, b: int) -> "WfSpec":
        import dataclasses
        return dataclasses.replace(self, B=b)


def build_aligner(spec: WfSpec):
    """Build the jitted batched alignment loop for a static spec.

    Returns fn(t_words, q_words, tl, ql, seg_s, seg_d, n_seg) -> outputs
    dict; t_words/q_words are the pre-rotated packed sequences from
    ops/pack.py.
    """
    B, W, NS = spec.B, spec.W, spec.NS
    CPW, KW = spec.cpw, spec.kw
    LOGC = 4 if CPW == 16 else 2   # log2(CPW)
    LOGB = 1 if CPW == 16 else 3   # log2(bits per char)
    NWT, NWQ = spec.NWT, spec.NWQ
    is_tb = spec.mode == MODE_TB
    is_p1 = spec.mode == MODE_PASS1
    ages = dict(x=spec.x, o1=spec.o1 + spec.e1, o2=spec.o2 + spec.e2,
                e1=spec.e1, e2=spec.e2)
    assert all(1 <= a <= NS - 1 for a in ages.values())
    arW = jnp.arange(W, dtype=jnp.int32)
    NEG = jnp.int32(WF_NEG_INF)
    GUARD = NS + 4  # re-anchor slack: dropped cells expire before reachable
    PLANES = ("H", "E1", "F1", "E2", "F2")
    TOPS = ("tH", "tE1", "tF1", "tE2", "tF2")
    SF = ("Hs", "E1s", "F1s", "E2s", "F2s")
    TOPSF = ("tHs", "tE1s", "tF1s", "tE2s", "tF2s")

    def slice_at(plane, slot):  # [B, NS, W] at ring slot -> [B, W]
        return lax.dynamic_slice_in_dim(plane, slot, 1, axis=1)[:, 0]

    def write_at(plane, slot, vals):
        return lax.dynamic_update_slice_in_dim(plane, vals[:, None, :], slot,
                                               axis=1)

    def slot_of(s):  # non-negative modulo: virtual negative scores land in
        return jnp.mod(s, NS)  # still-initial all-NEG_INF slots

    def sh_m1(a):  # value at window pos w-1 (diagonal d-1)
        return jnp.concatenate([jnp.full((B, 1), NEG, a.dtype), a[:, :-1]], 1)

    def sh_p1(a):  # value at window pos w+1 (diagonal d+1)
        return jnp.concatenate([a[:, 1:], jnp.full((B, 1), NEG, a.dtype)], 1)

    def pair_probe(tq_words, pt, pq, live):
        """One combined gather for the t-side and q-side probe words of the
        same positions: tq_words is concat(t_words, q_words) along the word
        axis, so this halves the number of indexed ops per miss round.
        Returns (wt, wq)."""
        def side_idx(pos, nw, base):
            way = jnp.bitwise_and(pos, CPW - 1)
            idx = way * nw + jnp.right_shift(pos, LOGC)
            bad = (idx < 0) | (idx >= CPW * nw)
            return idx + base, bad
        it, bt = side_idx(pt, NWT, 0)
        iq, bq = side_idx(pq, NWQ, CPW * NWT)
        idx = jnp.concatenate([it.reshape(B, -1), iq.reshape(B, -1)], axis=1)
        bad = jnp.concatenate([bt.reshape(B, -1), bq.reshape(B, -1)], axis=1)
        lv = live.reshape(B, -1)
        bad = bad | ~jnp.concatenate([lv, lv], axis=1)
        n = CPW * (NWT + NWQ)
        spread = jnp.mod(
            jax.lax.broadcasted_iota(jnp.int32, idx.shape, dimension=1), n)
        idx = jnp.where(bad, spread, idx)
        g = jnp.take_along_axis(tq_words, idx, axis=1)
        m = it.reshape(B, -1).shape[1]
        return (g[:, :m].reshape(pt.shape), g[:, m:].reshape(pq.shape))

    def ctz_chars(x):
        """Index of first mismatching char in an XOR word (x != 0)."""
        u = x.astype(jnp.uint32)
        ctz = lax.population_count(jnp.bitwise_and(~u, u - jnp.uint32(1)))
        return jnp.right_shift(ctz, LOGB).astype(jnp.int32)

    def extend_band(tq_words, tl, ql, k, d, elig, ebase, exw, ebase2, exw2):
        """Vectorized LCP extension of all eligible diagonals.

        k, d, elig: [B, W]; ebase: [B, W]; exw: tuple of KW [B, W] planes.
        Returns (k, ebase, exw).  Reference: wf_extend1_padded
        (miniwfa.c:212-226); the per-diagonal advance is capped at the
        matrix edge instead of using sentinels.

        The match-window cache: for each window slot (= diagonal within
        the anchor epoch) the cache holds the KW packed XOR words of
        target-vs-query for the KW*CPW characters starting at target
        position ``ebase`` on that diagonal (exactly the words the last
        miss probe fetched).  Sequences never change, so the cache never
        invalidates; a probe landing inside the window resolves DENSELY
        by selecting+shifting a cached word — no memory access.  Only
        cache *misses* touch memory, compacted via one top_k + one
        stacked gather + one combined t&q word gather + one stacked
        scatter per round (A slots x KW words).  That compaction paid off
        on the engine's first accelerator, where every indexed op had a
        large fixed cost; on the GPU it is not yet measured against a
        dense probe.
        """
        A = spec.a_active
        BITS = 32 // CPW

        def resolve(k, elig):
            """One dense resolution pass over both cached ways: select the
            covering way, then the word off>>LOGC within it, then shift."""
            pos = k + 1
            cap = jnp.minimum(tl[:, None] - 1 - k, ql[:, None] - 1 - (d + k))
            cap = jnp.where(elig, jnp.maximum(cap, 0), 0)
            off_a = pos - ebase
            off_b = pos - ebase2
            hit_a = (off_a >= 0) & (off_a < KW * CPW)
            hit_b = (off_b >= 0) & (off_b < KW * CPW)
            off = jnp.where(hit_a, off_a, off_b)
            in_win = elig & (hit_a | hit_b)
            offc = jnp.clip(off, 0, KW * CPW - 1)
            j = jnp.right_shift(offc, LOGC)
            xw = jnp.where(hit_a, exw[KW - 1], exw2[KW - 1])
            for jj in range(KW - 2, -1, -1):
                xw = jnp.where(j == jj,
                               jnp.where(hit_a, exw[jj], exw2[jj]), xw)
            r = jnp.bitwise_and(offc, CPW - 1)
            x_sh = jnp.right_shift(xw.astype(jnp.uint32),
                                   (BITS * r).astype(jnp.uint32))
            runw = jnp.where(x_sh == 0, CPW - r, ctz_chars(x_sh))
            adv = jnp.minimum(runw, cap)
            k = jnp.where(in_win, k + adv, k)
            complete = (x_sh != 0) | (adv >= cap)
            return k, elig & ~(in_win & complete)

        k, miss = resolve(k, elig)
        # second dense pass: word-boundary crossers continue into the next
        # cached word (possibly in the other way); remaining cells miss
        k, miss = resolve(k, miss)
        # LRU rotation, DENSE and outside the miss loop (a scattered 2-way
        # rotation doubles the per-round scatter and nets out slower):
        # slots about to re-probe save their current way-A window as way B,
        # so the two ways track the two position streams each diagonal
        # alternates between (own mismatch chain vs trailing gap fans)
        ebase2 = jnp.where(miss, ebase, ebase2)
        exw2 = tuple(jnp.where(miss, a, b) for a, b in zip(exw, exw2))

        import os
        stats = None
        if os.environ.get("MWF_DBG_EXTSTATS"):
            big = jnp.int32(0x3FFFFFFF)
            pmax = jnp.max(jnp.where(elig, k + 1, -big), axis=1)
            pmin = jnp.min(jnp.where(elig, k + 1, big), axis=1)
            span = jnp.sum(jnp.where(jnp.any(elig, axis=1), pmax - pmin, 0))
            stats = (jnp.sum(elig.astype(jnp.int32)),
                     jnp.sum(miss.astype(jnp.int32)),
                     jnp.sum((miss & (k + 1 < ebase)).astype(jnp.int32)),
                     span)

        arKW = jnp.arange(KW, dtype=jnp.int32)[None, None, :] * CPW

        import os as _os
        # bulk rounds before the straggler phase: misses scale with the
        # band window (~0.14*W at 2% divergence), so allow ~3 rounds per
        # 1024 window slots (tuned at W=512 and W=1024 on the engine's
        # first accelerator; not yet measured on the GPU)
        MAXR = int(_os.environ.get("MWF_MAXR", str(max(1, 3 * W // 1024))))

        def cond(c):
            return jnp.any(c[3]) & (c[4] < MAXR)

        NSTK = KW + 3

        def body(c):
            k, eb, exw, miss, rnd = c
            vals, sel = lax.top_k(miss.astype(jnp.int32), A)   # [B, A]
            valid = vals > 0
            # one stacked gather for all per-slot state
            stacked = jnp.stack([k, eb, *exw, miss.astype(jnp.int32)], axis=1)
            selN = jnp.broadcast_to(sel[:, None, :], (B, NSTK, A))
            got = jnp.take_along_axis(stacked, selN, axis=2)
            ksel, eb_old = got[:, 0], got[:, 1]
            exw_old = [got[:, 2 + j] for j in range(KW)]
            ms_old = got[:, 2 + KW]
            dsel = d[:, :1] + sel          # d = anc + w, arithmetic not gather
            isel = dsel + ksel
            caps = jnp.minimum(tl[:, None] - 1 - ksel, ql[:, None] - 1 - isel)
            caps = jnp.where(valid, jnp.maximum(caps, 0), 0)
            psel = ksel + 1
            pt = psel[:, :, None] + arKW
            pq = (isel + 1)[:, :, None] + arKW
            live3 = jnp.broadcast_to(valid[:, :, None], pt.shape)
            wt, wq = pair_probe(tq_words, pt, pq, live3)
            x = jnp.bitwise_xor(wt, wq)
            # first-mismatch scan, statically unrolled over the KW words
            # (a cumprod lowers to reduce_window and a minor-axis gather
            # for the first word costs another indexed op — both avoided)
            run = jnp.zeros_like(ksel)
            xf = jnp.zeros_like(ksel)
            open_ = jnp.ones(ksel.shape, bool)
            for j in range(KW):
                xj = x[:, :, j]
                m = xj == 0
                xf = jnp.where(open_ & ~m, xj, xf)
                run = run + jnp.where(open_ & m, CPW, 0)
                open_ = open_ & m
            run = run + jnp.where(~open_, ctz_chars(xf), 0)
            adv = jnp.where(valid, jnp.minimum(run, caps), 0)
            knew = ksel + adv
            done = valid & ((run < KW * CPW) | (adv >= caps))
            # cache the whole probed window: KW XOR words from psel
            eb_new = jnp.where(valid, psel, eb_old)
            exw_new = [jnp.where(valid, x[:, :, j], exw_old[j])
                       for j in range(KW)]
            new = jnp.stack(
                [jnp.where(valid, knew, ksel), eb_new, *exw_new,
                 jnp.where(valid, (valid & ~done).astype(jnp.int32), ms_old)],
                axis=1)
            stacked = jnp.put_along_axis(stacked, selN, new, axis=2,
                                         inplace=False)
            return (stacked[:, 0], stacked[:, 1],
                    tuple(stacked[:, 2 + j] for j in range(KW)),
                    stacked[:, 2 + KW] != 0, rnd + 1)

        k, ebase, exw, miss, _ = lax.while_loop(
            cond, body, (k, ebase, exw, miss, jnp.int32(0)))

        # --- straggler phase: the few cells still missing are mostly long
        # match runs crossing many probe windows; give them big steps (KW2
        # words each) in few slots, with no cache writes (their future
        # probes land far away anyway)
        A2 = int(_os.environ.get("MWF_A2", str(max(A // 8, 4))))
        KW2 = int(_os.environ.get("MWF_KW2", str(4 * KW)))
        arKW2 = jnp.arange(KW2, dtype=jnp.int32)[None, None, :] * CPW

        def cond2(c):
            return jnp.any(c[1])

        def body2(c):
            k, miss = c
            vals, sel = lax.top_k(miss.astype(jnp.int32), A2)   # [B, A2]
            valid = vals > 0
            stacked = jnp.stack([k, miss.astype(jnp.int32)], axis=1)
            sel2 = jnp.broadcast_to(sel[:, None, :], (B, 2, A2))
            got = jnp.take_along_axis(stacked, sel2, axis=2)
            ksel, ms_old = got[:, 0], got[:, 1]
            dsel = d[:, :1] + sel
            isel = dsel + ksel
            caps = jnp.minimum(tl[:, None] - 1 - ksel, ql[:, None] - 1 - isel)
            caps = jnp.where(valid, jnp.maximum(caps, 0), 0)
            pt = (ksel + 1)[:, :, None] + arKW2
            pq = (isel + 1)[:, :, None] + arKW2
            live3 = jnp.broadcast_to(valid[:, :, None], pt.shape)
            wt, wq = pair_probe(tq_words, pt, pq, live3)
            x = jnp.bitwise_xor(wt, wq)
            run = jnp.zeros_like(ksel)
            xf = jnp.zeros_like(ksel)
            open_ = jnp.ones(ksel.shape, bool)
            for j in range(KW2):
                xj = x[:, :, j]
                m = xj == 0
                xf = jnp.where(open_ & ~m, xj, xf)
                run = run + jnp.where(open_ & m, CPW, 0)
                open_ = open_ & m
            run = run + jnp.where(~open_, ctz_chars(xf), 0)
            adv = jnp.where(valid, jnp.minimum(run, caps), 0)
            knew = ksel + adv
            done = valid & ((run < KW2 * CPW) | (adv >= caps))
            new = jnp.stack(
                [jnp.where(valid, knew, ksel),
                 jnp.where(valid, (valid & ~done).astype(jnp.int32), ms_old)],
                axis=1)
            stacked = jnp.put_along_axis(stacked, sel2, new, axis=2,
                                         inplace=False)
            return stacked[:, 0], stacked[:, 1] != 0

        k, _ = lax.while_loop(cond2, body2, (k, miss))
        return k, ebase, exw, ebase2, exw2, stats

    def transition_values(src):
        """The 5-state dual-affine recurrence + 7-bit tb byte.

        Tie-break order is the parity contract (reference wf_next_tb,
        miniwfa.c:287-307): '>=' prefers gap-open over gap-extend, E1 over
        E2, F1 over F2, E over F, mismatch over any gap.
        """
        pHo1m, pE1m, pHo1p, pF1p = src["Ho1m"], src["E1m"], src["Ho1p"], src["F1p"]
        pHo2m, pE2m, pHo2p, pF2p = src["Ho2m"], src["E2m"], src["Ho2p"], src["F2p"]
        pHx = src["Hx"]
        bit08 = pHo1m < pE1m
        e1 = jnp.maximum(pHo1m, pE1m)
        bit20 = pHo2m < pE2m
        e2 = jnp.maximum(pHo2m, pE2m)
        ze = jnp.where(e1 >= e2, 1, 3)
        e = jnp.maximum(e1, e2)
        bit10 = pHo1p < pF1p
        f1 = jnp.maximum(pHo1p, pF1p) + 1
        bit40 = pHo2p < pF2p
        f2 = jnp.maximum(pHo2p, pF2p) + 1
        zf = jnp.where(f1 >= f2, 2, 4)
        f = jnp.maximum(f1, f2)
        z = jnp.where(e >= f, ze, zf)
        h = jnp.maximum(e, f)
        hx = pHx + 1
        z = jnp.where(hx >= h, 0, z)
        H = jnp.maximum(hx, h)
        bits = (bit08.astype(jnp.int32) << 3) | (bit10.astype(jnp.int32) << 4) \
             | (bit20.astype(jnp.int32) << 5) | (bit40.astype(jnp.int32) << 6) | z
        return H, e1, f1, e2, f2, bits

    def read_sources(st, planes, tops, t):
        """The seven shifted source windows for the transition into score
        t+1 (reference wf_next_prep, miniwfa.c:243-259).  Sources at age 1
        are the top registers (score t, post-extension for H); older ages
        read the ring, whose slots for this cycle's reads are all distinct
        from the slot being retired (mod t)."""
        def src(plane_i, age):
            if age == 1:
                return st[tops[plane_i]]
            return slice_at(st[planes[plane_i]], slot_of(t + 1 - age))
        hx = src(0, ages["x"])
        ho1 = src(0, ages["o1"])
        ho2 = src(0, ages["o2"])
        return dict(Hx=hx,
                    Ho1m=sh_m1(ho1), Ho1p=sh_p1(ho1),
                    Ho2m=sh_m1(ho2), Ho2p=sh_p1(ho2),
                    E1m=sh_m1(src(1, ages["e1"])), F1p=sh_p1(src(2, ages["e1"])),
                    E2m=sh_m1(src(3, ages["e2"])), F2p=sh_p1(src(4, ages["e2"])))

    def shrink(st, tl, ql, stale_slot):
        """Narrow [wf_lo, wf_hi] to the good-diagonal hull over all live
        slices (reference wf_stripe_shrink, miniwfa.c:144-171): the ring
        minus its one stale slot, plus the top registers."""
        d3 = st["anc"][:, None, None] + arW[None, None, :]
        gd = jnp.zeros((B, NS, W), dtype=bool)
        for nm in PLANES:
            v = st[nm]
            gd |= (v >= -1) & (v < tl[:, None, None]) \
                & (d3 + v >= -1) & (d3 + v < ql[:, None, None])
        in_sl = (d3 >= st["slice_lo"][:, :, None]) & (d3 <= st["slice_hi"][:, :, None])
        live = jnp.arange(NS, dtype=jnp.int32)[None, :, None] != stale_slot
        good = jnp.any(gd & in_sl & live, axis=1)              # [B, W]
        d = st["anc"][:, None] + arW[None, :]
        for nm in TOPS:
            v = st[nm]
            good |= ((v >= -1) & (v < tl[:, None]) & (d + v >= -1)
                     & (d + v < ql[:, None])
                     & (d >= st["top_lo"][:, None]) & (d <= st["top_hi"][:, None]))
        good &= (d >= st["wf_lo"][:, None]) & (d <= st["wf_hi"][:, None])
        has = jnp.any(good, axis=1)
        big = jnp.int32(0x3FFFFFFF)
        new_lo = jnp.min(jnp.where(good, d, big), axis=1)
        new_hi = jnp.max(jnp.where(good, d, -big), axis=1)
        return (jnp.where(has, new_lo, st["wf_lo"]),
                jnp.where(has, new_hi, st["wf_hi"]))

    def init_state(tl, ql):
        zero3 = lambda: jnp.full((B, NS, W), WF_NEG_INF, dtype=jnp.int32)
        zero2 = lambda: jnp.full((B, W), WF_NEG_INF, dtype=jnp.int32)
        st = {n: zero3() for n in PLANES}
        st.update({n: zero2() for n in TOPS})
        # score-0 top: H[d=0] = -1 (reference miniwfa.c:119)
        st["tH"] = st["tH"].at[:, W // 2].set(-1)
        st.update(
            # 2-way match-window cache (see extend_band); init = all-miss
            ebase=jnp.full((B, W), 0x3FFFFFFF, jnp.int32),
            ebase2=jnp.full((B, W), 0x3FFFFFFF, jnp.int32),
            **{f"ex{j}": jnp.zeros((B, W), jnp.int32) for j in range(spec.kw)},
            **{f"ex2_{j}": jnp.zeros((B, W), jnp.int32) for j in range(spec.kw)},
        )
        st.update(
            anc=jnp.full((B,), -(W // 2), jnp.int32),
            top_lo=jnp.zeros((B,), jnp.int32),
            top_hi=jnp.zeros((B,), jnp.int32),
            slice_lo=jnp.zeros((B, NS), jnp.int32),
            slice_hi=jnp.zeros((B, NS), jnp.int32),
            wf_lo=jnp.zeros((B,), jnp.int32),
            wf_hi=jnp.zeros((B,), jnp.int32),
            t=jnp.int32(0),
            done=jnp.zeros((B,), bool),
            stopped=jnp.zeros((B,), bool),
            overflow=jnp.zeros((B,), bool),
            final_s=jnp.full((B,), -1, jnp.int32),
            n_iter_lo=jnp.zeros((B,), jnp.int32),
            n_iter_hi=jnp.zeros((B,), jnp.int32),
            last_state=jnp.zeros((B,), jnp.int32),
            sid=jnp.zeros((B,), jnp.int32),
        )
        if is_tb:
            st["tb_bits"] = jnp.zeros((B, spec.S_CAP, W), jnp.uint8)
            st["tb_anc"] = jnp.zeros((B, spec.S_CAP), jnp.int32)
        if is_p1:
            st.update({n: zero3() for n in SF})
            st.update({n: zero2() for n in TOPSF})
            st["tHs"] = st["tHs"].at[:, W // 2].set(-1)  # origin pointer -1
            st.update(snap_x=jnp.zeros((B, spec.n_snap, NS * 5 * W), jnp.int32),
                      snap_anc=jnp.zeros((B, spec.n_snap), jnp.int32),
                      snap_cnt=jnp.zeros((B,), jnp.int32),
                      last_ptr=jnp.full((B,), WF_NEG_INF, jnp.int32))
        return st

    def reanchor(st):
        """Re-center every flagged lane's window by rolling its planes
        (the rare path; the band outgrew its slack)."""
        shift = st["ra_shift"]                    # [B], 0 for unflagged
        idx = arW[None, :] + shift[:, None]
        ok = (idx >= 0) & (idx < W)
        idxc = jnp.clip(idx, 0, W - 1)
        gidx3 = jnp.broadcast_to(idxc[:, None, :], (B, NS, W))
        ok3 = ok[:, None, :]
        st = dict(st)
        for nm in PLANES + (SF if is_p1 else ()):
            st[nm] = jnp.where(ok3, jnp.take_along_axis(st[nm], gidx3, axis=2), NEG)
        for nm in TOPS + (TOPSF if is_p1 else ()):
            st[nm] = jnp.where(ok, jnp.take_along_axis(st[nm], idxc, axis=1), NEG)
        # the match-window cache is per-diagonal: roll it too; rolled-in
        # slots are unknown -> all-miss
        for nm in ("ebase", "ebase2"):
            st[nm] = jnp.where(ok, jnp.take_along_axis(st[nm], idxc, axis=1),
                               0x3FFFFFFF)
        for j in range(KW):
            for nm in (f"ex{j}", f"ex2_{j}"):
                st[nm] = jnp.where(
                    ok, jnp.take_along_axis(st[nm], idxc, axis=1), 0)
        st["anc"] = st["anc"] + shift
        return st

    def snapshot(st):
        """Serialize the shadow (pointer) stripe and reset its cells to
        fresh flat indices (reference wf_snapshot1, miniwfa.c:451-474).

        Runs after the top slices retired into the ring, so the ring holds
        exactly the NS live slices (scores t-NS+1..t).  Flat encoding
        (matched by the host decoder): idx = (slot*5 + state)*W + w at the
        snapshot's recorded anchor; slot→score via s ≡ slot (mod NS).
        Rows are written at the global snapshot counter; lanes that
        terminated earlier keep snap_cnt frozen so their rows are ignored.

        INVARIANT: the unmasked snap_x/snap_anc writes below are safe only
        because the global row index (t+1)//step - 1 is monotone and
        n_snap = S_CAP//step + 2 >= every row ever written, so the row_w
        clip never wraps onto a terminated lane's last valid row; if the
        n_snap sizing changes, mask these writes with snap_act.
        """
        st = dict(st)
        t, act = st["t"], st["snap_act"]
        row = (t + 1) // spec.step - 1
        ok = row < spec.n_snap
        row_w = jnp.clip(row, 0, spec.n_snap - 1)
        block = jnp.stack([st[n] for n in SF], axis=2)   # [B, NS, 5, W]
        st["snap_x"] = lax.dynamic_update_slice(
            st["snap_x"], block.reshape(B, 1, NS * 5 * W), (0, row_w, 0))
        st["snap_anc"] = lax.dynamic_update_slice(
            st["snap_anc"], st["anc"][:, None], (0, row_w))
        # fresh pointers within each slice's band; NEG_INF elsewhere
        d3 = st["anc"][:, None, None] + arW[None, None, :]
        in_band = (d3 >= st["slice_lo"][:, :, None]) & (d3 <= st["slice_hi"][:, :, None])
        slots = jnp.arange(NS, dtype=jnp.int32)[None, :, None]
        amask = act[:, None, None]
        for si, nm in enumerate(SF):
            fresh = (slots * 5 + si) * W + arW[None, None, :]
            fresh = jnp.where(in_band, fresh, NEG)
            st[nm] = jnp.where(amask, fresh, st[nm])
        # the top sf registers (score t) were just retired at slot t%NS:
        # reset them to the same fresh indices so the next transition's
        # age-1 sources see post-snapshot pointers
        d = st["anc"][:, None] + arW[None, :]
        in_top = (d >= st["top_lo"][:, None]) & (d <= st["top_hi"][:, None])
        slot_t = slot_of(t)
        am = act[:, None]
        for si, nm in enumerate(TOPSF):
            fresh = (slot_t * 5 + si) * W + arW[None, :]
            fresh = jnp.where(in_top, fresh, NEG)
            st[nm] = jnp.where(am, fresh, st[nm])
        st["snap_cnt"] = jnp.where(act & ok, st["snap_cnt"] + 1, st["snap_cnt"])
        st["overflow"] = st["overflow"] | (act & ~ok)
        return st

    def cycle(st, tl, ql, seg_s, seg_d, n_seg):
        t = st["t"]
        act0 = ~(st["done"] | st["stopped"] | st["overflow"])

        # --- 1. extension over the top slice's own band (miniwfa.c:400-411)
        d = st["anc"][:, None] + arW[None, :]
        k_old = st["tH"]
        in_band = (d >= st["top_lo"][:, None]) & (d <= st["top_hi"][:, None])
        elig = in_band & (k_old >= -1) & (d + k_old >= -1) \
             & (k_old < tl[:, None]) & (d + k_old < ql[:, None])
        import os
        if os.environ.get("MWF_DBG_NOEXT"):  # perf debugging only
            k_new = k_old + jnp.where(elig, jnp.bitwise_and(k_old, 1), 0)
        else:
            exw_in = tuple(st[f"ex{j}"] for j in range(KW))
            exw2_in = tuple(st[f"ex2_{j}"] for j in range(KW))
            k_new, eb, exw, eb2, exw2, stats = extend_band(
                st["tqw"], tl, ql, k_old, d, elig, st["ebase"], exw_in,
                st["ebase2"], exw2_in)
            k_new = jnp.where(elig, k_new, k_old)
            st = dict(st)
            st["ebase"], st["ebase2"] = eb, eb2
            for j in range(KW):
                st[f"ex{j}"] = exw[j]
                st[f"ex2_{j}"] = exw2[j]
            if "ext_stats" in st and stats is not None:  # env-gated counters
                st["ext_stats"] = st["ext_stats"] + jnp.stack(stats)

        # --- 2. termination: only diagonal d_end = ql - tl can finish
        d_end = ql - tl
        at_end = elig & (d == d_end[:, None])
        term = act0 & jnp.any(at_end & (k_new == tl[:, None] - 1), axis=1)
        zero_ext = term & (t > 0) \
            & jnp.any(at_end & (k_new == k_old) & (k_new == tl[:, None] - 1), axis=1)
        last_state = st["last_state"]
        if is_tb:
            # zero-length final extension: seed traceback with the terminal
            # cell's fromState (reference miniwfa.c:405-408)
            row = jnp.clip(t - 1, 0, spec.S_CAP - 1)
            rbits = lax.dynamic_slice(st["tb_bits"], (0, row, 0), (B, 1, W))[:, 0]
            ranc = lax.dynamic_slice(st["tb_anc"], (0, row), (B, 1))[:, 0]
            col = jnp.clip(d_end - ranc, 0, W - 1)
            bits_at = jnp.take_along_axis(rbits.astype(jnp.int32),
                                          col[:, None], axis=1)[:, 0]
            last_state = jnp.where(zero_ext, bits_at & 7, last_state)
        st = dict(st)
        if is_p1:
            ptr = jnp.max(jnp.where(at_end, st["tHs"], NEG), axis=1)
            st["last_ptr"] = jnp.where(term, ptr, st["last_ptr"])

        st["tH"] = k_new
        st["done"] = st["done"] | term
        st["final_s"] = jnp.where(term, t, st["final_s"])
        st["last_state"] = last_state
        act = act0 & ~term

        # --- 3. pass-2 checkpoint collapse (miniwfa.c:413-416)
        wf_lo, wf_hi = st["wf_lo"], st["wf_hi"]
        if spec.use_seg:
            sid = st["sid"]
            cid = jnp.clip(sid, 0, spec.seg_cap - 1)[:, None]
            cur_s = jnp.take_along_axis(seg_s, cid, axis=1)[:, 0]
            cur_d = jnp.take_along_axis(seg_d, cid, axis=1)[:, 0]
            hit = act & (sid < n_seg) & (cur_s == t)
            wf_lo = jnp.where(hit, cur_d, wf_lo)
            wf_hi = jnp.where(hit, cur_d, wf_hi)
            st["sid"] = jnp.where(hit, sid + 1, sid)

        # --- 4. band growth, clamped to the matrix (miniwfa.c:417-418)
        lo = jnp.maximum(wf_lo - 1, -tl)
        hi = jnp.minimum(wf_hi + 1, ql)
        width = hi - lo + 1
        ovf = act & (width + 2 * GUARD > W)
        st["overflow"] = st["overflow"] | ovf
        act = act & ~ovf
        st["wf_lo"], st["wf_hi"] = wf_lo, wf_hi

        # --- 4b. rare re-anchor when the band nears a window edge
        import os
        need = act & ((lo < st["anc"]) | (hi > st["anc"] + W - 1))
        new_anc = jnp.clip(lo - (W - width) // 2, hi - W + 1, lo)
        st["ra_shift"] = jnp.where(need, new_anc - st["anc"], 0)
        if not os.environ.get("MWF_DBG_NOREANCHOR"):  # perf debugging only
            st = lax.cond(jnp.any(need), reanchor, lambda s: dict(s), st)
        del st["ra_shift"]
        d_w = st["anc"][:, None] + arW[None, :]

        # transition sources read BEFORE the retire write: ages >= 2 live in
        # ring slots written in earlier cycles; age 1 is the top registers.
        # (Read-before-write keeps XLA from materializing hazard copies.)
        src = read_sources(st, PLANES, TOPS, t)

        # --- 5. retire the top slices into the ring at slot t%NS (pure
        # insert: every ring read this cycle is at a different slot)
        slot_t = slot_of(t)
        for pn, tn in zip(PLANES, TOPS):
            st[pn] = write_at(st[pn], slot_t, st[tn])
        if is_p1:
            for pn, tn in zip(SF, TOPSF):
                st[pn] = write_at(st[pn], slot_t, st[tn])
        st["slice_lo"] = lax.dynamic_update_slice_in_dim(
            st["slice_lo"], st["top_lo"][:, None], slot_t, axis=1)
        st["slice_hi"] = lax.dynamic_update_slice_in_dim(
            st["slice_hi"], st["top_hi"][:, None], slot_t, axis=1)

        # --- 6. low-mem snapshot every `step` cycles (miniwfa.c:585-586);
        # masked per lane: a lane that terminated this very cycle must NOT
        # take the snapshot (the reference breaks first, miniwfa.c:576-586)
        if is_p1:
            st["snap_act"] = act
            st = lax.cond(jnp.mod(t + 1, spec.step) == 0, snapshot,
                          lambda s: dict(s), st)
            del st["snap_act"]

        # --- 7. transition into score t+1 (new top registers)
        in_new = (d_w >= lo[:, None]) & (d_w <= hi[:, None])
        Hn, E1n, F1n, E2n, F2n, bits = transition_values(src)
        vals = [jnp.where(in_new, v, NEG) for v in (Hn, E1n, F1n, E2n, F2n)]
        frozen = ~act
        for tn, v in zip(TOPS, vals):
            st[tn] = jnp.where(frozen[:, None], st[tn], v)

        if is_p1:
            ssrc = read_sources(st, SF, TOPSF, t)
            # propagate snapshot pointers along the just-chosen transitions
            # (reference wf_next_seg, miniwfa.c:495-523 — here fused with
            # the value recurrence, which the C couldn't vectorize fused)
            e1p = jnp.where(bits & 0x08 != 0, ssrc["E1m"], ssrc["Ho1m"])
            f1p = jnp.where(bits & 0x10 != 0, ssrc["F1p"], ssrc["Ho1p"])
            e2p = jnp.where(bits & 0x20 != 0, ssrc["E2m"], ssrc["Ho2m"])
            f2p = jnp.where(bits & 0x40 != 0, ssrc["F2p"], ssrc["Ho2p"])
            z = bits & 7
            hp = ssrc["Hx"]
            hp = jnp.where(z == 1, e1p, hp)
            hp = jnp.where(z == 2, f1p, hp)
            hp = jnp.where(z == 3, e2p, hp)
            hp = jnp.where(z == 4, f2p, hp)
            for tn, v in zip(TOPSF, (hp, e1p, f1p, e2p, f2p)):
                st[tn] = jnp.where(frozen[:, None], st[tn],
                                   jnp.where(in_new, v, NEG))

        st["top_lo"] = jnp.where(act, lo, st["top_lo"])
        st["top_hi"] = jnp.where(act, hi, st["top_hi"])

        if is_tb:
            row_t = jnp.clip(t, 0, spec.S_CAP - 1)
            st["tb_bits"] = lax.dynamic_update_slice(
                st["tb_bits"], jnp.where(in_new, bits, 0).astype(jnp.uint8)[:, None, :],
                (0, row_t, 0))
            st["tb_anc"] = lax.dynamic_update_slice(
                st["tb_anc"], st["anc"][:, None], (0, row_t))

        # boundary commit (miniwfa.c:325-326): the grown edge only joins the
        # band if some state there is viable
        viable = jnp.zeros((B, W), bool)
        for v in vals:
            viable |= v >= -1
        lo_ok = jnp.any(viable & (d_w == lo[:, None]), axis=1)
        hi_ok = jnp.any(viable & (d_w == hi[:, None]), axis=1)
        st["wf_lo"] = jnp.where(act & lo_ok, lo, st["wf_lo"])
        st["wf_hi"] = jnp.where(act & hi_ok, hi, st["wf_hi"])

        # --- 8. periodic shrink every 256 cycles (miniwfa.c:420, 588); the
        # ring slot for score t+1-NS is stale (superseded by the new top)
        def do_shrink(st):
            nlo, nhi = shrink(st, tl, ql, slot_of(t + 1))
            st = dict(st)
            st["wf_lo"] = jnp.where(act, nlo, st["wf_lo"])
            st["wf_hi"] = jnp.where(act, nhi, st["wf_hi"])
            return st

        if not os.environ.get("MWF_DBG_NOSHRINK"):  # perf debugging only
            st = lax.cond(((t + 1) & 0xFF) == 0, do_shrink, lambda s: dict(s), st)

        # --- 9. accounting + early stop (miniwfa.c:421-425); pass 1 has no
        # early stop (miniwfa.c:569-589)
        nlo = st["n_iter_lo"] + jnp.where(act, width, 0)
        nhi = st["n_iter_hi"] + (nlo >> 30)
        nlo = nlo & 0x3FFFFFFF
        st["n_iter_lo"], st["n_iter_hi"] = nlo, nhi
        if not is_p1:
            stop = jnp.zeros((B,), bool)
            if spec.max_iter > 0:  # exact 60-bit compare in (hi, lo) parts
                mi_hi, mi_lo = spec.max_iter >> 30, spec.max_iter & 0x3FFFFFFF
                stop |= (nhi > mi_hi) | ((nhi == mi_hi) & (nlo > mi_lo))
            if spec.max_s > 0:
                stop |= t + 1 > spec.max_s
            st["stopped"] = st["stopped"] | (act & stop)
        st["t"] = t + 1
        return st

    def run(t_words, q_words, tl, ql, seg_s, seg_d, n_seg):
        import os
        st = init_state(tl, ql)
        # packed sequences ride in the carry unchanged, pre-concatenated so
        # a miss round needs ONE combined gather for both sides
        st["tqw"] = jnp.concatenate([t_words, q_words], axis=1)
        if os.environ.get("MWF_DBG_EXTSTATS"):
            st["ext_stats"] = jnp.zeros((4,), jnp.int32)

        def cond(st):
            alive = ~(st["done"] | st["stopped"] | st["overflow"])
            return jnp.any(alive) & (st["t"] < spec.S_CAP - 1)

        st = lax.while_loop(cond, lambda s: cycle(s, tl, ql, seg_s, seg_d,
                                                  n_seg), st)
        # lanes still alive at the S_CAP budget are bucket overflows
        alive = ~(st["done"] | st["stopped"] | st["overflow"])
        out = dict(final_s=st["final_s"], done=st["done"], stopped=st["stopped"],
                   ovf_band=st["overflow"], ovf_scap=alive,
                   overflow=st["overflow"] | alive, last_state=st["last_state"],
                   n_iter_lo=st["n_iter_lo"], n_iter_hi=st["n_iter_hi"])
        if is_tb:
            out["tb_bits"] = st["tb_bits"]
            out["tb_anc"] = st["tb_anc"]
        if is_p1:
            out.update(snap_x=st["snap_x"], snap_anc=st["snap_anc"],
                       snap_cnt=st["snap_cnt"], last_ptr=st["last_ptr"])
        if "ext_stats" in st:
            out["ext_stats"] = st["ext_stats"]
        return out

    return run


@functools.lru_cache(maxsize=256)
def get_aligner(spec: WfSpec):
    """Jitted single-host aligner for a static spec."""
    return jax.jit(build_aligner(spec))


def _example_args(spec: WfSpec):
    """Abstract input signature for a spec (for eval_shape / entry points)."""
    sd = jax.ShapeDtypeStruct
    return (
        sd((spec.B, spec.cpw * spec.NWT), jnp.int32),
        sd((spec.B, spec.cpw * spec.NWQ), jnp.int32),
        sd((spec.B,), jnp.int32),
        sd((spec.B,), jnp.int32),
        sd((spec.B, spec.seg_cap), jnp.int32),
        sd((spec.B, spec.seg_cap), jnp.int32),
        sd((spec.B,), jnp.int32),
    )


@functools.lru_cache(maxsize=64)
def get_sharded_aligner(spec: WfSpec, mesh, axis: str = "data"):
    """The same machine SPMD over a device mesh: the batch axis is sharded
    across `axis` and every device runs its own while_loop over its own
    lanes (pure data parallelism — the scale-out strategy per SURVEY.md
    §2's parallelism inventory; no collective).  spec.B must be divisible
    by the axis size."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    local = spec.replace_b(spec.B // mesh.shape[axis])
    run = build_aligner(local)
    keys = jax.eval_shape(run, *_example_args(local)).keys()
    # check_vma off: the while-loop carry starts from unvarying constants
    # (init_state) and becomes device-varying after the first cycle, which
    # the strict VMA typecheck rejects; semantically the loop is per-shard
    fn = shard_map(run, mesh=mesh, in_specs=(P(axis),) * 7,
                   out_specs={k: P(axis) for k in keys}, check_vma=False)
    return jax.jit(fn)
