"""Sharded batch alignment: the pair stream split across a device mesh.

Each device gets B/n lanes of the batch and runs the full wavefront
while-loop on them independently (SPMD data parallelism within a host;
across hosts the same code runs under jax.distributed with a global
mesh).
Covers all exact modes: score, CIGAR, and the two-pass low-mem stripe
mode (sharded pass 1 -> per-lane checkpoint decode -> sharded pass 2
with band collapse).

Multi-process contract: small per-lane outputs (scores, flags, counters)
are all-gathered so every process returns them for EVERY pair; CIGARs
need the traceback buffer, which is only fetched for lanes whose shard is
addressable by this process — other lanes get ``cigar=None`` (callers
merge per-host outputs, e.g. tests/test_multiprocess.py).  Traceback and
snapshot buffers are fetched PER LANE (device-side slice), never as the
whole [B, S_CAP, W] global array.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..options import Options
from ..ops import pack
from ..ops.wavefront import (
    MODE_PASS1, MODE_SCORE, MODE_TB, WfSpec, get_sharded_aligner)
from ..models.exact import (
    Result, Seg, _band_limit_error, _buckets_for, _cpw_for, _escalate,
    _first_rung, _pass2_buckets, _tb_lane_cap, _w_cap, as_bytes)
from ..models import traceback as tbk


def _next_mult(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _allgather_small(out, keys):
    """Small per-lane outputs as host numpy on every process."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils as mh
        return {k: np.asarray(mh.process_allgather(out[k], tiled=True))
                for k in keys}
    # one device_get for all keys
    return jax.device_get({k: out[k] for k in keys})


def _lane_addressable(arr, j: int) -> bool:
    """True if lane j of the sharded array has a local shard."""
    if jax.process_count() == 1:
        return True
    for sh in arr.addressable_shards:
        idx = sh.index[0]
        lo = idx.start or 0
        hi = idx.stop if idx.stop is not None else arr.shape[0]
        if lo <= j < hi:
            return True
    return False


def _fetch_lane(arr, j: int, rows: int):
    """One lane's buffer rows, fetched from its LOCAL shard.

    Slicing the global array (arr[j]) would dispatch a computation over
    the distributed array — and because each process fetches different
    lanes, the per-process programs diverge and the cross-process
    collectives mismatch.  Reading the addressable shard's single-device
    data is purely local."""
    for sh in arr.addressable_shards:
        idx0 = sh.index[0]
        lo = idx0.start or 0
        hi = idx0.stop if idx0.stop is not None else arr.shape[0]
        if lo <= j < hi:
            return np.asarray(sh.data[j - lo, :rows])
    raise KeyError(f"lane {j} has no addressable shard")


def _sync_segs(segs: List[Optional[Seg]]) -> List[Seg]:
    """Exchange per-lane checkpoint lists so every process holds the same
    global list (pass-2 inputs must be identical across processes — SPMD).
    Lanes decoded locally carry a list; unowned lanes carry None."""
    from jax.experimental import multihost_utils as mh
    n = len(segs)
    local_cap = max((len(s) for s in segs if s is not None), default=0)
    cap = int(np.max(mh.process_allgather(
        np.array([local_cap], np.int32)))) or 1
    arr = np.zeros((n, cap, 2), np.int32)
    own = np.zeros((n,), np.int32)
    cnt = np.zeros((n,), np.int32)
    for i, sg in enumerate(segs):
        if sg is None:
            continue
        own[i] = 1
        cnt[i] = len(sg)
        for k, (s, d) in enumerate(sg):
            arr[i, k] = (s, d)
    g_arr = mh.process_allgather(arr)       # [P, n, cap, 2]
    g_own = mh.process_allgather(own)       # [P, n]
    g_cnt = mh.process_allgather(cnt)
    out: List[Seg] = []
    for i in range(n):
        owners = np.nonzero(g_own[:, i])[0]
        assert owners.size, f"lane {i} decoded by no process"
        p = int(owners[0])
        out.append([(int(s), int(d))
                    for s, d in g_arr[p, i, :int(g_cnt[p, i])]])
    return out


def _next_rung(opt: Options, mode: int, bk, sm, n_rows: int, w_cap: int):
    """The rung after an overflow: band window and/or cycle budget x4
    (the window within the device cap), as the single-device driver
    escalates; a band already at its cap raises the band-limit error."""
    need_band = bool(sm["ovf_band"][:n_rows].any())
    if need_band and bk.W >= min(bk.W_full, w_cap):
        raise _band_limit_error(opt, mode, bk.W, w_cap)
    bk = _escalate(bk, need_band, bool(sm["ovf_scap"][:n_rows].any()))
    return replace(bk, W=min(bk.W, w_cap))


def _run_sharded(opt: Options, mode: int, bk, mesh, axis, ts_list, qs_list,
                 idx, segs=None):
    from ..utils import hbm
    B = _next_mult(max(1, len(idx)), mesh.shape[axis])
    use_seg = segs is not None and any(segs[i] for i in idx)
    seg_cap = max((len(segs[i]) for i in idx if segs[i]), default=0) + 1 \
        if use_seg else 1
    spec = WfSpec(
        B=B, W=bk.W, S_CAP=bk.S_CAP, LT=bk.LT, LQ=bk.LQ,
        x=opt.x, o1=opt.o1, e1=opt.e1, o2=opt.o2, e2=opt.e2,
        mode=mode, cpw=_cpw_for(ts_list, qs_list),
        step=opt.step if mode == MODE_PASS1 else 0,
        n_snap=(bk.S_CAP // opt.step + 2) if mode == MODE_PASS1 else 0,
        seg_cap=seg_cap, use_seg=use_seg,
        max_s=opt.max_s if mode != MODE_PASS1 else 0,
        max_iter=opt.max_iter if mode != MODE_PASS1 else 0)
    fn = get_sharded_aligner(spec, mesh, axis)
    pad_t = [ts_list[i] for i in idx] + [b""] * (B - len(idx))
    pad_q = [qs_list[i] for i in idx] + [b""] * (B - len(idx))
    seg_s = np.full((B, seg_cap), -9, np.int32)
    seg_d = np.zeros((B, seg_cap), np.int32)
    n_seg = np.zeros((B,), np.int32)
    if use_seg:
        for row, i in enumerate(idx):
            sg = segs[i]
            if sg:
                seg_s[row, :len(sg)] = [s for s, _ in sg]
                seg_d[row, :len(sg)] = [d for _, d in sg]
                n_seg[row] = len(sg)
    shard = NamedSharding(mesh, P(axis))
    args = (
        pack.pack_ways(pad_t, bk.LT, spec.cpw),
        pack.pack_ways(pad_q, bk.LQ, spec.cpw),
        np.array([len(t) for t in pad_t], np.int32),
        np.array([len(q) for q in pad_q], np.int32),
        seg_s, seg_d, n_seg,
    )
    args = tuple(jax.device_put(a, shard) for a in args)
    out = fn(*args)
    hbm.note_arrays(f"sharded mode={mode} B={B} W={bk.W} "
                    f"S_CAP={bk.S_CAP}",
                    dict(out), spec=spec)
    return out, spec


def align_batch_sharded(pairs: Sequence[Tuple[object, object]], opt: Options,
                        mesh: Mesh, *, w0: int = 512, s0: int = 512,
                        axis: str = "data") -> List[Optional[Result]]:
    """Batch alignment sharded over a mesh (score, CIGAR or low-mem mode).

    Lanes shard across the mesh axis; every device runs its own wavefront
    while-loop; scores/flags come back for every pair on every process,
    CIGARs for pairs with a locally-addressable shard (None otherwise).
    The band window and traceback lane budgets are the single-device
    driver's (models/exact.py), applied per device."""
    ts_list = [as_bytes(t) for t, _ in pairs]
    qs_list = [as_bytes(q) for _, q in pairs]
    n = len(pairs)
    if n == 0:
        return []

    # --- single-device mesh: shard_map adds per-call overhead and a
    # separate compile-cache population without adding any parallelism.
    # Route straight to the local driver — identical results by
    # construction; the sharded machinery stays covered by the
    # multi-device mesh tests (tests/test_sharding.py).
    if mesh.devices.size == 1 and jax.process_count() == 1:
        from ..models.exact import align_batch
        dev = list(mesh.devices.flat)[0]
        with jax.default_device(dev):
            return list(align_batch(pairs, opt, w0=w0, s0=s0))

    bk = _buckets_for(opt, ts_list, qs_list, w0, s0)
    mode = MODE_TB if opt.cigar else MODE_SCORE
    bk, w_cap = _first_rung(opt, mode, bk)
    results: List[Optional[Result]] = [None] * n
    ns = opt.max_pen + 1
    ndev = mesh.shape[axis]

    # --- low-mem pass 1 (sharded): per-pair checkpoint lists
    segs: Optional[List[Optional[Seg]]] = None
    s_p1: List[Optional[int]] = [None] * n
    if opt.step > 0 and opt.cigar:
        segs = [None] * n
        idx = list(range(n))
        w_cap1 = _w_cap(opt, MODE_PASS1)
        p1_bk = replace(bk, W=min(bk.W, w_cap1))
        while idx:
            out, spec = _run_sharded(opt, MODE_PASS1, p1_bk, mesh, axis,
                                     ts_list, qs_list, idx)
            sm = _allgather_small(out, ["overflow", "ovf_band", "ovf_scap",
                                        "snap_cnt", "last_ptr", "final_s"])
            snap_arr = out["snap_x"]
            retry = []
            for row, i in enumerate(idx):
                if sm["overflow"][row]:
                    retry.append(i)
                    continue
                s_p1[i] = int(sm["final_s"][row])
                if not _lane_addressable(snap_arr, row):
                    continue   # decoded by the owning process; synced below
                snap_row = _fetch_lane(snap_arr, row, snap_arr.shape[1])
                anc_row = _fetch_lane(out["snap_anc"], row,
                                      out["snap_anc"].shape[1])
                segs[i] = tbk.decode_checkpoints(
                    snap_row, anc_row, int(sm["snap_cnt"][row]),
                    int(sm["last_ptr"][row]), ns, spec.W, opt.step)
            if retry:
                p1_bk = _next_rung(opt, MODE_PASS1, p1_bk, sm, len(idx),
                                   w_cap1)
            out = None
            idx = retry
        if jax.process_count() > 1:
            segs = _sync_segs(segs)
        bk = _pass2_buckets(opt, bk, s_p1, ts_list, qs_list)

    # --- main pass (score / tb; tb doubles as low-mem pass 2)
    idx = list(range(n))
    while idx:
        cap = len(idx)
        if mode == MODE_TB:
            # the single-device lane budget, per DEVICE: each holds
            # len(idx)/ndev lanes of the B*S_CAP*W-byte tb buffer
            cap = _tb_lane_cap(opt, mode, bk, w_cap) * ndev
        chunk, idx_rest = idx[:cap], idx[cap:]
        idx = chunk
        out, spec = _run_sharded(opt, mode, bk, mesh, axis, ts_list,
                                 qs_list, idx, segs)
        sm = _allgather_small(out, ["overflow", "ovf_band", "ovf_scap",
                                    "stopped", "final_s", "n_iter_lo",
                                    "n_iter_hi", "last_state"])
        retry = []
        for row, i in enumerate(idx):
            if sm["overflow"][row]:
                retry.append(i)
                continue
            n_iter = (int(sm["n_iter_hi"][row]) << 30) | \
                int(sm["n_iter_lo"][row])
            if sm["stopped"][row]:
                results[i] = Result(s=-1, cigar=None, n_iter=n_iter)
                continue
            s_fin = int(sm["final_s"][row])
            cig = None
            if opt.cigar and _lane_addressable(out["tb_bits"], row):
                rows = max(s_fin, 1)
                tb_row = _fetch_lane(out["tb_bits"], row, rows)
                anc_row = _fetch_lane(out["tb_anc"], row, rows)
                cig = tbk.traceback_walk(opt, tb_row, anc_row, 0,
                                         ts_list[i], qs_list[i], s_fin,
                                         int(sm["last_state"][row]))
            results[i] = Result(s=s_fin, cigar=cig, n_iter=n_iter)
        out = None
        if retry:
            bk = _next_rung(opt, mode, bk, sm, len(idx), w_cap)
        idx = retry + idx_rest
    return results
