#!/usr/bin/env python3
"""Self-validating throughput benchmark on synthetic diverged pairs.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.

Headline metric: wavefront cells/s, one GPU, on 100 kb 2%-diverged
pairs in exact score mode — the reference's own throughput unit
(r->n_iter per second; BASELINE.md: single-core C ≈ 2.3e8 cells/s on the
same workload).  vs_baseline = value / 2.3e8.

Every row asserts parity against reference-binary goldens committed in
tests/data/bench_goldens.json (generated by tools/make_bench_goldens.py
from the C oracle): scores for every pair, plus a CIGAR digest and a
low-mem == high-mem cross-check for every pair.  ``parity`` in the
detail is the AND of all checks — a benchmark number with parity=false is
meaningless and the run exits non-zero.

Env knobs: MWF_BENCH_N, MWF_BENCH_B, MWF_BENCH_REPS.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import sys
import time

BASELINE_CELLS_PER_S = 2.3e8  # single-core C reference (BASELINE.md)


def mutate(rng: random.Random, seq: str, sub: float, ind: float,
           max_indel: int = 8) -> str:
    out = []
    bases = "ACGT"
    i, n = 0, len(seq)
    while i < n:
        if rng.random() < ind:
            if rng.random() < 0.5:
                i += rng.randint(1, max_indel)
                continue
            out.append("".join(rng.choice(bases)
                               for _ in range(rng.randint(1, max_indel))))
        c = seq[i]
        if rng.random() < sub:
            c = rng.choice([b for b in bases if b != c])
        out.append(c)
        i += 1
    return "".join(out)


def make_pairs(n: int, b: int, seed: int = 7):
    rng = random.Random(seed)
    pairs = []
    for _ in range(b):
        t = "".join(rng.choice("ACGT") for _ in range(n))
        q = mutate(rng, t, sub=0.02, ind=0.002)
        pairs.append((t, q))
    return pairs


def main() -> int:
    n = int(os.environ.get("MWF_BENCH_N", 100_000))
    # B=16 is the deployment shape (batched pair streams amortize the
    # per-pass fixed costs: walk fetch, RPCs, host decode); the low-mem
    # bar claim is made at THIS default shape
    b = int(os.environ.get("MWF_BENCH_B", 16))
    reps = int(os.environ.get("MWF_BENCH_REPS", 3))

    import jax
    if jax.default_backend() != "gpu":
        print(f"bench: measures the GPU, JAX backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1
    from miniwfa_tpu import Options
    from miniwfa_tpu.models.exact import align_batch
    from miniwfa_tpu.utils import hbm
    from miniwfa_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    hbm.reset()

    gpath = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "data", "bench_goldens.json")
    goldens = json.load(open(gpath)) if os.path.exists(gpath) else {}
    gold = goldens.get(str(n), [])

    pairs = make_pairs(n, b)
    opt = Options()  # score-only exact mode: the fundamental hot path
    w0 = s0 = max(1024, n // 4)  # start near the terminal bucket
    parity = True
    checks = {}

    # warmup: compile + first run; check scores vs the C oracle's
    res = align_batch(pairs, opt, w0=w0, s0=s0)
    if gold:
        ok = all(r.s == g["s"] for r, g in zip(res, gold))
        checks["score_parity"] = ok
        parity &= ok
    else:
        checks["score_parity"] = None

    t0 = time.perf_counter()
    for _ in range(reps):
        res = align_batch(pairs, opt, w0=w0, s0=s0)
    dt = (time.perf_counter() - t0) / reps
    total_cells = sum(r.n_iter for r in res)
    cells_per_s = total_cells / dt
    bp = sum(min(len(t), len(q)) for t, q in pairs)

    # CIGAR row over the FULL batch: score parity on every pair, digest
    # parity where the C oracle recorded one, + cells/s in tb mode
    tb_cells = tb_dt = None
    cres = None
    if gold:
        copt = Options(cigar=True)
        cres = align_batch(pairs, copt, w0=w0, s0=s0)  # warmup/compile
        t0 = time.perf_counter()
        cres = align_batch(pairs, copt, w0=w0, s0=s0)
        tb_dt = time.perf_counter() - t0
        tb_cells = sum(r.n_iter for r in cres)
        ok = all(r.s == g["s"] for r, g in zip(cres, gold))
        for r, g in zip(cres, gold):
            if "cigar_md5" in g:
                md5 = hashlib.md5(r.cigar_str.encode()).hexdigest()
                ok &= md5 == g["cigar_md5"]
        checks["cigar_parity"] = ok
        parity &= ok

    # low-mem row (two-pass stripe mode, reference -cp5000) over the
    # FULL batch: every pair must reproduce the high-mem CIGAR
    # bit-for-bit (the reference's own mode cross-check, SURVEY.md §4)
    lm_cells = lm_dt = None
    if gold and cres is not None:
        lopt = Options(cigar=True, step=5000)
        lres = align_batch(pairs, lopt, w0=w0, s0=s0)  # warmup/compile
        t0 = time.perf_counter()
        lres = align_batch(pairs, lopt, w0=w0, s0=s0)
        lm_dt = time.perf_counter() - t0
        lm_cells = sum(r.n_iter for r in lres)
        ok = all(lr.s == cr.s and lr.cigar_str == cr.cigar_str
                 for lr, cr in zip(lres, cres))
        checks["lowmem_parity"] = ok
        parity &= ok

    # scale row: same workload shape at 2x the pair length (score mode,
    # self-checked against the 100 kb-validated engine via low-mem
    # cross-run below at n=100k only); shows the band-proportional
    # engine's throughput growth with live band width
    big_cells = None
    bn = int(os.environ.get("MWF_BENCH_BIG_N", 200_000))
    if bn:
        bpairs = make_pairs(bn, 2, seed=13)
        bres = align_batch(bpairs, opt, w0=bn // 4, s0=bn // 4)  # warm
        t0 = time.perf_counter()
        bres = align_batch(bpairs, opt, w0=bn // 4, s0=bn // 4)
        bdt = time.perf_counter() - t0
        big_cells = round(sum(r.n_iter for r in bres) / bdt)

    out = {
        "metric": "wavefront_cells_per_s_1chip",
        "value": round(cells_per_s),
        "unit": "cells/s",
        "vs_baseline": round(cells_per_s / BASELINE_CELLS_PER_S, 3),
        "detail": {
            "device": {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())},
            "pairs": b, "pair_bp": n, "reps": reps,
            "batch_wall_s": round(dt, 4),
            "total_cells": total_cells,
            "aligned_bp_per_s": round(bp / dt),
            "cigar_cells_per_s": round(tb_cells / tb_dt) if tb_dt else None,
            "lowmem_cells_per_s": round(lm_cells / lm_dt) if lm_dt else None,
            "score_cells_per_s_at_2x_bp": big_cells,
            "parity": parity,
            "checks": checks,
            # km_stat analog: the largest single-dispatch device buffer
            # footprint seen across every row above
            "peak_hbm": hbm.snapshot(),
        },
    }
    print(json.dumps(out))
    return 0 if parity else 1


if __name__ == "__main__":
    sys.exit(main())
