#!/usr/bin/env python3
"""Per-cycle time and device idle share of the lax engine on the GPU.

Measures what a hand-written kernel would have to beat:

1. batch100k score: the final ladder rung of the 16 x 100 kb bench batch
   (bench.make_pairs, seed 7; B=16, W=32768, the full score budget) as
   one dispatch: run once to warm it, then wall / loop cycles of the
   second run; a third run is traced for one second from 30 % of its
   wall (the late cycles, where the band is full).
2. a width sweep: B=16 dispatches of the same pairs capped at S_CAP=256
   cycles, at W = 1024 .. 131072 in score mode and 1024 .. 65536 in TB
   mode (the shapes the removed Pallas engines served), each timed and
   traced whole with jax.profiler: device busy and idle share of the
   dispatch window, device time and kernels per cycle, top kernels.
3. chain gap fills: align_chain_batch on the div100k scale fixture,
   warm wall and traced idle share.

Fails off the GPU.  Prints one line per measurement and writes the
summary as JSON to --out (default build/trace_engine.json).

  python3 tools/trace_engine.py [--out FILE] [--parts final,sweep,chain]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def merge_busy(intervals):
    """Total length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def device_events(logdir, plane_prefix="/device:"):
    """(start_ns, end_ns, name) of every kernel on the device planes of
    the trace in ``logdir``, plus a description of the planes' lines."""
    import jax
    paths = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise RuntimeError(f"no xplane.pb under {logdir}")
    prof = jax.profiler.ProfileData.from_file(paths[0])
    by_line, lines_seen = {}, []
    for plane in prof.planes:
        if not plane.name.startswith(plane_prefix) or \
                plane.name.startswith("/device:CPU"):
            continue
        for line in plane.lines:
            evs = [(e.start_ns, e.end_ns, e.name) for e in line.events]
            lines_seen.append(f"{plane.name}|{line.name}|{len(evs)}")
            by_line[(plane.name, line.name)] = evs
    # stream lines carry the kernels; summary lines (modules, ops) would
    # double-count them — use them only when there is no stream line
    streams = [k for k in by_line if k[1].startswith("Stream")]
    events = [e for k in (streams or list(by_line)) for e in by_line[k]]
    return events, lines_seen


def reduce_trace(logdir, cycles):
    """Device busy/idle share over the window from the first to the last
    kernel, and per-cycle figures for ``cycles`` loop cycles in it."""
    evs, lines = device_events(logdir)
    if not evs:
        import jax
        paths = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                          recursive=True)
        planes = [(p.name, [ln.name for ln in p.lines]) for p in
                  jax.profiler.ProfileData.from_file(paths[0]).planes]
        raise RuntimeError(f"no GPU kernel events; planes: {planes}")
    t0 = min(s for s, _, _ in evs)
    t1 = max(e for _, e, _ in evs)
    busy = merge_busy([(s, e) for s, e, _ in evs])
    by_name = {}
    for s, e, n in evs:
        d = by_name.setdefault(n, [0, 0])
        d[0] += e - s
        d[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "window_ns": t1 - t0, "busy_ns": busy,
        "idle_share": 1 - busy / (t1 - t0),
        "kernels": len(evs), "kernels_per_cycle": len(evs) / cycles,
        "device_ns_per_cycle": busy / cycles,
        "top_kernels": [{"name": n[:90], "ns": d[0], "count": d[1]}
                        for n, d in top],
        "lines": lines,
    }


def dispatch(opt, mode, bk, ts, qs):
    """One engine dispatch, blocked on; returns (out, wall_s)."""
    import jax
    from miniwfa_tpu.models import exact
    t0 = time.perf_counter()
    out, _ = exact._run_device(opt, mode, bk, ts, qs)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def traced(fn, cycles):
    import jax
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            fn()
        return reduce_trace(d, cycles)


def traced_window(fn, delay_s, span_s, s_per_cycle):
    """Run ``fn`` on a worker thread and trace [delay_s, delay_s+span_s)
    of it from this one: a window inside one long dispatch."""
    import threading
    import jax
    th = threading.Thread(target=fn)
    with tempfile.TemporaryDirectory() as d:
        th.start()
        time.sleep(delay_s)
        jax.profiler.start_trace(d)
        time.sleep(span_s)
        jax.profiler.stop_trace()
        th.join()
        return reduce_trace(d, max(1.0, span_s / s_per_cycle))


PARTS = ("final", "sweep", "chain")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "trace_engine.json"))
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated subset of " + ",".join(PARTS))
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))

    import jax
    import numpy as np
    if jax.default_backend() != "gpu":
        print(f"trace_engine: needs a GPU, backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1
    import bench
    from miniwfa_tpu import Options
    from miniwfa_tpu.models import exact
    from miniwfa_tpu.models.chain import align_chain_batch
    from miniwfa_tpu.ops.wavefront import MODE_SCORE, MODE_TB
    from miniwfa_tpu.utils.cache import enable_compile_cache
    from tools.make_scale_goldens import gen_case
    enable_compile_cache()
    dev = jax.devices()[0]
    summary = {"device_kind": dev.device_kind}
    print(f"device: {dev.device_kind}", flush=True)

    failed = []
    # --- 1. batch100k score, final bucket: warm, timed, late window traced
    pairs = [(t.encode(), q.encode())
             for t, q in bench.make_pairs(100_000, 16, seed=7)]
    ts, qs = [t for t, _ in pairs], [q for _, q in pairs]
    opt = Options()
    # the final rung of align_batch's ladder for this batch in score mode
    # (the one that completes every lane; chip_smoke's MWF_PROF lines)
    bk, _ = exact._first_rung(opt, MODE_SCORE,
                              exact._buckets_for(opt, ts, qs, 32768, 0))
    if "final" in parts:
        out, first = dispatch(opt, MODE_SCORE, bk, ts, qs)   # compile, warm
        if bool(np.asarray(out["overflow"]).any()):
            raise RuntimeError("W=32768 no longer completes batch100k")
        cycles = int(np.asarray(out["final_s"]).max()) + 1
        wall = dispatch(opt, MODE_SCORE, bk, ts, qs)[1]
        row = {"B": bk.B, "W": bk.W, "S_CAP": bk.S_CAP, "cycles": cycles,
               "first_wall_s": first, "wall_s": wall,
               "wall_us_per_cycle": wall / cycles * 1e6}
        print(f"batch100k score final dispatch B={bk.B} W={bk.W} "
              f"cycles={cycles} first={first:.3f}s warm={wall:.3f}s "
              f"wall/cycle={row['wall_us_per_cycle']:.2f}us", flush=True)
        # a third run, traced for span_s from 30 % of the warm wall: the
        # late cycles, which a whole-run trace could not hold
        span = 1.0
        summary["batch100k_score_final_dispatch"] = row
        try:
            tr = traced_window(
                lambda: dispatch(opt, MODE_SCORE, bk, ts, qs),
                0.3 * wall, span, wall / cycles)
        except RuntimeError as e:     # keep the walls; report the trace
            failed.append(f"late window: {e}")
            print(f"batch100k score late window trace failed: {e}",
                  flush=True)
        else:
            row["late_window"] = {k: tr[k] for k in (
                "window_ns", "busy_ns", "idle_share", "kernels",
                "top_kernels")}
            print(f"batch100k score late window ({span:.1f}s from "
                  f"{0.3 * wall:.1f}s): idle_share={tr['idle_share']:.4f} "
                  f"busy={tr['busy_ns'] / 1e6:.1f}ms "
                  f"window={tr['window_ns'] / 1e6:.1f}ms "
                  f"kernels={tr['kernels']}", flush=True)
            for k in tr["top_kernels"]:
                print(f"    {k['ns'] / 1e6:10.3f} ms {k['count']:7d}x "
                      f"{k['name']}", flush=True)

    # --- 2. width sweep at the removed engines' shapes
    sweep = []
    LT = LQ = 131072
    for mode, widths in ((MODE_SCORE,
                          (1024, 4096, 16384, 32768, 65536, 131072)),
                         (MODE_TB, (1024, 4096, 16384, 65536))):
        if "sweep" not in parts:
            break
        for W in widths:
            sbk = exact._Buckets(16, LT, LQ, W, 256, W, 256)
            o = Options(cigar=mode == MODE_TB)
            dispatch(o, mode, sbk, ts, qs)           # compile + warm
            ws = [dispatch(o, mode, sbk, ts, qs)[1] for _ in range(2)]
            cyc = 255          # the loop stops at t = S_CAP - 1
            try:
                tr = traced(lambda: dispatch(o, mode, sbk, ts, qs), cyc)
            except RuntimeError as e:   # keep the walls; report the trace
                failed.append(f"W={W}: {e}")
                print(f"sweep W={W} walls={ws} trace failed: {e}",
                      flush=True)
                continue
            r = {"mode": "tb" if mode == MODE_TB else "score", "B": 16,
                 "W": W, "cycles": cyc, "walls_s": ws,
                 "wall_us_per_cycle": min(ws) / cyc * 1e6,
                 "device_us_per_cycle": tr["device_ns_per_cycle"] / 1e3,
                 "idle_share": tr["idle_share"],
                 "kernels_per_cycle": tr["kernels_per_cycle"],
                 "top_kernel": tr["top_kernels"][0],
                 "top_kernels": tr["top_kernels"]}
            sweep.append(r)
            print(f"sweep {r['mode']:5s} W={W:6d} "
                  f"wall/cycle={r['wall_us_per_cycle']:9.2f}us "
                  f"device/cycle={r['device_us_per_cycle']:9.2f}us "
                  f"idle_share={r['idle_share']:.4f} "
                  f"kernels/cycle={r['kernels_per_cycle']:.1f} "
                  f"top={r['top_kernel']['name'][:50]}", flush=True)
            if W == 32768:
                for k in tr["top_kernels"]:
                    print(f"    {k['ns'] / 1e6:10.3f} ms {k['count']:7d}x "
                          f"{k['name']}", flush=True)
                print(f"    trace lines: {tr['lines']}", flush=True)
    summary["sweep"] = sweep

    # --- 3. chain gap fills (div100k)
    if "chain" not in parts:
        return finish(summary, args.out, failed)
    t, q = gen_case("div100k")
    copt = Options(cigar=True)
    align_chain_batch([(t, q)], copt)                # compile + warm
    t0 = time.perf_counter()
    res = align_chain_batch([(t, q)], copt)
    cw = time.perf_counter() - t0
    summary["chain_div100k"] = {"wall_s": cw, "s": res[0].s,
                                "n_iter": res[0].n_iter}
    print(f"chain div100k warm wall={cw:.3f}s s={res[0].s}", flush=True)
    try:
        tr = traced(lambda: align_chain_batch([(t, q)], copt), 1)
        summary["chain_div100k"].update(
            idle_share=tr["idle_share"], kernels=tr["kernels"],
            busy_ns=tr["busy_ns"], window_ns=tr["window_ns"])
        print(f"chain div100k idle_share={tr['idle_share']:.4f} "
              f"kernels={tr['kernels']} busy={tr['busy_ns'] / 1e6:.1f}ms "
              f"window={tr['window_ns'] / 1e6:.1f}ms", flush=True)
    except RuntimeError as e:
        failed.append(f"chain: {e}")
        print(f"chain div100k trace failed: {e}", flush=True)

    return finish(summary, args.out, failed)


def finish(summary, out, failed) -> int:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"summary -> {out}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
