#!/usr/bin/env python3
"""Smoke run of the exact aligner on one NVIDIA GPU (or four, --multi).

Drives the public entry points once at real size and checks every result
against goldens recorded from the reference binary.  Integers only: a
score, CIGAR (string or md5) or n_iter that differs by anything fails.

Phases (all by default; ``--phases a,b`` runs a subset):

  device     backend must be "gpu"; prints device kind/count, the card's
             name and power limit (nvidia-smi) and whether the native host
             runtime (traceback walker, k-mer chain) loaded
  corpus     tests/data/goldens.json through align_batch in score, CIGAR
             and low-mem p16 modes, plus the n_iter subset
  batch100k  16 x 100 kb pairs at 2 % divergence (bench.make_pairs, seed 7)
             in score, CIGAR and low-mem p5000 modes vs
             tests/data/bench_goldens.json; cold/warm walls, compiles,
             cells/s, device peak memory, memory_analysis of the largest
             traceback spec
  heuristic  div100k through align_chain_batch and align_auto_batch,
             sv300k through align_chain_batch (tools/make_scale_goldens
             .gen_case) vs tests/data/scale_goldens.json
  cli        the t3 corpus case through miniwfa_tpu.cli.main in-process
             with -c, -c -p 32 and -u -c

``--multi`` runs only the four-card path: the batch100k pairs through
align_batch_sharded on a 1-D mesh of four cards in score, CIGAR and
low-mem modes, and align_batch of the same batch on one card in score
mode for the ratio (printed, not gated), plus every card's peak memory.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
It is printed only when every phase passed.  Usage:

  python3 chip_smoke.py [--phases device,batch100k] [--multi]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "corpus", "batch100k", "heuristic", "cli")
DATA = os.path.join(ROOT, "tests", "data")


class Mismatch(AssertionError):
    """A result differs from its golden."""


def _load(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def md5(s: str) -> str:
    return hashlib.md5(s.encode()).hexdigest()


def compare(tag, results, wants, *, cigar=None, n_iter=False):
    """Golden comparator.  ``wants`` holds one dict per result with an
    integer ``s`` and optionally ``cigar`` / ``cigar_md5`` / ``n_iter``.
    ``cigar`` selects "str" or "md5" checking (None: score only).
    Returns the number of results checked; raises Mismatch listing every
    difference."""
    if len(results) != len(wants):
        raise Mismatch(f"{tag}: {len(results)} results for "
                       f"{len(wants)} goldens")
    bad = []
    for j, (r, w) in enumerate(zip(results, wants)):
        if r.s != w["s"]:
            bad.append(f"{tag}[{j}]: s={r.s} want {w['s']}")
            continue
        if cigar == "str" and w.get("cigar") is not None and \
                r.cigar_str != w["cigar"]:
            bad.append(f"{tag}[{j}]: cigar {str(r.cigar_str)[:60]} "
                       f"want {w['cigar'][:60]}")
        if cigar == "md5" and w.get("cigar_md5") is not None and \
                (r.cigar_str is None or md5(r.cigar_str) != w["cigar_md5"]):
            bad.append(f"{tag}[{j}]: cigar md5 "
                       f"{r.cigar_str and md5(r.cigar_str)} "
                       f"want {w['cigar_md5']}")
        if n_iter and r.n_iter != w["n_iter"]:
            bad.append(f"{tag}[{j}]: n_iter={r.n_iter} want {w['n_iter']}")
    if bad:
        raise Mismatch("\n".join(bad[:20]))
    return len(results)


def compare_same(tag, got, ref, *, fields=("s", "cigar_str")):
    """Two result lists must agree field by field (e.g. low-mem vs
    high-mem CIGAR, sharded vs single-card)."""
    bad = [f"{tag}[{j}]: {f} {getattr(a, f)!r:.60} != {getattr(b, f)!r:.60}"
           for j, (a, b) in enumerate(zip(got, ref)) for f in fields
           if getattr(a, f) != getattr(b, f)]
    if len(got) != len(ref):
        bad.append(f"{tag}: {len(got)} results vs {len(ref)}")
    if bad:
        raise Mismatch("\n".join(bad[:20]))


class Compiles:
    """Counts XLA backend compiles (persistent-cache hits are not
    compiles) through jax.monitoring."""

    def __init__(self):
        import jax
        self.n = 0
        self.secs = 0.0

        def on_event(event, secs, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.n += 1
                self.secs += secs
        jax.monitoring.register_event_duration_secs_listener(on_event)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, time.perf_counter() - t0


def mem_line(dev) -> str:
    st = dev.memory_stats() or {}
    return (f"peak_bytes_in_use={st.get('peak_bytes_in_use')} "
            f"bytes_limit={st.get('bytes_limit')}")


# ---------------------------------------------------------------- phases

def phase_device(ctx):
    import jax
    from miniwfa_tpu.utils import native
    devs = jax.devices()
    log(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    log(f"nvidia-smi: {ctx['smi']}")
    log(f"native host runtime loaded: {native.available()}")


def phase_corpus(ctx):
    from miniwfa_tpu import Options
    from miniwfa_tpu.models.exact import align_batch
    g = _load("goldens.json")
    pen = g["penalties"]
    pairs = [(c["t"], c["q"]) for c in g["cases"]]
    for tag, opt, key, cig in (
            ("score", Options(**pen), "score", None),
            ("cigar", Options(**pen, cigar=True), "cigar", "str"),
            ("lowmem_p16", Options(**pen, cigar=True, step=16),
             "lowmem_p16", "str")):
        res, dt = timed(align_batch, pairs, opt)
        n = compare(f"corpus/{tag}", res, g["runs"][key], cigar=cig)
        log(f"corpus/{tag}: {n}/{n} ok [{dt:.2f}s]")
    names = list(g["niter"])
    by_name = {c["name"]: c for c in g["cases"]}
    res, dt = timed(align_batch,
                    [(by_name[k]["t"], by_name[k]["q"]) for k in names],
                    Options(**pen, cigar=True))
    n = compare("corpus/niter", res, [g["niter"][k] for k in names],
                cigar="str", n_iter=True)
    log(f"corpus/niter: {n}/{n} ok [{dt:.2f}s]")


def _memory_analysis(spec):
    import jax
    from miniwfa_tpu.ops.wavefront import _example_args, build_aligner
    comp = jax.jit(build_aligner(spec)).lower(*_example_args(spec)).compile()
    return comp.memory_analysis()


def phase_batch100k(ctx):
    import jax
    import bench
    from miniwfa_tpu import Options
    from miniwfa_tpu.models.exact import align_batch
    from miniwfa_tpu.utils import hbm
    gold = _load("bench_goldens.json")["100000"]
    pairs = bench.make_pairs(100_000, 16, seed=7)
    dev = jax.devices()[0]
    comp = ctx["compiles"]
    got = {}
    # per-dispatch walls and the traceback-table fetch time
    os.environ["MWF_PROF"] = "1"
    for tag, opt, cig in (
            ("score", Options(), None),
            ("cigar", Options(cigar=True), "md5"),
            ("lowmem_p5000", Options(cigar=True, step=5000), "md5")):
        hbm.reset()
        n0, c0 = comp.n, comp.secs
        res, cold = timed(align_batch, pairs, opt)
        n_cold, c_cold = comp.n - n0, comp.secs - c0
        compare(f"batch100k/{tag}/cold", res, gold, cigar=cig)
        n0 = comp.n
        res, warm = timed(align_batch, pairs, opt)
        compare(f"batch100k/{tag}", res, gold, cigar=cig)
        cells = sum(r.n_iter for r in res)
        got[tag] = res
        log(f"batch100k/{tag}: 16/16 ok cold={cold:.3f}s "
            f"(compiles={n_cold}, compile_s={c_cold:.1f}) warm={warm:.3f}s "
            f"(compiles={comp.n - n0}) n_iter_sum={cells} "
            f"cells_per_s={cells / warm:.4g} "
            f"peak_dispatch={hbm.peak()[1]!r} {mem_line(dev)}")
        if tag == "cigar":
            spec = hbm.peak_spec()
            log(f"batch100k/cigar largest tb spec: {spec}")
            log(f"batch100k/cigar memory_analysis: {_memory_analysis(spec)}")
    # the same cells in score and CIGAR mode, and low-mem == high-mem
    compare_same("batch100k/n_iter score vs cigar", got["score"],
                 got["cigar"], fields=("s", "n_iter"))
    compare_same("batch100k/lowmem vs highmem", got["lowmem_p5000"],
                 got["cigar"])
    del os.environ["MWF_PROF"]
    log("batch100k: low-mem == high-mem CIGAR for 16/16 pairs")


def phase_heuristic(ctx):
    from tools.make_scale_goldens import gen_case
    from miniwfa_tpu import Options
    from miniwfa_tpu.models.auto import align_auto_batch
    from miniwfa_tpu.models.chain import align_chain_batch
    sg = _load("scale_goldens.json")
    pen = _load("goldens.json")["penalties"]
    opt = Options(**pen, cigar=True)
    # sv300k/auto is left out: its exact score probe climbs to W=131072
    # before the 1e8-cell budget stops it, ~660 s on one H100 — more than
    # half the script's time limit
    for name, modes in (("div100k", ("chain", "auto")),
                        ("sv300k", ("chain",))):
        ts, qs = gen_case(name)
        for mode in modes:
            fn = {"chain": align_chain_batch, "auto": align_auto_batch}[mode]
            res, dt = timed(fn, [(ts, qs)], opt)
            compare(f"heuristic/{name}/{mode}", res, [sg[name][mode]])
            log(f"heuristic/{name}/{mode}: ok s={res[0].s} "
                f"n_iter={res[0].n_iter} [{dt:.2f}s]")


def phase_cli(ctx):
    from miniwfa_tpu import cli
    g = _load("goldens.json")
    t3 = next(c for c in g["cases"] if c["name"] == "t3")
    want = {("-c",): "155\t1X16=1X14=128I4=1X24=",
            ("-c", "-p", "32"): "155\t1X16=1X14=128I4=1X24=",
            ("-u", "-c"): "155\t1X16=1X18=128I1X24="}
    with tempfile.TemporaryDirectory() as d:
        ft, fq = os.path.join(d, "t.fa"), os.path.join(d, "q.fa")
        with open(ft, "w") as f:
            f.write(f">t3t\n{t3['t']}\n")
        with open(fq, "w") as f:
            f.write(f">t3q\n{t3['q']}\n")
        for flags, tail in want.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = cli.main([*flags, ft, fq])
            out = buf.getvalue().strip()
            if rc != 0 or not out.endswith(tail):
                raise Mismatch(f"cli {' '.join(flags)}: rc={rc} "
                               f"out={out!r} want ...{tail!r}")
            log(f"cli {' '.join(flags)}: ok {tail.split(chr(9))[1]}")


def peaks_line(devs) -> str:
    return " ".join(
        f"{d.id}:{(d.memory_stats() or {}).get('peak_bytes_in_use')}"
        for d in devs)


def multi_parity(pairs, gold, mesh, comp=None):
    """The sharded path on ``mesh`` in score, CIGAR and low-mem modes vs
    the goldens, each followed by every device's peak memory so far; then
    the ratio (printed, not gated): score once more on the mesh, and
    align_batch of the same batch on one device, repeated if its first run
    compiled (``comp``: a Compiles counter)."""
    from miniwfa_tpu import Options
    from miniwfa_tpu.models.exact import align_batch
    from miniwfa_tpu.parallel.batch import align_batch_sharded
    devs = list(mesh.devices.flat)
    nd, n = len(devs), len(pairs)
    ncomp = (lambda: comp.n) if comp is not None else (lambda: 0)
    for tag, opt, cig in (
            ("score", Options(), None),
            ("cigar", Options(cigar=True), "md5"),
            ("lowmem_p5000", Options(cigar=True, step=5000), "md5")):
        c0 = ncomp()
        res, dt = timed(align_batch_sharded, pairs, opt, mesh)
        compare(f"multi/{tag}", res, gold, cigar=cig)
        log(f"multi/{tag}: {n}/{n} ok on {nd} devices [{dt:.3f}s, "
            f"compiles={ncomp() - c0}] "
            f"n_iter_sum={sum(r.n_iter for r in res)} "
            f"peak_bytes_in_use {peaks_line(devs)}")
    c0 = ncomp()
    res, warm_n = timed(align_batch_sharded, pairs, Options(), mesh)
    log(f"multi/score rerun: {nd} devices {warm_n:.3f}s "
        f"compiles={ncomp() - c0}")
    c0 = ncomp()
    one, dt_1 = timed(align_batch, pairs, Options())
    log(f"multi/score 1 device: {dt_1:.3f}s compiles={ncomp() - c0}")
    if ncomp() > c0:
        one, dt_1 = timed(align_batch, pairs, Options())
        log(f"multi/score 1 device rerun: {dt_1:.3f}s")
    compare("multi/score/1device", one, gold)
    compare_same(f"multi/score {nd} devices vs 1 device", res, one,
                 fields=("s", "n_iter"))
    log(f"multi/score ratio 1-device/{nd}-device = {dt_1 / warm_n:.3f}")


def phase_multi(ctx):
    import jax
    import bench
    from miniwfa_tpu.parallel.mesh import make_mesh
    devs = jax.devices()
    if len(devs) != 4:
        raise RuntimeError(f"--multi needs 4 devices, found {len(devs)}")
    multi_parity(bench.make_pairs(100_000, 16, seed=7),
                 _load("bench_goldens.json")["100000"], make_mesh(devs),
                 ctx["compiles"])
    for d in devs:
        log(f"multi/peak_memory {d}: {mem_line(d)}")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in devs]
    if not all(p > 0 for p in peaks):
        raise RuntimeError(f"a device did no work: peaks {peaks}")


# ---------------------------------------------------------------- main

def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().replace("\n", " | ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not os.path.isdir(os.path.join(ROOT, "miniwfa_tpu")):
        print("chip_smoke: the miniwfa_tpu package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU, JAX backend is {backend!r}",
              file=sys.stderr)
        return 1

    from miniwfa_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    ctx = {"smi": nvidia_smi(), "compiles": Compiles()}
    run = [("device", phase_device)]
    if args.multi:
        run.append(("multi", phase_multi))
    else:
        run += [(p, globals()[f"phase_{p}"]) for p in PHASES[1:]
                if p in phases]
    t_all = time.perf_counter()
    for name, fn in run:
        t0 = time.perf_counter()
        fn(ctx)
        log(f"phase {name}: ok [{time.perf_counter() - t0:.1f}s]")
    devs = jax.devices()
    log(f"total {time.perf_counter() - t_all:.1f}s, "
        f"compiles={ctx['compiles'].n} "
        f"compile_s={ctx['compiles'].secs:.1f}")
    log(f"card: {ctx['smi']}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
