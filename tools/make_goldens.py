#!/usr/bin/env python3
"""Generate golden parity fixtures by running the *reference* miniwfa binary.

This script never copies reference code into the repo: it compiles the
reference out-of-tree (in a temp dir) from MWF_REF (default /root/reference)
and records its outputs (score, CIGAR, n_iter) on a deterministic suite of
sequence pairs into tests/data/goldens.json.  The test-suite then checks the
engine against those recorded outputs, per SURVEY.md §4's test strategy
(golden integration tests + mode cross-checks).

Usage: python tools/make_goldens.py [--ref /root/reference] [--out tests/data/goldens.json]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile

# A tiny driver of our own (NOT reference code) that links against the
# reference library to also expose rst.n_iter, which test-mwf doesn't print.
NITER_DRIVER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "miniwfa.h"
// usage: niter <t.txt> <q.txt> [step]  (raw one-line sequence files)
static char *slurp(const char *fn, long *len) {
    FILE *fp = fopen(fn, "rb"); char *s; long n;
    fseek(fp, 0, SEEK_END); n = ftell(fp); fseek(fp, 0, SEEK_SET);
    s = malloc(n + 1); fread(s, 1, n, fp); fclose(fp);
    while (n > 0 && (s[n-1] == '\n' || s[n-1] == '\r')) --n;
    s[n] = 0; *len = n; return s;
}
int main(int argc, char **argv) {
    long tl, ql; char *ts = slurp(argv[1], &tl), *qs = slurp(argv[2], &ql);
    mwf_opt_t opt; mwf_rst_t r; mwf_opt_init(&opt);
    opt.flag |= MWF_F_CIGAR;
    if (argc > 3) opt.step = atoi(argv[3]);
    mwf_wfa_exact(0, &opt, tl, ts, ql, qs, &r);
    printf("%d\t%lld\t", r.s, (long long)r.n_iter);
    for (int i = 0; i < r.n_cigar; ++i)
        printf("%d%c", r.cigar[i]>>4, "MIDNSHP=XBid"[r.cigar[i]&0xf]);
    printf("\n");
    return 0;
}
"""


def build_reference(ref_dir: str, build_dir: str) -> tuple[str, str]:
    for fn in os.listdir(ref_dir):
        if fn.endswith((".c", ".h")):
            shutil.copy(os.path.join(ref_dir, fn), build_dir)
    subprocess.run(
        ["gcc", "-O3", "-march=native", "-o", "test-mwf",
         "main.c", "miniwfa.c", "kalloc.c", "mwf-dbg.c", "-lz", "-lm", "-lpthread"],
        cwd=build_dir, check=True)
    with open(os.path.join(build_dir, "niter.c"), "w") as f:
        f.write(NITER_DRIVER)
    subprocess.run(
        ["gcc", "-O3", "-march=native", "-o", "niter",
         "niter.c", "miniwfa.c", "kalloc.c", "-lm"],
        cwd=build_dir, check=True)
    return os.path.join(build_dir, "test-mwf"), os.path.join(build_dir, "niter")


def read_fasta_one(path: str) -> tuple[str, str]:
    name, seq = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    break
                name = line[1:].split()[0]
            elif line:
                seq.append(line)
    return name or "seq", "".join(seq)


def mutate(rng: random.Random, seq: str, sub: float, ind: float, max_indel: int = 8) -> str:
    """Random substitutions + indels at the given per-base rates."""
    out = []
    bases = "ACGT"
    i = 0
    n = len(seq)
    while i < n:
        r = rng.random()
        if r < ind:
            if rng.random() < 0.5:  # deletion
                i += rng.randint(1, max_indel)
                continue
            out.append("".join(rng.choice(bases) for _ in range(rng.randint(1, max_indel))))
        c = seq[i]
        if rng.random() < sub:
            c = rng.choice([b for b in bases if b != c])
        out.append(c)
        i += 1
    return "".join(out)


def rand_seq(rng: random.Random, n: int, alphabet: str = "ACGT") -> str:
    return "".join(rng.choice(alphabet) for _ in range(n))


def build_cases(ref_dir: str) -> list[dict]:
    rng = random.Random(20260816)
    cases: list[dict] = []

    def add(name, t, q):
        cases.append({"name": name, "t": t, "q": q})

    # the reference repo's own fixture
    _, t3t = read_fasta_one(os.path.join(ref_dir, "test", "t3-0.fa"))
    _, t3q = read_fasta_one(os.path.join(ref_dir, "test", "t3-1.fa"))
    add("t3", t3t, t3q)

    # hand-picked edge cases (SURVEY.md §7 golden table)
    add("identity4", "ACGT", "ACGT")
    add("mismatch1", "A", "G")
    add("ins4", "AAAA", "AAAAAAAA")
    add("mixed", "AAAA", "GGGGACGT")
    add("del4", "AAAA", "")
    add("empty_t", "", "ACGTACGT")
    # NOTE: empty-vs-empty with -c segfaults the *reference* (UB read of
    # tb.a[-1] at miniwfa.c:407 when tb.n==0), so it can't be a golden;
    # this engine pins its graceful behavior in its own unit test.
    add("one_eq", "C", "C")
    add("homopoly", "A" * 40, "A" * 25)
    add("binary", "ABABABABAB", "BABABABABB")
    add("lower_n", "acgtNNacgt", "acgTNacgt")

    # random small pairs at assorted divergences
    for i in range(48):
        n = rng.randint(1, 70)
        t = rand_seq(rng, n)
        q = mutate(rng, t, sub=rng.choice([0.02, 0.1, 0.3]), ind=rng.choice([0.0, 0.02, 0.1]))
        add(f"small{i}", t, q)
    for i in range(12):  # unrelated pairs
        add(f"unrel{i}", rand_seq(rng, rng.randint(0, 40)), rand_seq(rng, rng.randint(0, 40)))

    # medium pairs: exercise band growth/shrink + 256-cycle shrink cadence
    t = rand_seq(rng, 2000)
    add("med2k", t, mutate(rng, t, 0.03, 0.004))
    t = rand_seq(rng, 3000)
    add("med3k_bigdel", t[:1000] + t[1400:], mutate(rng, t, 0.01, 0.0))
    t = rand_seq(rng, 5000)
    q = mutate(rng, t[:2500], 0.02, 0.002) + rand_seq(rng, 400) + mutate(rng, t[2500:], 0.02, 0.002)
    add("med5k_ins", t, q)
    # long-gap dual-affine crossover (o2+l*e2 beats o1+l*e1 for l > 11)
    t = rand_seq(rng, 1500)
    add("gap300", t, t[:600] + t[900:])
    return cases


def write_fastas(cases, path_t, path_q):
    with open(path_t, "w") as ft, open(path_q, "w") as fq:
        for c in cases:
            ft.write(f">{c['name']}\n{c['t']}\n")
            fq.write(f">{c['name']}\n{c['q']}\n")


def run_mode(binary, args, path_t, path_q, n_cases):
    out = subprocess.run([binary, *args, path_t, path_q],
                         capture_output=True, text=True, check=True).stdout
    rows = []
    for line in out.splitlines():
        f = line.split("\t")
        rows.append({"s": int(f[9]), "cigar": f[10] if len(f) > 10 else None})
    assert len(rows) == n_cases, f"{args}: {len(rows)} rows != {n_cases} cases"
    return rows


MODES = [
    ("score", []),
    ("cigar", ["-c"]),
    ("lowmem_p1", ["-p1"]),
    ("lowmem_p3", ["-p3"]),
    ("lowmem_p16", ["-p16"]),
    ("lowmem_p100", ["-p100"]),
    ("edit_cigar", ["-e", "-c"]),
    ("affine_cigar", ["-a", "-c"]),
    ("chain", ["-u", "-c"]),
    ("auto", ["-t", "-c"]),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", default=os.environ.get("MWF_REF", "/root/reference"))
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "..", "tests", "data", "goldens.json"))
    args = ap.parse_args()

    cases = build_cases(args.ref)
    with tempfile.TemporaryDirectory() as tmp:
        test_mwf, niter = build_reference(args.ref, tmp)
        pt, pq = os.path.join(tmp, "t.fa"), os.path.join(tmp, "q.fa")
        write_fastas(cases, pt, pq)
        runs = {}
        for name, flags in MODES:
            runs[name] = run_mode(test_mwf, flags, pt, pq, len(cases))
            print(f"mode {name}: {len(runs[name])} results", file=sys.stderr)
        # n_iter for a subset (validates band-trajectory parity)
        niters = {}
        for c in cases:
            if c["name"] in ("t3", "med2k", "med3k_bigdel", "med5k_ins", "gap300", "homopoly"):
                ft, fq2 = os.path.join(tmp, "nt.txt"), os.path.join(tmp, "nq.txt")
                open(ft, "w").write(c["t"] + "\n")
                open(fq2, "w").write(c["q"] + "\n")
                out = subprocess.run([niter, ft, fq2], capture_output=True, text=True, check=True).stdout
                s, it, cg = out.strip().split("\t")
                niters[c["name"]] = {"s": int(s), "n_iter": int(it), "cigar": cg}

    data = {
        "penalties": {"x": 4, "o1": 4, "e1": 2, "o2": 15, "e2": 1},
        "cases": cases,
        "runs": runs,
        "niter": niters,
    }
    out_path = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(data, f)
    print(f"wrote {out_path} ({os.path.getsize(out_path)} bytes, {len(cases)} cases)")


if __name__ == "__main__":
    main()
