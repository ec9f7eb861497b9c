#!/usr/bin/env python3
"""Generate the committed scale-fixture goldens from the reference binary.

Sequences are NOT stored: each case pins a deterministic generator
(seed + params, `gen_case` below) and the fixture records the reference
binary's outputs (score, cigar md5, n_iter where instrumented) for the
modes the case exercises.  chip_smoke.py regenerates the sequences and
asserts parity on the GPU.

Cases (the reference README's scale table, README.md:80-88):
  * 50 kb pair with one 5 kb deletion  — the dual-affine crossover
    (SURVEY.md fixture table: long gap costs o2+l*e2).
  * 100 kb 2%-diverged pair            — exact, low-mem p5000 and chain mode.
  * 5 Mb ~1%-diverged pair             — the reference's headline low-mem
    CIGAR workload (-cp5000, README.md:98-99) plus auto mode.

Requires the reference test-mwf binary (path in MWF_REF_BIN).
"""
import hashlib
import json
import os
import random
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench import mutate  # noqa: E402

# the reference test-mwf binary, built out-of-tree from lh3/miniwfa
REF = os.environ.get("MWF_REF_BIN", "test-mwf")

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                   "scale_goldens.json")


def gen_case(name):
    """Deterministic sequence pair for a named scale case."""
    if name == "del50k":
        rng = random.Random(501)
        t = "".join(rng.choice("ACGT") for _ in range(50_000))
        q = t[:20_000] + t[25_000:]      # one 5 kb deletion (target side)
        return t, q
    if name == "div100k":
        rng = random.Random(1001)
        t = "".join(rng.choice("ACGT") for _ in range(100_000))
        return t, mutate(rng, t, sub=0.02, ind=0.002)
    if name == "div5m":
        rng = random.Random(5001)
        t = "".join(rng.choice("ACGT") for _ in range(5_000_000))
        return t, mutate(rng, t, sub=0.008, ind=0.002)
    # --- adversarial cases (VERDICT r3 Missing #2 / Next #5): what real
    # genomic pairs stress that uniform divergence does not ---
    if name == "sv300k":
        # multi-kb structural variants both ways: a 20 kb deletion, a
        # 15 kb insertion, a 3 kb deletion and a 2 kb insertion over 1%
        # background divergence — stresses dual-affine long-gap costing
        # (o2+l*e2) and band shrink after large excursions
        rng = random.Random(3001)
        t = "".join(rng.choice("ACGT") for _ in range(300_000))
        ins15 = "".join(rng.choice("ACGT") for _ in range(15_000))
        ins2 = "".join(rng.choice("ACGT") for _ in range(2_000))
        q = (t[:50_000] + t[70_000:150_000] + ins15 +
             t[150_000:200_000] + t[203_000:250_000] + ins2 + t[250_000:])
        return t, mutate(rng, q, sub=0.01, ind=0.0005)
    if name == "rep200k":
        # tandem repeat arrays (67 bp and 171 bp units) with copy-number
        # differences between the sides — stresses the chain mode's
        # max_occ k-mer filter and traceback through repeat ambiguity
        rng = random.Random(2002)
        u1 = "".join(rng.choice("ACGT") for _ in range(67))
        u2 = "".join(rng.choice("ACGT") for _ in range(171))
        fill = ["".join(rng.choice("ACGT") for _ in range(n))
                for n in (60_000, 50_000, 70_000)]
        t = fill[0] + u1 * 150 + fill[1] + u2 * 60 + fill[2]
        q = fill[0] + u1 * 138 + fill[1] + u2 * 66 + fill[2]
        return t, mutate(rng, q, sub=0.01, ind=0.0005)
    if name == "nbear1m":
        # 1 Mb assembly-like pair with N gap runs (5 kb / 10 kb / 2 kb)
        # and soft-masked (lowercase) stretches over 1% divergence —
        # the non-ACGT cpw=4 byte-packing mode at scale (no previous
        # at-scale coverage, VERDICT r4 Next #7).  The reference
        # compares raw bytes in extension (N==N and a==a match,
        # wf_extend1_padded, miniwfa.c:212-226) and seq_nt4_table maps
        # them out of the k-mer alphabet (miniwfa.c:699-730): both
        # behaviors must survive the packed word tables.
        rng = random.Random(1101)
        t = "".join(rng.choice("ACGT") for _ in range(1_000_000))
        t = (t[:200_000] + "N" * 5_000 + t[200_000:500_000]
             + "N" * 10_000 + t[500_000:700_000].lower()
             + t[700_000:900_000] + "N" * 2_000 + t[900_000:])
        q = mutate(rng, t, sub=0.01, ind=0.0005)
        # NOTE the recorded chain/auto score (44441) is LOWER than the
        # exact optimum (46361): the reference anchors case-insensitively
        # (seq_nt4_table folds 'a'->0, miniwfa.c:699-706) and emits '='
        # across anchored segments, while exact extension compares BYTES
        # (miniwfa.c:212-226) and charges 'a' vs 'A' substitutions as
        # mismatches.  A faithful port must reproduce both sides of the
        # quirk; that asymmetry is what this fixture pins.
        return t, q
    if name == "dissim150k":
        # a 12 kb internal region replaced with unrelated sequence on the
        # query side (both sides >= 10 kb, ksim < 0.02) — the chain
        # mode's D+I shortcut trigger (miniwfa.c:869-875), costed
        # 2*o2 + e2*(l1+l2)
        rng = random.Random(1501)
        t = "".join(rng.choice("ACGT") for _ in range(150_000))
        novel = "".join(rng.choice("ACGT") for _ in range(12_000))
        q = t[:60_000] + novel + t[72_000:]
        return t, mutate(rng, q, sub=0.015, ind=0.001)
    raise KeyError(name)


def ref_run(ts, qs, flags):
    """Run the reference binary; returns (s, cigar_str|None, wall_s)."""
    with tempfile.TemporaryDirectory() as d:
        ft, fq = os.path.join(d, "t.fa"), os.path.join(d, "q.fa")
        open(ft, "w").write(f">t\n{ts}\n")
        open(fq, "w").write(f">q\n{qs}\n")
        t0 = time.perf_counter()
        out = subprocess.run([REF] + flags + [ft, fq], capture_output=True,
                             text=True, check=True)
        dt = time.perf_counter() - t0
        fields = out.stdout.strip().splitlines()[0].split("\t")
        return int(fields[9]), (fields[10] if len(fields) > 10 else None), dt


# mode name -> reference flags; chain/auto CIGARs are recorded for
# completeness but only scores are asserted downstream (heuristic modes
# guarantee neither score nor CIGAR stability across implementations —
# the committed values pin THIS reference build's canonical output).
MODES = {
    "score": [],
    "cigar": ["-c"],
    "lowmem_p5000": ["-c", "-p5000"],
    "chain": ["-u", "-c"],
    "auto": ["-t", "-c"],
}

CASE_MODES = {
    "del50k": ["score", "cigar", "lowmem_p5000", "auto"],
    "div100k": ["score", "cigar", "lowmem_p5000", "chain", "auto"],
    "div5m": ["lowmem_p5000", "auto"],
    # adversarial fixtures: high-mem CIGAR is out of device reach at
    # these band widths (the documented -p boundary), so the exact modes
    # are score + low-mem; chain/auto pin the heuristic paths
    "sv300k": ["score", "lowmem_p5000", "chain", "auto"],
    "rep200k": ["score", "lowmem_p5000", "chain", "auto"],
    "dissim150k": ["score", "lowmem_p5000", "chain", "auto"],
    # non-ACGT at scale: band ~2s ~ 90k diagonals puts high-mem CIGAR
    # past the device boundary (use -p), same as the other adversarials
    "nbear1m": ["score", "lowmem_p5000", "chain", "auto"],
}


def main():
    only = sys.argv[1:] or list(CASE_MODES)
    try:
        goldens = json.load(open(OUT))
    except (OSError, ValueError):
        goldens = {}
    for name in only:
        ts, qs = gen_case(name)
        entry = goldens.setdefault(name, {"tl": len(ts), "ql": len(qs)})
        for mode in CASE_MODES[name]:
            s, cg, dt = ref_run(ts, qs, MODES[mode])
            entry[mode] = {"s": s, "ref_wall_s": round(dt, 2)}
            if cg is not None:
                entry[mode]["cigar_md5"] = hashlib.md5(cg.encode()).hexdigest()
                entry[mode]["cigar_len"] = len(cg)
            print(f"{name}/{mode}: s={s} [{dt:.1f}s]", flush=True)
            with open(OUT, "w") as f:
                json.dump(goldens, f, indent=1, sort_keys=True)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
