#!/usr/bin/env python3
"""Generate bench pair goldens from the reference binary (C oracle).

The bench pairs are deterministic (seeded); their reference scores and
CIGAR digests are committed so bench.py and chip_smoke.py can assert parity
on the GPU without needing the reference binary at bench time.

Requires the reference test-mwf binary, built out-of-tree from
lh3/miniwfa (path in MWF_REF_BIN).
"""
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench import make_pairs  # noqa: E402
from tools.make_scale_goldens import ref_run  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                   "bench_goldens.json")


def main():
    goldens = {}
    for n, b in ((100_000, 16), (8_000, 64)):
        entries = []
        for i, (t, q) in enumerate(make_pairs(n, b)):
            want_cigar = n == 100_000   # digest-check every big pair
            s, cg, _ = ref_run(t, q, ["-c"] if want_cigar else [])
            e = {"s": s}
            if cg is not None:
                e["cigar_md5"] = hashlib.md5(cg.encode()).hexdigest()
            entries.append(e)
            print(f"n={n} pair {i}: s={s}", flush=True)
        goldens[str(n)] = entries
    with open(OUT, "w") as f:
        json.dump(goldens, f, indent=1)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
