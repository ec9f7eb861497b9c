"""Seeded mini-fuzz against the LIVE reference binary (C26/C27 analog).

Unlike the fixed golden corpus, this builds lh3/miniwfa from source at
test time and diffs score+CIGAR on freshly generated pairs — a regression
net with no dependence on pre-recorded outputs.  Small sizes only (CPU
backend); tools/fuzz_oracle.py runs the full-size sweep.
"""

import os
import shutil
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF_SRC = "/root/reference"

pytestmark = pytest.mark.skipif(
    not (os.path.isdir(REF_SRC) and shutil.which("make")
         and shutil.which("gcc")),
    reason="reference source or toolchain unavailable")


def _small_only(rng):
    from tools import fuzz_oracle as fz
    while True:
        ts, qs, regime = fz.gen_pair(rng)
        if len(ts) <= 2500 and len(qs) <= 2500:
            return ts, qs, regime


def test_mini_fuzz_vs_reference():
    import random
    from tools import fuzz_oracle as fz
    from miniwfa_tpu.models import exact as align_mod

    rng = random.Random(1234)
    fails = []
    for i in range(12):
        ts, qs, _ = _small_only(rng)
        mode = rng.choice(["exact", "cigar", "lowmem", "chain", "auto"])
        err = fz.check_pair(ts, qs, mode, rng, align_mod)
        if err:
            fails.append((i, mode, len(ts), len(qs), err))
    assert not fails, fails
