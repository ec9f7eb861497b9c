"""chip_smoke.py: refuses to run off the GPU, and its golden comparators
catch every kind of mismatch.  The phases themselves run on the card
(the `gpu`-marked test below, and ``python3 chip_smoke.py``)."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from miniwfa_tpu.models.exact import Result  # noqa: E402


def _r(s, cigar=None, n_iter=0):
    from miniwfa_tpu import cigar as C
    return Result(s=s, cigar=None if cigar is None else
                  C.from_string(cigar), n_iter=n_iter)


def test_main_fails_on_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_main_rejects_unknown_phase():
    with pytest.raises(SystemExit):
        chip_smoke.main(["--phases", "device,warp"])


def test_script_alone_fails(tmp_path):
    """In a directory with chip_smoke.py and nothing else of the repo the
    script exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


GOOD = {"s": 155, "cigar": "1X16=1X14=128I4=1X24=", "n_iter": 16875}


@pytest.mark.parametrize("got, kw", [
    (_r(154, GOOD["cigar"], 16875), {}),                     # score
    (_r(155, "1X16=1X14=128I1X28=", 16875), {"cigar": "str"}),
    (_r(155, "1X16=1X14=128I1X28=", 16875),
     {"cigar": "md5"}),
    (_r(155, GOOD["cigar"], 16874), {"n_iter": True}),       # n_iter
    (_r(155, None, 16875), {"cigar": "md5"}),                # no CIGAR
])
def test_compare_catches_mismatch(got, kw):
    want = dict(GOOD, cigar_md5=chip_smoke.md5(GOOD["cigar"]))
    with pytest.raises(chip_smoke.Mismatch):
        chip_smoke.compare("t", [got], [want], **kw)


def test_compare_accepts_match_and_checks_length():
    want = dict(GOOD, cigar_md5=chip_smoke.md5(GOOD["cigar"]))
    ok = _r(155, GOOD["cigar"], 16875)
    for kw in ({}, {"cigar": "str"}, {"cigar": "md5"}, {"n_iter": True}):
        assert chip_smoke.compare("t", [ok], [want], **kw) == 1
    with pytest.raises(chip_smoke.Mismatch):
        chip_smoke.compare("t", [ok, ok], [want])


def test_compare_same_catches_difference():
    a = [_r(4, "1X", 1), _r(0, "4=", 4)]
    chip_smoke.compare_same("t", a, list(a))
    with pytest.raises(chip_smoke.Mismatch):
        chip_smoke.compare_same("t", a, [a[0], _r(0, "3=1X", 4)])
    with pytest.raises(chip_smoke.Mismatch):
        chip_smoke.compare_same("t", a, [a[0], _r(0, "4=", 5)],
                                fields=("s", "n_iter"))


@pytest.mark.gpu
def test_corpus_on_gpu(gpu):
    """The golden corpus in score, CIGAR, low-mem p16 and n_iter modes on
    the card (chip_smoke's corpus phase)."""
    chip_smoke.phase_corpus({})


def test_multi_parity_on_four_virtual_devices(goldens, capsys):
    """``--multi``'s comparison on a 4-device CPU mesh with small corpus
    cases: sharded score, CIGAR and low-mem against the goldens, per-device
    peaks, and the single-device ratio run."""
    import jax
    from miniwfa_tpu.parallel.mesh import make_mesh
    idx = [i for i, c in enumerate(goldens["cases"])
           if max(len(c["t"]), len(c["q"])) <= 256][:8]
    pairs = [(goldens["cases"][i]["t"], goldens["cases"][i]["q"])
             for i in idx]
    gold = [dict(goldens["runs"]["cigar"][i], cigar_md5=chip_smoke.md5(
        goldens["runs"]["cigar"][i]["cigar"])) for i in idx]
    chip_smoke.multi_parity(pairs, gold, make_mesh(jax.devices()[:4]))
    out = capsys.readouterr().out
    for tag in ("score", "cigar", "lowmem_p5000"):
        assert f"multi/{tag}: 8/8 ok on 4 devices" in out
    assert "ratio 1-device/4-device" in out
