"""Device-buffer budgets and band caps: derived from the runtime's
memory_stats()["bytes_limit"] on an accelerator, fixed on the CPU."""

import pytest

from miniwfa_tpu.options import Options
from miniwfa_tpu.models import exact
from miniwfa_tpu.models.exact import (
    CPU_PASS1_SNAP_BUDGET, CPU_TB_LANE_BUDGET, MODE_PASS1, MODE_SCORE,
    MODE_TB, align_batch, budgets, w_cap_for)
from miniwfa_tpu.utils import hbm


@pytest.mark.parametrize("limit, want", [
    (None, (CPU_TB_LANE_BUDGET, CPU_PASS1_SNAP_BUDGET)),
    (60 * 2**30, (18 * 2**30, 18 * 2**30)),       # an 80 GB card at 75 %
    (10 * 2**30 + 3, (3 * 2**30, 3 * 2**30)),
])
def test_budgets_from_limit(limit, want):
    assert budgets(limit) == want


@pytest.mark.parametrize("mode", [MODE_TB, MODE_PASS1, MODE_SCORE])
def test_w_cap_is_largest_window_within_budget(mode):
    opt = Options(cigar=True, step=5000)
    ns = opt.max_pen + 1
    tb_b, snap_b = budgets(60 * 2**30)

    def need(w):
        if mode == MODE_TB:
            return w * (w // 2)
        return (w // (2 * opt.step) + 2) * ns * 5 * w * 4

    w = w_cap_for(opt, mode, tb_b, snap_b)
    if mode == MODE_SCORE:
        assert w == 1 << 30
        return
    budget = tb_b if mode == MODE_TB else snap_b
    assert w & (w - 1) == 0
    assert need(w) <= budget < need(2 * w)
    # a smaller card caps the band lower
    assert w_cap_for(opt, mode, tb_b // 16, snap_b // 16) < w


class _FakeDevice:
    platform = "gpu"
    device_kind = "fake GPU"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats", [None, {}, {"peak_bytes_in_use": 5}])
def test_gpu_without_bytes_limit_is_an_error(stats):
    with pytest.raises(RuntimeError, match="bytes_limit"):
        hbm.device_limit(_FakeDevice(stats))


def test_device_limit_and_peak_read_memory_stats():
    dev = _FakeDevice({"bytes_limit": 64 << 30, "peak_bytes_in_use": 7})
    assert hbm.device_limit(dev) == 64 << 30
    assert hbm.device_peak(dev) == 7


def test_cpu_reports_no_limit():
    assert hbm.device_limit() is None
    assert hbm.device_peak() is None
    assert exact._budgets() == (CPU_TB_LANE_BUDGET, CPU_PASS1_SNAP_BUDGET)


def test_tb_lane_chunking_gives_identical_results(goldens, monkeypatch):
    """A traceback budget of four 512x512 lanes splits an 8-pair CIGAR
    batch into two dispatches; every result must equal the goldens."""
    c = next(c for c in goldens["cases"] if c["name"] == "t3")
    pairs = ([(c["t"], c["q"])] * 3 + [("A", "G")]) * 2
    seen = []
    real = exact._run_device

    def spy(opt, mode, bk, *a, **kw):
        seen.append(bk.B)
        return real(opt, mode, bk, *a, **kw)

    monkeypatch.setattr(exact, "_budgets",
                        lambda: (4 * 512 * 512, CPU_PASS1_SNAP_BUDGET))
    monkeypatch.setattr(exact, "_run_device", spy)
    res = align_batch(pairs, Options(cigar=True))
    assert seen == [4, 4]
    for r in res[:3] + res[4:7]:
        assert (r.s, r.cigar_str) == (155, "1X16=1X14=128I4=1X24=")
    assert res[3].s == res[7].s == 4


def test_tb_budget_below_one_lane_raises_lowmem_advice(monkeypatch):
    monkeypatch.setattr(exact, "_budgets",
                        lambda: (1000, CPU_PASS1_SNAP_BUDGET))
    with pytest.raises(RuntimeError, match="low-mem stripe mode"):
        align_batch([("ACGT", "ACGA")], Options(cigar=True))


@pytest.mark.parametrize("mode", [MODE_SCORE, MODE_TB])
def test_first_rung_full_cycle_budget_only_in_score_mode(mode):
    opt = Options(cigar=mode == MODE_TB)
    bk = exact._buckets_for(opt, [b"A" * 1000], [b"C" * 900], 512, 512)
    first, w_cap = exact._first_rung(opt, mode, bk)
    assert w_cap == exact._w_cap(opt, mode)
    assert first.W == min(bk.W, w_cap)
    assert first.S_CAP == (bk.S_full if mode == MODE_SCORE else bk.S_CAP)


def test_pass2_rung_sized_from_pass1_scores():
    opt = Options(cigar=True, step=100)
    ts, qs = [b"A" * 1000, b"A" * 1010], [b"A" * 1000, b"A" * 1000]
    bk = exact._buckets_for(opt, ts, qs, 512, 512)
    ns = opt.max_pen + 1
    p2 = exact._pass2_buckets(opt, bk, [30, None, 4097], ts, qs)
    assert p2.S_CAP == min(8192, bk.S_full)
    assert p2.W == min(exact._next_pow2(2 * 100 + 2 * ns + 24), bk.W_full)
    # no pass-1 score: the ladder's own rung
    assert exact._pass2_buckets(opt, bk, [None], ts, qs).S_CAP == bk.S_CAP
