"""Device-memory meter (km_stat analog) and the band-limit advice."""

from miniwfa_tpu.options import Options
from miniwfa_tpu.models.exact import align_batch
from miniwfa_tpu.utils import hbm


def test_highmem_band_limit_error_documents_lowmem_route():
    # the 5 Mb high-mem CIGAR wall is a documented capability statement
    # (use -p), not a generic band-limit failure
    from miniwfa_tpu.models.exact import MODE_SCORE, MODE_TB, \
        _band_limit_error
    err = _band_limit_error(Options(cigar=True), MODE_TB, 65536, 65536)
    assert "low-mem stripe mode" in str(err) and "-p" in str(err)
    # low-mem pass 2 and score mode keep the generic routing message
    err = _band_limit_error(Options(cigar=True, step=5000), MODE_TB,
                            65536, 65536)
    assert "band window exceeded" in str(err)
    err = _band_limit_error(Options(), MODE_SCORE, 1 << 20, 1 << 20)
    assert "band window exceeded" in str(err)


def test_hbm_meter_records_dispatches():
    hbm.reset()
    assert hbm.peak() == (0, "")
    t = b"ACGT" * 500
    q = t[:999] + b"T" + t[1000:]
    res = align_batch([(t, q)], Options(cigar=True))
    assert res[0].s >= 0
    nbytes, tag = hbm.peak()
    assert nbytes > 0 and "mode=" in tag
    snap = hbm.snapshot()
    assert snap["peak_dispatch_bytes"] == nbytes
    assert snap["peak_dispatch"] == tag
    hbm.reset()
    assert hbm.peak() == (0, "")


def test_hbm_meter_keeps_max():
    hbm.reset()
    hbm.note("small", 10)
    hbm.note("big", 1000)
    hbm.note("mid", 500)
    assert hbm.peak() == (1000, "big")
    total = hbm.note_arrays("arrays", {"a": __import__("numpy").zeros(4096)})
    assert total == 4096 * 8
    assert hbm.peak()[0] == 4096 * 8


def test_hbm_meter_records_peak_spec():
    from miniwfa_tpu.ops.wavefront import MODE_TB, WfSpec
    hbm.reset()
    assert hbm.peak_spec() is None
    t = b"ACGT" * 500
    q = t[:999] + b"T" + t[1000:]
    align_batch([(t, q)], Options(cigar=True))
    spec = hbm.peak_spec()
    assert isinstance(spec, WfSpec) and spec.mode == MODE_TB
    assert f"W={spec.W}" in hbm.peak()[1]
    hbm.reset()
    assert hbm.peak_spec() is None
