"""Multi-device sharding tests on the 8-virtual-device CPU mesh.

Validates that the sharded data-parallel path produces results
bit-identical to the single-device path (the batched==single and
fake-backend layers of SURVEY.md §4)."""

import jax


def test_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_matches_single(goldens):
    from miniwfa_tpu import Options
    from miniwfa_tpu.models.exact import align_batch
    from miniwfa_tpu.parallel.batch import align_batch_sharded
    from miniwfa_tpu.parallel.mesh import make_mesh

    cases = [c for c in goldens["cases"]
             if max(len(c["t"]), len(c["q"])) <= 256][:24]
    pairs = [(c["t"], c["q"]) for c in cases]
    opt = Options()
    mesh = make_mesh()
    sharded = align_batch_sharded(pairs, opt, mesh)
    single = align_batch(pairs, opt)
    for c, a, b in zip(cases, sharded, single):
        assert a.s == b.s, c["name"]
        assert a.n_iter == b.n_iter, c["name"]


def test_sharded_scores_match_goldens(goldens):
    from miniwfa_tpu import Options
    from miniwfa_tpu.parallel.batch import align_batch_sharded
    from miniwfa_tpu.parallel.mesh import make_mesh

    cases = [(i, c) for i, c in enumerate(goldens["cases"])
             if max(len(c["t"]), len(c["q"])) <= 256]
    res = align_batch_sharded([(c["t"], c["q"]) for _, c in cases],
                              Options(), make_mesh())
    exp = goldens["runs"]["score"]
    for (i, c), r in zip(cases, res):
        assert r.s == exp[i]["s"], c["name"]


def test_sharded_lowmem_matches_goldens(goldens):
    """Low-mem (two-pass) mode through the sharded path: sharded pass 1
    + checkpoint decode + sharded pass 2 must reproduce the reference's
    low-mem score AND CIGAR (SURVEY.md §7 L7; VERDICT r1 item 5a)."""
    from miniwfa_tpu import Options
    from miniwfa_tpu.parallel.batch import align_batch_sharded
    from miniwfa_tpu.parallel.mesh import make_mesh

    cases = [(i, c) for i, c in enumerate(goldens["cases"])
             if max(len(c["t"]), len(c["q"])) <= 256][:16]
    res = align_batch_sharded([(c["t"], c["q"]) for _, c in cases],
                              Options(cigar=True, step=16), make_mesh())
    exp = goldens["runs"]["lowmem_p16"]
    for (i, c), r in zip(cases, res):
        assert r.s == exp[i]["s"], c["name"]
        assert r.cigar_str == exp[i]["cigar"], c["name"]


def test_sharded_cigar_matches_single(goldens):
    """CIGAR mode through the sharded path must equal the single-device
    path byte-for-byte."""
    from miniwfa_tpu import Options
    from miniwfa_tpu.models.exact import align_batch
    from miniwfa_tpu.parallel.batch import align_batch_sharded
    from miniwfa_tpu.parallel.mesh import make_mesh

    cases = [c for c in goldens["cases"]
             if max(len(c["t"]), len(c["q"])) <= 256][:16]
    pairs = [(c["t"], c["q"]) for c in cases]
    opt = Options(cigar=True)
    sharded = align_batch_sharded(pairs, opt, make_mesh())
    single = align_batch(pairs, opt)
    for c, a, b in zip(cases, sharded, single):
        assert a.s == b.s, c["name"]
        assert a.cigar_str == b.cigar_str, c["name"]


# the fixture set multi-device deployments were checked on: window-sized
# pairs of every shape class (insertions, deletions, homopolymers,
# unrelated, identical) at a 1024-diagonal starting window
FIXTURES = ["t3", "ins4", "mixed", "homopoly", "small7", "unrel5",
            "identity4", "del4"]


def test_sharded_fixtures_cigar_lowmem_match_goldens(goldens):
    """CIGAR and low-mem p16 through the sharded lax path at w0=1024 on
    the 8-device mesh must reproduce the reference's scores and CIGARs."""
    from miniwfa_tpu import Options
    from miniwfa_tpu.parallel.batch import align_batch_sharded
    from miniwfa_tpu.parallel.mesh import make_mesh

    cases = [(i, c) for i, c in enumerate(goldens["cases"])
             if c["name"] in FIXTURES]
    pairs = [(c["t"], c["q"]) for _, c in cases]
    mesh = make_mesh()

    res = align_batch_sharded(pairs, Options(cigar=True), mesh, w0=1024)
    exp = goldens["runs"]["cigar"]
    for (i, c), r in zip(cases, res):
        assert r.s == exp[i]["s"], c["name"]
        assert r.cigar_str == exp[i]["cigar"], c["name"]

    sub = [(i, c) for i, c in cases if c["name"] in ("t3", "small7")]
    res = align_batch_sharded([(c["t"], c["q"]) for _, c in sub],
                              Options(cigar=True, step=16), mesh, w0=1024)
    exp = goldens["runs"]["lowmem_p16"]
    for (i, c), r in zip(sub, res):
        assert r.s == exp[i]["s"], c["name"]
        assert r.cigar_str == exp[i]["cigar"], c["name"]


def test_sharded_fixtures_score_lowmem_match_goldens(goldens):
    """Score and low-mem p16 through the sharded lax path at w0=1024 on
    a 4-pair batch (fewer pairs than devices: padded lanes)."""
    from miniwfa_tpu import Options
    from miniwfa_tpu.parallel.batch import align_batch_sharded
    from miniwfa_tpu.parallel.mesh import make_mesh

    names = ["t3", "small7", "ins4", "identity4"]
    cases = [(i, c) for i, c in enumerate(goldens["cases"])
             if c["name"] in names]
    pairs = [(c["t"], c["q"]) for _, c in cases]
    mesh = make_mesh()

    res = align_batch_sharded(pairs, Options(), mesh, w0=1024)
    exp = goldens["runs"]["score"]
    for (i, c), r in zip(cases, res):
        assert r.s == exp[i]["s"], c["name"]

    res = align_batch_sharded(pairs, Options(cigar=True, step=16), mesh,
                              w0=1024)
    exp = goldens["runs"]["lowmem_p16"]
    for (i, c), r in zip(cases, res):
        assert r.s == exp[i]["s"], c["name"]
        assert r.cigar_str == exp[i]["cigar"], c["name"]


def _spy_sharded(monkeypatch):
    """Record (mode, B, W, S_CAP) of every sharded dispatch."""
    from miniwfa_tpu.parallel import batch
    seen, real = [], batch._run_sharded

    def spy(opt, mode, bk, mesh, axis, ts, qs, idx, *a, **kw):
        out, spec = real(opt, mode, bk, mesh, axis, ts, qs, idx, *a, **kw)
        seen.append((mode, spec.B, spec.W, spec.S_CAP))
        return out, spec
    monkeypatch.setattr(batch, "_run_sharded", spy)
    return seen


def test_sharded_score_takes_full_cycle_budget(goldens, monkeypatch):
    """Score mode allocates nothing that scales with S_CAP, so the sharded
    driver starts at the full score bound like align_batch: only the band
    window escalates."""
    from miniwfa_tpu import Options
    from miniwfa_tpu.models.exact import _buckets_for, as_bytes
    from miniwfa_tpu.parallel.batch import align_batch_sharded
    from miniwfa_tpu.parallel.mesh import make_mesh

    c = next(c for c in goldens["cases"] if c["name"] == "t3")
    pairs = [(c["t"], c["q"])] * 8
    seen = _spy_sharded(monkeypatch)
    res = align_batch_sharded(pairs, Options(), make_mesh())
    bk = _buckets_for(Options(), [as_bytes(c["t"])], [as_bytes(c["q"])],
                      512, 512)
    assert seen and all(s == bk.S_full for _, _, _, s in seen)
    assert [r.s for r in res] == [155] * 8


def test_sharded_tb_lane_cap_is_per_device(goldens, monkeypatch):
    """A traceback budget of one 512x512 lane per device splits a 16-pair
    CIGAR batch on the 8-device mesh into two dispatches of 8 lanes; the
    CIGARs are unchanged."""
    from miniwfa_tpu import Options
    from miniwfa_tpu.models import exact
    from miniwfa_tpu.parallel.batch import align_batch_sharded
    from miniwfa_tpu.parallel.mesh import make_mesh

    c = next(c for c in goldens["cases"] if c["name"] == "t3")
    pairs = ([(c["t"], c["q"])] * 3 + [("A", "G")]) * 4
    seen = _spy_sharded(monkeypatch)
    monkeypatch.setattr(exact, "_budgets", lambda: (
        512 * 512, exact.CPU_PASS1_SNAP_BUDGET))
    res = align_batch_sharded(pairs, Options(cigar=True), make_mesh())
    assert [b for _, b, _, _ in seen] == [8, 8]
    for j, r in enumerate(res):
        want = (4, "1X") if j % 4 == 3 else (155, "1X16=1X14=128I4=1X24=")
        assert (r.s, r.cigar_str) == want
