"""Larger-than-HBM data path: host_stream parity + capacity planner.

The reference streams arbitrarily large databases through the device in
bounded chunks (/root/reference/host/src/FPGAsearch.c:180-237) and caps the
chunk size at 0.8x device global memory (utils.c:162-168).  These tests
force the analog here (host-resident mmap bins streamed slice by slice,
planner-selected) on small databases via artificial HBM budgets.
"""

import numpy as np

from oswald_tpu.io import pack_sequences
from oswald_tpu.io.db import save_db, load_db
from oswald_tpu.engine import SearchEngine, SearchConfig
from oswald_tpu.engine.planner import (
    plan_profile_mode, db_padded_bytes, SAFETY_FRACTION,
)

from conftest import random_protein


def _make_db(rng, n, lmax, bin_cost=None):
    lengths = rng.integers(1, lmax, size=n)
    seqs = [random_protein(rng, int(l)) for l in lengths]
    db = pack_sequences(np.concatenate(seqs), lengths,
                        [f"s{i}" for i in range(n)],
                        **({"bin_cost": bin_cost} if bin_cost else {}))
    return db


def test_host_stream_matches_precompute(rng):
    # ~20 groups over several thin bins against a 1 MiB slice budget:
    # slices must coalesce spans across bin boundaries AND split into
    # multiple transfers; group_block=2 exercises the padded-span path
    db = _make_db(rng, 19000, 300)
    q = random_protein(rng, 77)
    pre = SearchEngine(db, SearchConfig(top=20, profile_mode="precompute"))
    hs = SearchEngine(db, SearchConfig(top=20, profile_mode="host_stream",
                                       host_stream_slice_mb=1,
                                       group_block=1))
    assert len(hs._hs_slices) > 1, \
        "test should exercise multiple coalesced slices"
    assert any(len(spans) > 1 for _, spans in hs._hs_slices), \
        "test should exercise a multi-span (cross-bin) slice"
    hs_pad = SearchEngine(db, SearchConfig(top=20,
                                           profile_mode="host_stream",
                                           host_stream_slice_mb=1,
                                           group_block=2))
    assert hs_pad.n_slots > hs.n_slots       # padded groups appended
    r_pre, r_hs, r_pad = pre.search(q), hs.search(q), hs_pad.search(q)
    for r in (r_hs, r_pad):
        np.testing.assert_array_equal(r_pre.scores, r.scores)
        np.testing.assert_array_equal(r_pre.seq_ids, r.seq_ids)
        assert r_pre.titles == r.titles
    # full score surface too (not just the top-k)
    s_pre = np.asarray(pre.score_all(q))[np.asarray(pre.valid)]
    s_hs = np.asarray(hs.score_all(q))[hs.ids_flat >= 0]
    np.testing.assert_array_equal(s_pre, s_hs)


def test_host_stream_from_mmap_artifact(tmp_path, rng):
    """host_stream over a memory-mapped .oswt (the real deployment shape:
    the packed DB never fully materialises in host RAM)."""
    db = _make_db(rng, 1200, 150)
    save_db(db, str(tmp_path / "d"))
    mdb = load_db(str(tmp_path / "d"))          # mmap'd arrays
    q = random_protein(rng, 40)
    pre = SearchEngine(db, SearchConfig(top=8))
    hs = SearchEngine(mdb, SearchConfig(top=8, profile_mode="host_stream",
                                        host_stream_slice_mb=1))
    r1, r2 = pre.search(q), hs.search(q)
    np.testing.assert_array_equal(r1.scores, r2.scores)
    np.testing.assert_array_equal(r1.seq_ids, r2.seq_ids)


def test_host_stream_batch(rng):
    db = _make_db(rng, 900, 120)
    queries = [random_protein(rng, int(l)) for l in (30, 33, 90, 5)]
    pre = SearchEngine(db, SearchConfig(top=7))
    hs = SearchEngine(db, SearchConfig(top=7, profile_mode="host_stream",
                                       host_stream_slice_mb=1))
    r_pre = pre.search_many(queries, batch=True)
    r_hs = hs.search_many(queries, batch=True)
    for a, b in zip(r_pre, r_hs):
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.seq_ids, b.seq_ids)


def test_host_stream_serial_matches_overlap(rng):
    """host_stream_overlap=False (the forced-serial A/B used to measure
    the double-buffering win) is schedule-only: results are bit-identical
    on both engines.  The overlap RATIO itself is measured on hardware by
    bench.py --suite (SCALING.md records it)."""
    from oswald_tpu.dist import DistributedSearchEngine
    db = _make_db(rng, 40000, 60)
    q = random_protein(rng, 61)
    base = SearchConfig(top=15, profile_mode="host_stream",
                        host_stream_slice_mb=1)
    ser_cfg = SearchConfig(top=15, profile_mode="host_stream",
                           host_stream_slice_mb=1,
                           host_stream_overlap=False)
    ov = SearchEngine(db, base)
    ser = SearchEngine(db, ser_cfg)
    assert len(ov._hs_slices) >= 2
    r_ov, r_ser = ov.search(q), ser.search(q)
    np.testing.assert_array_equal(r_ov.scores, r_ser.scores)
    np.testing.assert_array_equal(r_ov.seq_ids, r_ser.seq_ids)
    d_ov = DistributedSearchEngine(db, base)
    d_ser = DistributedSearchEngine(db, ser_cfg)
    rd_ov, rd_ser = d_ov.search(q), d_ser.search(q)
    np.testing.assert_array_equal(rd_ov.scores, rd_ser.scores)
    np.testing.assert_array_equal(rd_ov.seq_ids, rd_ser.seq_ids)
    np.testing.assert_array_equal(r_ov.scores, rd_ov.scores)


def test_planner_mode_selection(rng):
    db = _make_db(rng, 1100, 100)
    assert db_padded_bytes(db) > 0
    # budgets composed from the plan's own residency estimates (on a tiny
    # DB the scan-state floor dominates the residue bytes, so raw
    # multiples of db_padded_bytes don't hit the intended thresholds)
    est = plan_profile_mode(db, hbm_bytes=1)     # fields only
    assert est.mode == "host_stream"

    def hbm_for(resident):
        # smallest budget whose SAFETY_FRACTION share covers `resident`
        return int(resident / SAFETY_FRACTION) + 1024

    # profiles + state fit -> precompute
    assert plan_profile_mode(
        db, hbm_bytes=hbm_for(est.profile_bytes + est.state_bytes)
    ).mode == "precompute"
    # residues + state fit but 24x profiles don't -> stream
    assert plan_profile_mode(
        db, hbm_bytes=hbm_for(est.db_bytes + est.state_bytes)
    ).mode == "stream"
    # not even the residues fit -> host_stream
    assert plan_profile_mode(
        db, hbm_bytes=hbm_for(est.state_bytes) // 2).mode == "host_stream"
    # sharding over devices shrinks the per-device share enough that the
    # same budget now admits full precompute residency
    assert plan_profile_mode(
        db, hbm_bytes=hbm_for(est.db_bytes + est.state_bytes),
        n_devices=64).mode == "precompute"


def test_planner_budgets_for_configured_max_query(rng):
    """Long-query safety: the planner sizes scan state from
    SearchConfig.max_query_len, so a budget that admits precompute for
    short-query engines degrades (stream -> host_stream) when the engine
    must also accept titin-scale queries — instead of OOM-ing at query
    time (the reference's chunk cap never OOMs by construction,
    utils.c:162-168)."""
    db = _make_db(rng, 1100, 100)
    short = plan_profile_mode(db, hbm_bytes=None, max_query_len=64)
    long = plan_profile_mode(db, hbm_bytes=None, max_query_len=5478)
    assert long.state_bytes > short.state_bytes * 5   # 5632 vs 64 rows
    # a budget tailored to JUST fit precompute at the short cap...
    budget = int((short.profile_bytes + short.state_bytes)
                 / SAFETY_FRACTION) + 1024
    assert plan_profile_mode(
        db, hbm_bytes=budget, max_query_len=64).mode == "precompute"
    # ...degrades once the engine must accept titin
    degraded = plan_profile_mode(db, hbm_bytes=budget, max_query_len=5478)
    assert degraded.mode in ("stream", "host_stream")
    assert "degraded from precompute" in degraded.describe()
    # and the engine end-to-end: auto + the same budget + titin cap picks
    # the degraded mode and still searches correctly
    eng = SearchEngine(db, SearchConfig(
        top=5, profile_mode="auto", hbm_budget_bytes=budget,
        max_query_len=5478, host_stream_slice_mb=1))
    assert eng.mode == degraded.mode
    q = random_protein(rng, 30)
    ref = SearchEngine(db, SearchConfig(top=5, profile_mode="precompute"))
    np.testing.assert_array_equal(eng.search(q).scores, ref.search(q).scores)


def test_over_cap_query_rejected_not_oomed(rng):
    """Queries past the configured cap are rejected with a clear error on
    every entry path (search, search_many packed and batched) BEFORE any
    device work."""
    import pytest
    db = _make_db(rng, 600, 80)
    eng = SearchEngine(db, SearchConfig(top=5, max_query_len=64))
    ok = random_protein(rng, 64)
    too_long = random_protein(rng, 65)
    eng.search(ok)                                     # cap-length fine
    with pytest.raises(ValueError, match="max_query_len"):
        eng.search(too_long)
    with pytest.raises(ValueError, match="max_query_len"):
        eng.search_many([ok, too_long])
    with pytest.raises(ValueError, match="max_query_len"):
        eng.search_many([too_long, too_long, too_long], batch=False)
    # warmup never tries to compile past the cap
    pads = eng.warmup(max_query_len=512, batch=False)
    assert max(pads) <= 64
    from oswald_tpu.dist import DistributedSearchEngine
    deng = DistributedSearchEngine(db, SearchConfig(top=5, max_query_len=64))
    with pytest.raises(ValueError, match="max_query_len"):
        deng.search(too_long)
    with pytest.raises(ValueError, match="max_query_len"):
        deng.search_many([ok, too_long])


def test_auto_mode_resolves_and_searches(rng, capsys):
    db = _make_db(rng, 600, 80)
    padded = db_padded_bytes(db)
    eng = SearchEngine(db, SearchConfig(
        top=5, profile_mode="auto", hbm_budget_bytes=padded // 4,
        host_stream_slice_mb=1))
    assert eng.mode == "host_stream"
    err = capsys.readouterr().err                # stderr keeps --json clean
    assert "profile_mode=host_stream" in err     # planner announces choice
    q = random_protein(rng, 25)
    ref = SearchEngine(db, SearchConfig(top=5, profile_mode="precompute"))
    np.testing.assert_array_equal(eng.search(q).scores, ref.search(q).scores)


def test_dist_host_stream_matches_single_chip(rng):
    """Distributed host_stream on the virtual 8-device mesh: a database
    that exceeds the mesh's aggregate HBM budget streams through all
    devices slice by slice and must match the resident-mode results
    exactly (top-k scores, ids and titles)."""
    from oswald_tpu.dist import DistributedSearchEngine
    # many short sequences in one bin: the bin spans several
    # ndev*group_block slice quanta, so the sweep runs the multi-slice
    # double-buffered loop and a padded final slice
    db = _make_db(rng, 40000, 60)
    q = random_protein(rng, 77)
    pre = SearchEngine(db, SearchConfig(top=20, profile_mode="precompute"))
    dist = DistributedSearchEngine(db, SearchConfig(
        top=20, profile_mode="host_stream", host_stream_slice_mb=1))
    assert len(dist._hs_slices) > len(db.bin_lengths), \
        "test should exercise multiple slices per bin"
    r_pre, r_hs = pre.search(q), dist.search(q)
    np.testing.assert_array_equal(r_pre.scores, r_hs.scores)
    np.testing.assert_array_equal(r_pre.seq_ids, r_hs.seq_ids)
    assert r_pre.titles == r_hs.titles


def test_dist_host_stream_auto_plan(rng, capsys):
    """auto + a tiny budget resolves to host_stream on a mesh (it used to
    raise NotImplementedError) and still searches correctly."""
    from oswald_tpu.dist import DistributedSearchEngine
    db = _make_db(rng, 600, 80)
    eng = DistributedSearchEngine(db, SearchConfig(
        top=5, profile_mode="auto", hbm_budget_bytes=1024,
        host_stream_slice_mb=1))
    assert eng.mode == "host_stream"
    assert "profile_mode=host_stream" in capsys.readouterr().err
    ref = SearchEngine(db, SearchConfig(top=5, profile_mode="precompute"))
    q = random_protein(rng, 25)
    np.testing.assert_array_equal(eng.search(q).scores, ref.search(q).scores)


def test_dist_host_stream_batch(rng):
    """Batched host_stream on the mesh: one streaming sweep per padded
    length, parity with sequential searches."""
    from oswald_tpu.dist import DistributedSearchEngine
    db = _make_db(rng, 900, 120)
    queries = [random_protein(rng, int(l)) for l in (30, 33, 90, 5)]
    dist = DistributedSearchEngine(db, SearchConfig(
        top=7, profile_mode="host_stream", host_stream_slice_mb=1))
    batched = dist.search_many(queries, batch=True)
    seq_res = dist.search_many(queries, batch=False)
    for rb, rs in zip(batched, seq_res):
        np.testing.assert_array_equal(rb.scores, rs.scores)
        np.testing.assert_array_equal(rb.seq_ids, rs.seq_ids)


def test_planner_budgets_engine_pad_quanta(rng):
    """ADVICE r4: the planner must budget the ENGINE'S effective padded
    rows, not the default formula — an engine configured with a coarser
    query_pad_quantum allocates more scan state than the default pad
    would, and the plan must reserve for it."""
    from oswald_tpu.engine import SearchConfig
    db = _make_db(rng, 1100, 100)
    base = plan_profile_mode(db, hbm_bytes=None, max_query_len=5478)
    coarse = plan_profile_mode(
        db, hbm_bytes=None, max_query_len=5478,
        config=SearchConfig(query_pad_quantum=1024))
    # titin pads to 6144 rows at quantum 1024 vs 5632 default
    assert coarse.state_bytes > base.state_bytes
    # and the pack-row budget is a floor for short-cap engines
    short = plan_profile_mode(
        db, hbm_bytes=None, max_query_len=64,
        config=SearchConfig(batch_query_pack_rows=1024))
    plain = plan_profile_mode(db, hbm_bytes=None, max_query_len=64)
    assert short.state_bytes >= plain.state_bytes


def test_host_stream_adaptive_slice_budget(rng):
    """A database smaller than the configured slice budget must still cut
    into multiple slices (the double buffer needs >= 2 to overlap) — the
    round-5 adaptive budget aims for ~8; an explicitly smaller configured
    budget is honored as-is."""
    db = _make_db(rng, 60000, 800)          # ~30+ MB packed
    hs = SearchEngine(db, SearchConfig(profile_mode="host_stream",
                                       host_stream_slice_mb=256))
    assert len(hs._hs_slices) >= 2, hs._hs_slices
    tiny = SearchEngine(db, SearchConfig(profile_mode="host_stream",
                                         host_stream_slice_mb=1))
    assert len(tiny._hs_slices) > len(hs._hs_slices)
