"""Headline benchmark: single-chip GCUPS on a synthetic protein database.

Prints ONE JSON line:
  {"metric": "GCUPS", "value": N, "unit": "GCUPS", "vs_baseline": N/179}

GCUPS = query_residues x db_residues / (search_seconds x 1e9), the
reference's own metric (/root/reference/host/src/FPGAsearch.c:324), counted
over TRUE residues (padding cells are not credited).  vs_baseline compares
against the reference's best published number, 179 GCUPS for the hybrid
2x Xeon E5-2670 + Stratix V system (/root/reference/README.md:23).
"""

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

import jax

from oswald_tpu.io import pack_sequences
from oswald_tpu.engine import SearchEngine, SearchConfig


def _emit(record, file, device):
    """One JSON result row, naming the device it was measured on."""
    print(json.dumps({**record, "device": device}), file=file)


def make_synthetic_db(n_seqs: int, mean_len: int, rng):
    """Length distribution roughly like a protein DB: lognormal, clipped."""
    lengths = np.clip(
        rng.lognormal(np.log(mean_len), 0.45, n_seqs).astype(np.int64),
        32, 4 * mean_len)
    flat = rng.integers(0, 23, size=int(lengths.sum())).astype(np.int8)
    titles = [f"synthetic_{i}" for i in range(n_seqs)]
    return pack_sequences(flat, lengths, titles)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seqs", type=int, default=None)
    p.add_argument("--mean-len", type=int, default=256)
    p.add_argument("--qlen", type=int, default=512)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--matrix", default="blosum62")
    p.add_argument("--u-rows", type=int, default=8)
    p.add_argument("--suite", action="store_true",
                   help="also run the config suite (query-length "
                        "sweep, multi-query batch, residency modes, "
                        "matrices); results to stderr")
    p.add_argument("--devices", type=int, default=1,
                   help="mesh size: >1 uses DistributedSearchEngine "
                        "over that many devices")
    p.add_argument("--cpu-rehearsal", action="store_true",
                   help="allow a run without a GPU (tiny sizes, Pallas "
                        "interpret mode); its numbers are not device "
                        "measurements")
    p.add_argument("--skip-parity", action="store_true",
                   help="skip the asserting hardware-parity pre-stage "
                        "(iteration only; recorded runs must include it)")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="disable the persistent compiled-program cache "
                        "(for measuring cold-compile costs)")
    p.add_argument("--realistic", action="store_true",
                   help="realistic-composition validation run instead of "
                        "the headline bench: SwissProt-shaped lengths + "
                        "Robinson-Robinson residue frequencies through "
                        "streaming preprocess, precompute and host_stream "
                        "searches, alignment, and E-value sanity checks "
                        "(random query => top E ~ O(1); planted homolog "
                        "=> E << 1); rows to stderr, one summary JSON "
                        "line to stdout")
    args = p.parse_args()

    dev = jax.devices()[0]
    on_gpu = dev.platform == "gpu"
    if not on_gpu and not args.cpu_rehearsal:
        print(f"bench: no GPU (JAX platform {dev.platform!r}); pass "
              f"--cpu-rehearsal for a run that measures nothing",
              file=sys.stderr)
        return 1
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count()}

    if not args.no_compile_cache:
        # the persistent compile cache is part of the deployment story the
        # bench certifies: a warmed cache makes the parity gate and setup
        # reflect a restarted deployment, not a first-ever install
        from oswald_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()

    # Asserting correctness gate: the compiled kernel (the exact binary
    # the timings below run) must match the independent oracle BEFORE any
    # number is recorded — a perf figure without it could certify a fast
    # miscompile.  Any mismatch fails the bench (rc 2).
    parity = {"parity": "skipped"}
    if not args.skip_parity:
        from oswald_tpu.utils.parity import run_parity
        # a CPU rehearsal interprets the kernel (already CI-covered):
        # keep the gate's runtime proportionate with a smaller database
        parity = run_parity(n=4096 if on_gpu else 128,
                            lmax=700 if on_gpu else 200,
                            titin_sample=256 if on_gpu else 4,
                            log=lambda m: print(m, file=sys.stderr))
        if parity["parity"] != "ok":
            print(json.dumps(parity), file=sys.stderr)
            print(json.dumps({"metric": "GCUPS", "value": 0.0,
                              "unit": "GCUPS", "vs_baseline": 0.0,
                              "parity": "FAIL", "device": device}))
            sys.exit(2)
    if args.realistic:
        return run_realistic(args, on_gpu, parity, device)

    # default db near SwissProt scale; larger DBs amortise per-bin
    # overheads and pad less (sorted groups get tighter)
    n_seqs = args.seqs if args.seqs is not None else (300_000 if on_gpu
                                                     else 2_048)
    iters = args.iters if on_gpu else 1

    rng = np.random.default_rng(0)
    db = make_synthetic_db(n_seqs, args.mean_len, rng)
    query = rng.integers(0, 23, size=args.qlen).astype(np.int8)

    cfg = SearchConfig(matrix=args.matrix, u_rows=args.u_rows)
    t0 = time.perf_counter()
    if args.devices > 1:
        from oswald_tpu.dist import DistributedSearchEngine, make_device_mesh
        eng = DistributedSearchEngine(db, cfg,
                                      mesh=make_device_mesh(args.devices))
    else:
        eng = SearchEngine(db, cfg)
    setup_s = time.perf_counter() - t0

    # warm-up: compile every bin's program
    eng.search(query)

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        res = eng.search(query)
        times.append(time.perf_counter() - t0)
    dt = min(times)

    cells = args.qlen * db.n_residues
    gcups_single = cells / dt / 1e9

    # Headline: sustained throughput over a query batch (the reference's
    # published numbers are likewise over query-set runs); the batch
    # amortises the per-search host sync.
    nq = 10 if on_gpu else 2
    queries = [rng.integers(0, 23, size=args.qlen).astype(np.int8)
               for _ in range(nq)]
    eng.search_many(queries)     # compile
    btimes = []
    for _ in range(max(iters // 2, 1)):
        t0 = time.perf_counter()
        eng.search_many(queries)
        btimes.append(time.perf_counter() - t0)
    bdt = min(btimes)
    gcups = nq * args.qlen * db.n_residues / bdt / 1e9
    padded = sum(db.bins[L]["seq"].shape[0] * L * 1024
                 for L in db.bin_lengths)
    info = {
        "device": device, "n_seqs": db.n_seqs,
        "db_residues": db.n_residues, "qlen": args.qlen,
        "pad_overhead": round(padded / db.n_residues, 3),
        "single_query_gcups": round(gcups_single, 2),
        "single_query_s": round(dt, 4),
        "batch_n": nq, "batch_s": round(bdt, 4),
        "setup_s": round(setup_s, 2),
        "top1": int(res.scores[0]),
    }
    print(json.dumps(info), file=sys.stderr)

    if args.suite:
        run_suite(db, eng, rng, on_gpu, file=sys.stderr, qlen=args.qlen,
                  device=device)

    # the parity certificate rides the recorded tail next to the number it
    # certifies
    print(json.dumps(parity), file=sys.stderr)
    print(json.dumps({"metric": "GCUPS", "value": round(gcups, 2),
                      "unit": "GCUPS",
                      "vs_baseline": round(gcups / 179.0, 3),
                      "parity": parity["parity"], "device": device}))


def run_realistic(args, on_gpu, parity, device):
    """Realistic-composition validation: everything the uniform-random
    headline never exercises — length spikes, fragment
    tails, biased residue composition, the streaming preprocess at
    corpus scale, and the significance fit against data whose scores are
    composition-dependent.  Matches the reference's Environmental NR
    benchmark conditions (/root/reference/README.md:23) as closely as an
    offline rig allows."""
    import tempfile
    from oswald_tpu.io.synth import (make_realistic_corpus, mutate,
                                     realistic_residues)
    from oswald_tpu.io.stream import preprocess_db_streaming
    from oswald_tpu.io.synth import write_fasta
    from oswald_tpu.io.db import load_db

    emit = functools.partial(_emit, file=sys.stderr, device=device)
    rng = np.random.default_rng(7)
    n_seqs = args.seqs if args.seqs is not None else (300_000 if on_gpu
                                                     else 2_048)
    # the planted true positives: homologs of query_hom at ~60% identity
    query = realistic_residues(rng, args.qlen)
    query_hom = realistic_residues(rng, 360)
    planted = [mutate(query_hom, rng, identity=0.6) for _ in range(3)]
    flat, lengths, titles = make_realistic_corpus(rng, n_seqs,
                                                  planted=planted)

    with tempfile.TemporaryDirectory() as td:
        fasta = os.path.join(td, "realistic.fasta")
        write_fasta(fasta, flat, lengths, titles)
        fa_bytes = os.path.getsize(fasta)
        t0 = time.perf_counter()
        # the out-of-core path on purpose: this is the most-used entry
        # point of the reference (sequences.c:4-220) and the corpus is
        # big enough to be a meaningful GB/s row
        preprocess_db_streaming(fasta, os.path.join(td, "rdb"))
        prep_s = time.perf_counter() - t0
        db = load_db(os.path.join(td, "rdb"))
        emit({
            "config": "realistic_preprocess", "fasta_mb":
            round(fa_bytes / 2**20, 1), "n_seqs": db.n_seqs,
            "residues": db.n_residues, "preprocess_s": round(prep_s, 2),
            "mb_per_s": round(fa_bytes / 2**20 / prep_s, 1)})

        padded = sum(db.bins[L]["seq"].shape[0] * L * 1024
                     for L in db.bin_lengths)
        cfg = SearchConfig(matrix=args.matrix)
        eng = SearchEngine(db, cfg)

        # random query: throughput + null-model sanity (its best hits are
        # chance hits, so the smallest reported E-value should be O(1) —
        # a tiny E here would mean the fit calls noise significant)
        eng.search(query)
        t0 = time.perf_counter()
        res = eng.search(query)
        dt = time.perf_counter() - t0
        gcups = args.qlen * db.n_residues / dt / 1e9
        e_top = float(res.evalues[0]) if res.evalues is not None else None
        emit({
            "config": "realistic_random_query", "qlen": args.qlen,
            "gcups": round(gcups, 2), "search_s": round(dt, 4),
            "pad_overhead": round(padded / db.n_residues, 3),
            "top1_score": int(res.scores[0]),
            "top1_evalue": None if e_top is None else float(f"{e_top:.3g}"),
            "null_ok": bool(e_top is None or e_top > 0.01)})

        # sustained throughput on the realistic mix: a 10-query batch
        # (the headline's own protocol) — fragments and giants amortise
        # their per-bin dispatches inside the batched programs
        queries = [realistic_residues(rng, args.qlen) for _ in range(10)]
        eng.search_many(queries)
        t0 = time.perf_counter()
        eng.search_many(queries)
        bdt = time.perf_counter() - t0
        emit({
            "config": "realistic_batch10", "qlen": args.qlen,
            "gcups": round(10 * args.qlen * db.n_residues / bdt / 1e9, 2),
            "batch_s": round(bdt, 4)})

        # planted homologs: the parent query must pull its three mutated
        # copies to the top with E << 1 (the true-positive control)
        rh = eng.search(query_hom)
        hits = [t for t in rh.titles[:3]]
        e_hom = float(rh.evalues[0]) if rh.evalues is not None else None
        planted_top = sum(1 for t in hits if t.startswith("planted_"))
        emit({
            "config": "realistic_planted_homologs",
            "top3_titles": hits,
            "planted_in_top3": planted_top,
            "top1_evalue": None if e_hom is None else float(f"{e_hom:.3g}"),
            "homolog_ok": bool(planted_top == 3 and
                               (e_hom is None or e_hom < 1e-10))})

        # alignment post-pass over the top hit (exercises traceback on
        # realistic data; its score must equal the search's)
        aln = eng.align(query_hom, rh)[0]
        emit({
            "config": "realistic_alignment",
            "aln_score": int(aln.score), "search_score": int(rh.scores[0]),
            "identities": aln.identities,
            "aln_ok": bool(int(aln.score) == int(rh.scores[0]))})

        # larger-than-HBM path on the same corpus
        import gc
        eng.prof_flat = None
        eng.tail_flats = {}
        gc.collect()
        hs = SearchEngine(db, SearchConfig(matrix=args.matrix,
                                           profile_mode="host_stream"))
        hs.search(query)
        t0 = time.perf_counter()
        hs.search(query)
        dt_hs = time.perf_counter() - t0
        emit({
            "config": "realistic_host_stream",
            "gcups": round(args.qlen * db.n_residues / dt_hs / 1e9, 2),
            "search_s": round(dt_hs, 4)})

        ok = (res.scores[0] >= 0 and planted_top == 3 and
              int(aln.score) == int(rh.scores[0]))
        emit(parity)
        print(json.dumps({
            "metric": "GCUPS_realistic", "value": round(gcups, 2),
            "unit": "GCUPS", "vs_baseline": round(gcups / 179.0, 3),
            "parity": parity["parity"],
            "checks_ok": bool(ok), "device": device}))
        return 0 if ok else 3


def run_suite(db, eng, rng, on_gpu, file, qlen=512, device=None):
    """Query-length sweep, short-query stream, multi-query batch,
    residency modes, the mesh-of-one engine, and a matrix sweep (compiled
    programs are matrix-independent, so that mostly measures profile
    rebuild).  Every row names the device."""
    emit = functools.partial(_emit, file=file, device=device)

    from oswald_tpu.engine import SearchEngine, SearchConfig

    # query-length sweep (titin-like 5478 included on the GPU); the loop
    # variable must not shadow qlen, which the mesh-of-one row uses
    for ql in ([64, 512, 2048, 5478] if on_gpu else [64]):
        q = rng.integers(0, 23, size=ql).astype(np.int8)
        eng.search(q)      # compile
        t0 = time.perf_counter()
        eng.search(q)
        dt = time.perf_counter() - t0
        emit({"config": "qlen_sweep", "qlen": ql,
                          "gcups": round(ql * db.n_residues / dt / 1e9, 2),
                          "search_s": round(dt, 4)})

    # pipelined single-query stream at qlen 64: the latency-hiding mode
    # for sequential short-query clients (dispatch i+1 before reading i;
    # engine.search_stream) vs the same queries searched serially
    nq64 = 8 if on_gpu else 2
    qs64 = [rng.integers(0, 23, size=64).astype(np.int8)
            for _ in range(nq64)]
    eng.search_stream(qs64)    # compile
    t0 = time.perf_counter()
    eng.search_stream(qs64)
    dt_p = time.perf_counter() - t0
    t0 = time.perf_counter()
    for q in qs64:
        eng.search(q)
    dt_s = time.perf_counter() - t0
    emit({
        "config": "qlen64_pipelined_stream", "n_queries": nq64,
        "gcups": round(nq64 * 64 * db.n_residues / dt_p / 1e9, 2),
        "serial_gcups": round(nq64 * 64 * db.n_residues / dt_s / 1e9, 2),
        "search_s": round(dt_p, 4)})

    # 20-query mixed-length batch, packed (seg_map) vs unpacked
    nq = 20 if on_gpu else 3
    queries = [rng.integers(0, 23, size=int(l)).astype(np.int8)
               for l in rng.integers(100, 400, size=nq)]
    eng.search_many(queries)   # compile
    t0 = time.perf_counter()
    eng.search_many(queries)
    dt = time.perf_counter() - t0
    Q = sum(len(q) for q in queries)
    pack_rows = eng.config.batch_query_pack_rows
    try:
        eng.config.batch_query_pack_rows = 0     # disable packing
        eng.search_many(queries)  # compile unpacked
        t0 = time.perf_counter()
        eng.search_many(queries)
        dt_u = time.perf_counter() - t0
    finally:
        eng.config.batch_query_pack_rows = pack_rows
    emit({"config": "multi_query", "n_queries": nq,
                      "gcups": round(Q * db.n_residues / dt / 1e9, 2),
                      "unpacked_gcups": round(Q * db.n_residues / dt_u / 1e9,
                                              2),
                      "search_s": round(dt, 4)})

    # release the headline engine's device memory (its profiles) before
    # constructing more engines — the suite otherwise accumulates engines
    # until the device allocator fragments/exhausts
    import gc
    eng.prof_flat = None
    eng.tail_flats = {}
    gc.collect()

    # stream mode: residues resident, profiles rebuilt per chunk in-scan
    # (the 24x-less-HBM middle mode)
    st = SearchEngine(db, SearchConfig(profile_mode="stream"))
    q = rng.integers(0, 23, size=512).astype(np.int8)
    st.search(q)           # compile
    t0 = time.perf_counter()
    st.search(q)
    dt = time.perf_counter() - t0
    emit({"config": "stream_mode", "qlen": 512,
                      "gcups": round(512 * db.n_residues / dt / 1e9, 2),
                      "search_s": round(dt, 4)})
    del st
    gc.collect()

    # beyond-reference query lengths: the reference hard-caps at 5478
    # (its FPGA channel depth, sw.cl:5); here the cap is a flag and the
    # planner budgets the configured worst case.  Run m = 8192 and 16384
    # end to end on the device (exactness is pinned vs the oracle at
    # m=8192/9000 on the CPU, tests/test_engine.py)
    if on_gpu:
        lq = SearchEngine(db, SearchConfig(max_query_len=16384))
        for ql in (8192, 16384):
            q = rng.integers(0, 23, size=ql).astype(np.int8)
            lq.search(q)
            t0 = time.perf_counter()
            r = lq.search(q)
            dt = time.perf_counter() - t0
            emit({
                "config": "beyond_reference_qlen", "qlen": ql,
                "gcups": round(ql * db.n_residues / dt / 1e9, 2),
                "search_s": round(dt, 4), "top1": int(r.scores[0])})
        del lq
        gc.collect()

    # larger-than-HBM data path: force the planner's last-resort mode (as
    # if the packed DB exceeded device memory) and measure the streamed
    # throughput — the reference's bounded-chunk streaming analog
    # (FPGAsearch.c:180-237).  Slices coalesce across bin boundaries
    # into flat transfer buffers (engine _init_host_stream); the default
    # 256 MiB budget makes this database ONE transfer, so the
    # double-buffering A/B runs at a 16 MiB budget (multiple slices) and
    # a longer query (compute large enough to hide under)
    hs = SearchEngine(db, SearchConfig(profile_mode="host_stream"))
    q = rng.integers(0, 23, size=512).astype(np.int8)
    hs.search(q)           # compile
    t0 = time.perf_counter()
    hs.search(q)
    dt = time.perf_counter() - t0
    emit({"config": "host_stream", "qlen": 512,
                      "slices": len(hs._hs_slices),
                      "gcups": round(512 * db.n_residues / dt / 1e9, 2),
                      "search_s": round(dt, 4)})
    del hs
    gc.collect()
    q2 = rng.integers(0, 23, size=2048).astype(np.int8)
    hs2 = SearchEngine(db, SearchConfig(profile_mode="host_stream",
                                        host_stream_slice_mb=16))
    hs2.search(q2)
    t0 = time.perf_counter()
    hs2.search(q2)
    dt = time.perf_counter() - t0
    # the double-buffering proof: the same sweep with overlap disabled
    # (serial transfer -> compute -> readback per slice); overlap_ratio =
    # serial/overlapped time, >1 means the transfer hides under compute
    hs2.config.host_stream_overlap = False
    hs2.search(q2)
    t0s = time.perf_counter()
    hs2.search(q2)
    dt_serial = time.perf_counter() - t0s
    hs2.config.host_stream_overlap = True
    emit({"config": "host_stream_overlap_ab", "qlen": 2048,
                      "slice_mb": 16, "slices": len(hs2._hs_slices),
                      "gcups": round(2048 * db.n_residues / dt / 1e9, 2),
                      "search_s": round(dt, 4),
                      "serial_s": round(dt_serial, 4),
                      "overlap_ratio": round(dt_serial / dt, 3)})
    del hs2
    gc.collect()

    # distributed engine on a mesh of 1: setup (one compiled sharded
    # profile build) and search overhead vs the single-device engine,
    # i.e. the shard_map + collective cost at N=1
    from oswald_tpu.dist import DistributedSearchEngine, make_device_mesh
    t0 = time.perf_counter()
    de = DistributedSearchEngine(db, SearchConfig(),
                                 mesh=make_device_mesh(1))
    d_setup = time.perf_counter() - t0
    q = rng.integers(0, 23, size=qlen).astype(np.int8)
    de.search(q)           # compile
    t0 = time.perf_counter()
    de.search(q)
    dt = time.perf_counter() - t0
    emit({"config": "dist_mesh1", "setup_s": round(d_setup, 2),
                      "gcups": round(qlen * db.n_residues / dt / 1e9, 2),
                      "search_s": round(dt, 4)})
    del de
    gc.collect()

    # matrices: engine setup (profile gather) + one search per matrix
    for m in (("pam30", "blosum90") if on_gpu else ("pam30",)):
        t0 = time.perf_counter()
        e2 = SearchEngine(db, SearchConfig(matrix=m))
        setup = time.perf_counter() - t0
        q = rng.integers(0, 23, size=256).astype(np.int8)
        e2.search(q)
        t0 = time.perf_counter()
        e2.search(q)
        dt = time.perf_counter() - t0
        emit({"config": "matrix", "matrix": m,
                          "setup_s": round(setup, 2),
                          "gcups": round(256 * db.n_residues / dt / 1e9, 2)})
        del e2
        gc.collect()


if __name__ == "__main__":
    sys.exit(main())
