"""Command-line interface: preprocess | search | info.

Flag-compatible surface with the reference CLI
(/root/reference/host/src/arguments.c:10-39, main.c:35-67): the same
single-letter search flags (-q -d -s -g -e -r) with the same defaults and
the same report fields (per-query top-k table, search time, GCUPS;
FPGAsearch.c:311-331).  Device-specific reference flags (-m execution mode,
-v vector length, -f num FPGAs, -k chunk size, -p calibration percentage,
-b block width, -c threads) have no meaning here and are replaced by
`--devices` (mesh size) and the engine tuning flags.
"""

import argparse
import contextlib
import sys
import time


class _CLIError(Exception):
    """User-input error already formatted for the terminal."""


@contextlib.contextmanager
def _user_errors():
    """Convert user-input failures to _CLIError inside this block only, so
    internal errors elsewhere still traceback."""
    try:
        yield
    except (ValueError, FileNotFoundError) as e:
        raise _CLIError(str(e)) from e


def _add_engine_args(sp):
    """Flags shared by `search` and `serve`: everything that shapes the
    engine rather than a single query run."""
    sp.add_argument("-d", "--db", required=True,
                    help="preprocessed database path (.oswt)")
    sp.add_argument("-s", "--sm", default="blosum62",
                    help="substitution matrix: blosum45/50/62/80/90, "
                         "pam30/70/250 (default: blosum62)")
    sp.add_argument("-g", "--gap-open", type=int, default=10,
                    help="gap open penalty (default: 10)")
    sp.add_argument("-e", "--gap-extend", type=int, default=2,
                    help="gap extend penalty (default: 2)")
    sp.add_argument("-r", "--top", type=int, default=10,
                    help="number of scores to show (default: 10)")
    sp.add_argument("--devices", type=int, default=None,
                    help="devices in the search mesh (default: all; "
                         "1 = single-chip engine)")
    sp.add_argument("--distributed", action="store_true",
                    help="multi-host run: initialize jax.distributed "
                         "(cluster auto-discovery, e.g. SLURM or Open MPI) "
                         "before building the mesh; one process per host "
                         "drives all of that host's GPUs, every host runs "
                         "the same command, rank 0 prints")
    sp.add_argument("--profile-mode",
                    choices=("auto", "precompute", "stream", "host_stream"),
                    default="auto",
                    help="device data mode (default: auto — the device "
                         "capacity planner picks the fastest mode that "
                         "fits; host_stream handles databases larger than "
                         "device memory)")
    sp.add_argument("--hbm-budget-mb", type=int, default=None,
                    help="override the planner's device-memory budget "
                         "(MiB); mainly for testing the mode selection")
    sp.add_argument("--max-query-len", type=int, default=5478,
                    help="longest accepted query (default: 5478, titin — "
                         "the reference's own cap); the memory planner "
                         "budgets worst-case scan state for it, so "
                         "lowering it lets larger databases stay fully "
                         "resident on the device; longer queries are "
                         "rejected")
    _add_cache_args(sp)
    sp.add_argument("--u-rows", type=int, default=8,
                    help="query rows per thread per kernel step (kernel "
                         "geometry; see `oswald-tpu tune`)")
    sp.add_argument("--group-block", type=int, default=1,
                    help="groups whose lanes one thread advances in "
                         "lockstep (a power of two)")
    sp.add_argument("--col-unroll", type=int, default=1,
                    help="DP columns per kernel loop iteration")
    sp.add_argument("--stream-window", type=int, default=4,
                    help="pipelined-stream readback window: queries whose "
                         "packed outputs share one device->host transfer "
                         "(--no-batch / search_stream; 1 = one readback "
                         "per query)")


def _add_cache_args(sp):
    """Persistent compiled-program cache flags (the analog of the
    reference loading its precompiled sw.aocx, utils.c:144-150)."""
    sp.add_argument("--compile-cache", metavar="DIR", default=None,
                    help="persistent compiled-program cache directory "
                         "(default: <repo>/.jax_cache); compiled programs "
                         "are reused across processes, so a warmed "
                         "deployment restarts without recompiling.  "
                         "Ignored when JAX_COMPILATION_CACHE_DIR is set: "
                         "that directory is used")
    sp.add_argument("--no-compile-cache", action="store_true",
                    help="disable the persistent compile cache (ignored "
                         "when JAX_COMPILATION_CACHE_DIR is set)")


def _enable_cache(args):
    import os
    if getattr(args, "no_compile_cache", False) and \
            not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    from oswald_tpu.utils.compile_cache import enable_compile_cache
    return enable_compile_cache(getattr(args, "compile_cache", None))


def _add_search_args(sp):
    _add_engine_args(sp)
    sp.add_argument("-q", "--query", required=True,
                    help="query FASTA filename")
    sp.add_argument("--no-batch", action="store_true",
                    help="search queries one program at a time instead of "
                         "batching by padded length")
    sp.add_argument("--trace", metavar="DIR", default=None,
                    help="capture a jax.profiler device trace of the "
                         "search into DIR (view in TensorBoard/Perfetto)")
    sp.add_argument("--metrics", action="store_true",
                    help="print phase timing metrics after the report")
    sp.add_argument("--json", action="store_true",
                    help="machine-readable output: one JSON object per "
                         "query plus a run summary, instead of the text "
                         "report")
    sp.add_argument("-a", "--align", action="store_true",
                    help="print a gapped alignment (traceback) for every "
                         "reported hit — a host-side post-pass over the "
                         "top-k only (the reference is score-only)")
    sp.add_argument("--tab", action="store_true",
                    help="BLAST outfmt-6 tabular output (qseqid sseqid "
                         "pident length mismatch gapopen qstart qend "
                         "sstart send evalue bitscore), one line per hit "
                         "— computes alignments, replaces the text report")
    sp.add_argument("-H", "--histogram", action="store_true",
                    help="print the observed score histogram per query "
                         "with the expected chance counts under the "
                         "fitted null model (single-chip text mode; "
                         "re-scores the database once per query)")


def build_parser():
    p = argparse.ArgumentParser(
        prog="oswald-tpu",
        description="Smith-Waterman protein database search on GPUs")
    sub = p.add_subparsers(dest="op", required=True)

    pp = sub.add_parser("preprocess", help="FASTA -> packed database")
    pp.add_argument("-i", "--input", required=True,
                    help="input FASTA filename")
    pp.add_argument("-o", "--output", required=True,
                    help="output database path (writes <output>.oswt/)")
    pp.add_argument("--streaming", action="store_true",
                    help="out-of-core build (bounded host memory) for "
                         "databases larger than RAM; auto-enabled for "
                         "FASTA files over 2 GiB")
    pp.add_argument("--from-oswald", action="store_true",
                    help="INPUT is the base path of a database "
                         "preprocessed by the reference OSWALD "
                         "(<input>.desc/.info/.seq) instead of FASTA — "
                         "migrate without re-preprocessing")
    pp.add_argument("--to-oswald", action="store_true",
                    help="ALSO write the reference's "
                         "<output>.desc/.info/.seq triple next to the "
                         ".oswt — migrate back to OSWALD without the raw "
                         "FASTA")

    sp = sub.add_parser("search", help="search a packed database")
    _add_search_args(sp)

    sv = sub.add_parser(
        "serve",
        help="HTTP JSON search server over a warm engine (the reference "
             "is one-shot; serving keeps the compiled programs and device "
             "profiles resident across queries)")
    _add_engine_args(sv)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8731)
    sv.add_argument("--warmup-qlen", type=int, default=512,
                    help="precompile the padded-query ladder up to this "
                         "length before accepting requests (0 = skip; "
                         "default: 512)")
    sv.add_argument("--warmup-jobs", type=int, default=1,
                    help="parallel warmup steps (default 1 = serial; "
                         "see warmup_engine)")

    sub.add_parser("info", help="device information")

    tn = sub.add_parser(
        "tune",
        help="measure kernel-geometry candidates on the attached GPU "
             "and print the fastest --u-rows/--group-block/--col-unroll "
             "flags (run once per card model)")
    tn.add_argument("--m", type=int, default=512,
                    help="query rows of the synthetic workload")
    tn.add_argument("--groups", type=int, default=24)
    tn.add_argument("--chunks", type=int, default=8)
    tn.add_argument("--iters", type=int, default=3)
    tn.add_argument("--json", action="store_true",
                    help="print the full result object as JSON")
    _add_cache_args(tn)

    ca = sub.add_parser(
        "cache",
        help="manage the persistent compiled-program cache (pack a "
             "warmed cache into a shippable artifact / pre-seed a fresh "
             "deployment from one — the analog of the reference shipping "
             "its precompiled sw.aocx, utils.c:144-150)")
    ca.add_argument("action", choices=("pack", "unpack", "info"),
                    help="pack: cache dir -> tar.gz; unpack: tar.gz -> "
                         "cache dir (existing entries kept); info: entry "
                         "count and size")
    ca.add_argument("tar", nargs="?", default=None,
                    help="tarball path (required for pack/unpack)")
    ca.add_argument("--overwrite", action="store_true",
                    help="unpack: replace existing cache entries")
    _add_cache_args(ca)
    return p


def _build_engine(args):
    """Engine construction shared by `search` and `serve`: validate the
    scoring flags, load the database, build the (possibly distributed)
    engine.  Returns (db, engine, n_dev, setup_s)."""
    import jax
    _enable_cache(args)
    if getattr(args, "distributed", False):
        from oswald_tpu.dist import bootstrap
        bootstrap()
    from oswald_tpu.io.db import load_db
    from oswald_tpu.engine import SearchEngine, SearchConfig
    from oswald_tpu.submat import get_submat

    with _user_errors():
        get_submat(args.sm)
        cfg = SearchConfig(matrix=args.sm, open_gap=args.gap_open,
                           extend_gap=args.gap_extend, top=args.top,
                           u_rows=args.u_rows,
                           group_block=args.group_block,
                           col_unroll=args.col_unroll,
                           profile_mode=args.profile_mode,
                           stream_readback_window=args.stream_window,
                           max_query_len=args.max_query_len,
                           hbm_budget_bytes=args.hbm_budget_mb << 20
                           if args.hbm_budget_mb else None)
        n_dev = args.devices if args.devices is not None else \
            jax.device_count()
        if n_dev > 1:
            from oswald_tpu.dist import make_device_mesh
            mesh = make_device_mesh(n_dev)
        t_setup = time.perf_counter()
        db = load_db(args.db)

    if n_dev > 1:
        from oswald_tpu.dist import DistributedSearchEngine
        engine = DistributedSearchEngine(db, cfg, mesh=mesh)
    else:
        engine = SearchEngine(db, cfg)
    return db, engine, n_dev, time.perf_counter() - t_setup


def cmd_serve(args):
    from oswald_tpu.serve import serve_forever
    db, engine, _, setup_s = _build_engine(args)
    print(f"engine ready in {setup_s:.2f}s")
    return serve_forever(db, engine, args.host, args.port,
                         warmup_qlen=args.warmup_qlen or None,
                         warmup_jobs=args.warmup_jobs)


def cmd_preprocess(args):
    import os
    with _user_errors():
        if args.from_oswald:
            from oswald_tpu.io.db import import_reference_db, save_db
            db = import_reference_db(args.input)
            save_db(db, args.output)
            print(f"oswald-tpu preprocess: wrote {args.output}.oswt")
        else:
            size = os.path.getsize(args.input) \
                if os.path.exists(args.input) else 0
            if size:
                with open(args.input, "rb") as fh:
                    head = fh.read(6)
                if head[:2] == b"\x1f\x8b" or head[:3] == b"BZh" \
                        or head[:6] == b"\xfd7zXZ\x00":
                    size *= 4    # compressed: judge by ~decompressed size
            streaming = args.streaming or size > 2 << 30
            if streaming:
                from oswald_tpu.io.stream import preprocess_db_streaming
                preprocess_db_streaming(args.input, args.output)
            else:
                from oswald_tpu.io.db import preprocess_db
                preprocess_db(args.input, args.output)
        if args.to_oswald:
            # read back the artifact (mmap) so the export path is the
            # same for in-core, streaming, and imported builds
            from oswald_tpu.io.db import load_db, export_reference_db
            export_reference_db(load_db(args.output), args.output)
    return 0


def cmd_search(args):
    import jax
    from oswald_tpu.io.db import load_queries

    # validate user input up front (inside the friendly-error boundary);
    # anything raised past this point is an internal error and should
    # traceback, not masquerade as a usage error
    with _user_errors():
        queries_titles, queries = load_queries(args.query)
    db, engine, n_dev, setup_s = _build_engine(args)
    with _user_errors():
        # over-cap queries are user input, not an internal failure: report
        # them as a friendly exit-2 error before any device work
        cap = engine.config.max_query_len
        for t, q in zip(queries_titles, queries):
            if len(q) > cap:
                raise ValueError(
                    f"query '{t}' length {len(q)} exceeds --max-query-len "
                    f"{cap} (the engine plans device memory for the "
                    f"configured cap; raise the flag to accept longer "
                    f"queries)")

    import contextlib
    trace_ctx = contextlib.nullcontext()
    if args.trace:
        from oswald_tpu.utils import profile_trace
        trace_ctx = profile_trace(args.trace)

    t0 = time.perf_counter()
    with trace_ctx:
        results = engine.search_many(queries, queries_titles,
                                     batch=not args.no_batch)
    search_s = time.perf_counter() - t0

    from oswald_tpu.utils import gcups as _gcups
    Q = sum(len(q) for q in queries)
    D = db.n_residues
    gcups = _gcups(Q, D, search_s)

    # multi-host SPMD: every process ran the search; one prints
    if jax.process_index() != 0:
        return 0

    alignments = None
    if args.align or args.tab:
        # engine.align guarantees the traceback scores with the engine's
        # own matrix/gap config (identical to the search's)
        alignments = [engine.align(q, res)
                      for q, res in zip(queries, results)]

    if args.tab:
        from oswald_tpu.engine.align import format_tabular
        for qi, res in enumerate(results):
            for hi, (title, aln) in enumerate(zip(res.titles,
                                                  alignments[qi])):
                ev = float(res.evalues[hi]) if res.evalues is not None \
                    else None
                bs = float(res.bit_scores[hi]) if res.bit_scores is not \
                    None else None
                print(format_tabular(res.query_title, title, aln, ev, bs))
        return 0

    if args.json:
        import json as _json
        for qi, res in enumerate(results):
            hits = [{"score": int(s), "id": int(i), "title": t}
                    for s, i, t in zip(res.scores, res.seq_ids, res.titles)]
            if res.evalues is not None:
                for h, e, b in zip(hits, res.evalues, res.bit_scores):
                    h["evalue"] = float(e)
                    h["bits"] = round(float(b), 1)
            if alignments is not None:
                for h, a in zip(hits, alignments[qi]):
                    h["alignment"] = {
                        "q_start": a.q_start, "q_end": a.q_end,
                        "s_start": a.s_start, "s_end": a.s_end,
                        "q_aln": a.q_aln, "s_aln": a.s_aln,
                        "midline": a.midline,
                        "identities": a.identities,
                        "positives": a.positives, "gaps": a.gaps}
            print(_json.dumps({
                "query": res.query_title, "length": res.query_length,
                "hits": hits}))
        print(_json.dumps({
            "summary": {"n_queries": len(queries), "db_seqs": db.n_seqs,
                        "db_residues": db.n_residues,
                        "search_s": round(search_s, 4),
                        "setup_s": round(setup_s, 4),
                        "gcups": round(gcups, 2), "devices": n_dev,
                        "matrix": args.sm, "gap_open": args.gap_open,
                        "gap_extend": args.gap_extend}}))
        if args.metrics:
            print(_json.dumps({"metrics": engine.metrics.as_dict()}))
        return 0

    for i, res in enumerate(results):
        print(f"\nQuery no.\t\t\t{i + 1}")
        print(f"Query description: \t\t{res.query_title}")
        print(f"Query length:\t\t\t{res.query_length} residues")
        if res.evalues is not None:
            # significance columns from the empirical extreme-value fit
            # (oswald_tpu.stats) — beyond the reference's score-only report
            from oswald_tpu.stats import format_evalue
            print("\nScore\tBits\tE-value\t\tSequence description")
            for sc, b, e, title in zip(res.scores, res.bit_scores,
                                       res.evalues, res.titles):
                print(f"{int(sc)}\t{b:.1f}\t{format_evalue(float(e)):<8}"
                      f"\t{title}")
        else:
            print("\nScore\tSequence description")
            for sc, title in zip(res.scores, res.titles):
                print(f"{int(sc)}\t{title}")
        if args.histogram:
            import numpy as np
            from oswald_tpu.stats import histogram_report
            try:
                flat = np.asarray(engine.score_all(queries[i]))
            except ValueError as e:
                # the distributed host_stream engine never materialises
                # the full score vector (see dist.score_all)
                print(f"\n(--histogram: {e})", file=sys.stderr)
            else:
                print("\n" + histogram_report(
                    flat[engine.ids_flat >= 0], res.stats,
                    engine._len_hist), end="")
        if alignments is not None:
            from oswald_tpu.engine.align import format_alignment
            for title, aln in zip(res.titles, alignments[i]):
                print(f"\n> {title}\n Score: {aln.score}")
                print(format_alignment(aln), end="")
    print(f"\nSearch date:\t\t\t{time.ctime()}")
    print(f"Database:\t\t\t{args.db} ({db.n_seqs} sequences, "
          f"{db.n_residues} residues)")
    print(f"Substitution matrix:\t\t{args.sm}")
    print(f"Gap open penalty:\t\t{args.gap_open}")
    print(f"Gap extend penalty:\t\t{args.gap_extend}")
    print(f"Setup time:\t\t\t{setup_s:.4f} seconds")
    print(f"Search time:\t\t\t{search_s:.4f} seconds")
    print(f"Search speed:\t\t\t{gcups:.2f} GCUPS")
    print(f"Devices:\t\t\t{n_dev} ({jax.default_backend()})")
    print(f"Group lanes:\t\t\t1024 (8x128, one GPU thread per sequence)")
    if args.metrics:
        print("\nPhase timings:")
        print(engine.metrics.report())
    return 0


def cmd_info(args):
    import jax
    print(f"JAX {jax.__version__}, backend: {jax.default_backend()}")
    print(f"Process {jax.process_index()} of {jax.process_count()}")
    print(f"Devices ({jax.device_count()} total, "
          f"{jax.local_device_count()} local):")
    for d in jax.devices():
        mem = getattr(d, "memory_stats", lambda: None)()
        line = (f"  [{d.id}] {d.device_kind} (platform={d.platform}, "
                f"process={d.process_index})")
        if mem and "bytes_limit" in mem:
            line += f", memory limit {mem['bytes_limit'] / 2**30:.1f} GiB"
        print(line)
    from oswald_tpu.utils.compile_cache import cache_stats
    st = cache_stats()
    print(f"Compile cache:\t{st['dir']} ({st['entries']} programs, "
          f"{st['bytes'] / 2**20:.1f} MiB)")
    return 0


def cmd_tune(args):
    import json as _json
    _enable_cache(args)
    from oswald_tpu.tune import autotune
    out = autotune(m=args.m, groups=args.groups, chunks=args.chunks,
                   iters=args.iters, log=lambda s: print(s, file=sys.stderr))
    if args.json:
        print(_json.dumps(out))
    else:
        print(f"best geometry on {out['device']}: "
              f"--u-rows {out['u_rows']} --group-block {out['group_block']}"
              f" --col-unroll {out['col_unroll']} "
              f"({out['gcells']} Gcells/s)")
    return 0


def cmd_cache(args):
    from oswald_tpu.utils.compile_cache import (pack_cache, unpack_cache,
                                                cache_stats)
    d = getattr(args, "compile_cache", None)
    with _user_errors():
        if args.action == "info":
            st = cache_stats(d)
            print(f"compile cache: {st['dir']} ({st['entries']} programs, "
                  f"{st['bytes'] / 2**20:.1f} MiB)")
            return 0
        if not args.tar:
            raise ValueError(f"cache {args.action} requires a tarball "
                             "path argument")
        if args.action == "pack":
            out = pack_cache(args.tar, d)
            print(f"packed {out['entries']} compiled programs "
                  f"({out['bytes'] / 2**20:.1f} MiB) -> {out['tar']}")
        else:
            out = unpack_cache(args.tar, d, overwrite=args.overwrite)
            print(f"unpacked {out['extracted']} programs into "
                  f"{out['dir']} ({out['skipped']} already present)")
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        return {"preprocess": cmd_preprocess, "search": cmd_search,
                "serve": cmd_serve, "info": cmd_info,
                "tune": cmd_tune, "cache": cmd_cache}[args.op](args)
    except _CLIError as e:
        print(f"oswald-tpu: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
