#!/usr/bin/env python3
"""Smoke test of the search engine on an NVIDIA GPU, at SwissProt scale.

    python chip_smoke.py              # one GPU: phases 1-4
    python chip_smoke.py --devices 4  # four GPUs: the distributed phase only
    python chip_smoke.py --cpu-rehearsal   # tiny sizes on the CPU

Phases (one process; the card is opened once):

1. Device check: the card's name and power limit, `jax.devices()`; any
   platform other than `gpu` exits non-zero.
2. Kernel check: `sw_chunk` compiled for the card at real widths
   (`utils.parity.kernel_parity`), exact against the oracle; the fused
   search program's `memory_analysis()`.
3. Engine parity: `utils.parity.run_parity` at its on-device sizes.
4. The main path, through the entry points a user calls: a realistic
   corpus generated from a seed (~570k sequences, ~2e8 residues) written
   as FASTA; `oswald-tpu preprocess`; `oswald-tpu search --no-batch` on
   queries of 64, 512 and 5478 residues, then with `--align`;
   `oswald-tpu serve` on an ephemeral port answering `POST /search`, whose
   hits must equal the CLI's.  The hits of every query are checked
   against the oracle; for the 512-residue query (which has a planted
   homolog) also the top-k order against a host `np.lexsort` of the full
   score vector, a random sample of scores against the oracle, and
   E-values/bit scores against a float64 host recomputation.

With `--devices 4` the script runs only the distributed path: the same
corpus on a 4-device mesh in precompute and host_stream modes (the
512-residue query; each mode compiles one program per padded length and
bin layout), top-k checked against a one-device engine in the same
process, hit scores against the oracle, and the profile shards
checked to sit on four distinct devices.

Wall times and GCUPS are printed as information beside the card's name
and power limit.  Any failed check exits non-zero.  The last line is
{"ok": true, "device": {"platform", "kind", "count"}}.  `--cpu-rehearsal`
runs the same phases at tiny sizes on the CPU (interpret-mode kernel) and
exits with code 3 without that line.
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chip_smoke")

# E-values and bit scores come from float32 moment sums that the device
# adds in its own order; the host recomputes them in float64.  The sums
# agree to ~1e-6 relative, and an E-value exp(-lambda*S) amplifies a
# lambda error by lambda*S (~30-100 for real hits), so 1e-3 relative.
EVALUE_RTOL = 1e-3

FULL = dict(n_seqs=570_000, max_len=5478, qlens=(64, 512, 5478),
            sample=256)
REHEARSAL = dict(n_seqs=3000, max_len=700, qlens=(64, 200, 300), sample=64)


class SmokeFailure(Exception):
    pass


def say(msg):
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_line(rehearsal):
    if rehearsal:
        return "cpu rehearsal (no card)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_corpus(size, seed):
    """(flat, lengths, titles, queries): a realistic corpus with one
    planted homolog of the middle query, so that query has a true hit."""
    from oswald_tpu.io.synth import (make_realistic_corpus, mutate,
                                     realistic_residues)
    rng = np.random.default_rng(seed)
    queries = [realistic_residues(rng, n) for n in size["qlens"]]
    planted = [mutate(queries[1], rng, identity=0.6)]
    flat, lengths, titles = make_realistic_corpus(
        rng, size["n_seqs"], max_len=size["max_len"], planted=planted)
    return flat, lengths, titles, queries


def oracle_scores(db, q, ids, submat, og, eg):
    from oswald_tpu.utils.parity import _oracle
    seqs = [db.sequence_of(int(i)) for i in ids]
    n = np.asarray([len(s) for s in seqs], np.int32)
    bs = np.full((len(seqs), max(int(n.max()), 1)), 23, np.int32)
    for r, s in enumerate(seqs):
        bs[r, :len(s)] = s
    return _oracle(q, bs, n, submat, og, eg)


def host_topk(scores, ids_flat, k):
    """Top-k with lax.top_k's tie rule (lowest slot first) on the host."""
    masked = np.where(ids_flat >= 0, scores, -1)
    order = np.lexsort((np.arange(masked.size), -masked))[:k]
    return masked[order], ids_flat[order]


def phase_kernels(rehearsal):
    from oswald_tpu.utils.parity import kernel_parity, KERNEL_CASES
    cases = KERNEL_CASES
    if rehearsal:
        cases = [dict(c, G=2, m_pad=min(c["m_pad"], 128),
                      qlens=tuple(min(n, 128 if len(c["qlens"]) == 1
                                      else 32) for n in c["qlens"]))
                 for c in cases]
    out = kernel_parity(cases, n_sample=64 if rehearsal else 256,
                        log=lambda m: say(f"  {m}"))
    check(out["kernel_parity"] == "ok", f"kernel parity: {out}")


def print_memory_analysis(eng, m_pad):
    """Compile the engine's fused search program for one padded length and
    print XLA's memory analysis of it."""
    import jax.numpy as jnp
    k = min(eng.config.top, eng.db.n_seqs)
    fn = eng._search_fn(k)
    stacks = (eng.prof_flat, eng.tail_flats)
    nb = jnp.asarray(1, jnp.int32)
    compiled = fn.func.lower(jnp.zeros(m_pad, jnp.int32), nb, eng.gaps,
                             eng.submat_dev, stacks, eng.valid, eng.lnl,
                             **fn.keywords).compile()
    say(f"  fused search program m_pad={m_pad}: "
        f"{compiled.memory_analysis()}")


def phase_parity(rehearsal):
    from oswald_tpu.utils.parity import run_parity
    kw = dict(n=128, lmax=200, titin_sample=4) if rehearsal else \
        dict(n=4096, lmax=700, titin_sample=256)
    out = run_parity(log=lambda m: say(f"  {m}"), **kw)
    check(out["parity"] == "ok", f"engine parity: {out}")


def run_cli(argv):
    """`oswald-tpu <argv>` in this process; returns (rc, stdout text)."""
    from oswald_tpu.cli.main import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def post(port, payload, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/search", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase_main_path(size, card, seed):
    from oswald_tpu.alphabet import decode
    from oswald_tpu.engine import SearchEngine, SearchConfig
    from oswald_tpu.engine.planner import plan_profile_mode
    from oswald_tpu.engine.search import _host_moments, _result_stats
    from oswald_tpu.io import native
    from oswald_tpu.io.db import load_db
    from oswald_tpu.io.synth import write_fasta
    from oswald_tpu.submat import get_submat

    os.makedirs(WORK, exist_ok=True)
    fasta = os.path.join(WORK, "corpus.fasta")
    qfasta = os.path.join(WORK, "queries.fasta")
    q1fasta = os.path.join(WORK, "query512.fasta")
    dbpath = os.path.join(WORK, "corpus")

    t = time.perf_counter()
    flat, lengths, titles, queries = make_corpus(size, seed)
    write_fasta(fasta, flat, lengths, titles)
    with open(qfasta, "w") as fh:
        for q in queries:
            fh.write(f">q{len(q)}\n{decode(q)}\n")
    with open(q1fasta, "w") as fh:
        fh.write(f">q{len(queries[1])}\n{decode(queries[1])}\n")
    say(f"  corpus: {len(lengths)} sequences, {int(lengths.sum())} "
        f"residues, FASTA written in {time.perf_counter() - t:.1f}s")
    del flat

    io_path = "native C++" if native.available() else "numpy"
    t = time.perf_counter()
    rc, _ = run_cli(["preprocess", "-i", fasta, "-o", dbpath])
    check(rc == 0, f"preprocess rc {rc}")
    say(f"  preprocess ({io_path} IO path): "
        f"{time.perf_counter() - t:.1f}s")
    db = load_db(dbpath + ".oswt")
    plan = plan_profile_mode(db, max_query_len=max(size["qlens"]),
                             config=SearchConfig())
    say(f"  planner: {plan.describe()}")

    t = time.perf_counter()
    # --no-batch: one fused program per padded length, which the later
    # engines in this process share (the batched path compiles one
    # program per bin and pad class)
    rc, out = run_cli(["search", "-q", qfasta, "-d", dbpath + ".oswt",
                       "--json", "--no-batch"])
    check(rc == 0, f"search rc {rc}")
    lines = [json.loads(x) for x in out.splitlines() if x.strip()]
    cli_hits = {r["query"]: r["hits"] for r in lines if "query" in r}
    summary = [r["summary"] for r in lines if "summary" in r][0]
    check(len(cli_hits) == len(queries), f"search returned {cli_hits}")
    say(f"  search --json --no-batch {len(queries)} queries: search "
        f"{summary['search_s']}s, {summary['gcups']} GCUPS, wall "
        f"{time.perf_counter() - t:.1f}s incl. setup and compile [{card}]")

    t = time.perf_counter()
    rc, out = run_cli(["search", "-q", q1fasta, "-d", dbpath + ".oswt",
                       "--align"])
    check(rc == 0, f"search --align rc {rc}")
    n_aln = out.count(" Score: ")
    check(n_aln == len(cli_hits[f"q{len(queries[1])}"]),
          f"--align printed {n_aln} alignments")
    say(f"  search --align: {n_aln} alignments, wall "
        f"{time.perf_counter() - t:.1f}s")

    # the engine the CLI builds, in process: tie order, oracle, E-values
    cfg = SearchConfig()
    sm = get_submat(cfg.matrix)
    eng = SearchEngine(db, cfg)
    say(f"  engine mode {eng.mode}, kernel "
        f"{'interpreted' if eng._interpret else 'compiled'}")
    rng = np.random.default_rng(seed + 1)
    for q in queries:
        res = eng.search(q)                 # compiled by the CLI search
        t = time.perf_counter()
        res = eng.search(q)
        dt = time.perf_counter() - t
        say(f"  engine.search qlen {len(q)}: {dt:.3f}s, "
            f"{len(q) * db.n_residues / dt / 1e9:.1f} GCUPS [{card}]")
        cli = cli_hits[f"q{len(q)}"]
        check([h["score"] for h in cli] == res.scores.tolist() and
              [h["id"] for h in cli] == res.seq_ids.tolist(),
              f"qlen {len(q)}: CLI hits differ from engine.search")
        full = q is queries[1]
        ids = res.seq_ids
        if full:
            ids = np.concatenate([ids, rng.choice(db.n_seqs, size["sample"],
                                                  replace=False)])
        want = oracle_scores(db, q, ids, sm, cfg.open_gap, cfg.extend_gap)
        check(np.array_equal(want[:len(res.scores)], res.scores),
              f"qlen {len(q)}: hit scores differ from the oracle")
        if not full:
            say(f"    qlen {len(q)}: top {res.scores[:3].tolist()}; "
                f"hits = CLI's = oracle")
            continue
        scores = np.asarray(eng.score_all(q))
        hs, hi = host_topk(scores, eng.ids_flat, len(res.scores))
        check(np.array_equal(hs, res.scores) and
              np.array_equal(hi, res.seq_ids),
              f"qlen {len(q)}: top-k order differs from host lexsort")
        slot = np.full(db.n_seqs, -1, np.int64)
        valid = eng.ids_flat >= 0
        slot[eng.ids_flat[valid]] = np.flatnonzero(valid)
        check(np.array_equal(scores[slot[ids]], want),
              f"qlen {len(q)}: scores differ from the oracle")
        if res.evalues is not None:
            mom = _host_moments(scores, valid, eng.lnl_flat, res.scores)
            ev, bits, _ = _result_stats(
                db, eng._lnl_by_id, eng._lnl_mom, eng._len_hist,
                res.scores, res.seq_ids, mom, len(q))
            check(np.allclose(res.evalues, ev, rtol=EVALUE_RTOL, atol=0)
                  and np.allclose(res.bit_scores, bits, rtol=EVALUE_RTOL,
                                  atol=0),
                  f"qlen {len(q)}: E-values {res.evalues[:3]} vs host "
                  f"{ev[:3]}")
        say(f"    qlen {len(q)}: top {res.scores[:3].tolist()} E "
            f"{[float(f'{e:.3g}') for e in res.evalues[:3]] if res.evalues is not None else None}; "
            f"order = host lexsort, {len(ids)} scores = oracle, "
            f"E-values within {EVALUE_RTOL} of host float64")
    if eng.mode == "precompute":
        from oswald_tpu.engine.search import pad_query
        print_memory_analysis(eng, pad_query(queries[-1], cfg).shape[0])
    del eng

    from oswald_tpu.cli.main import main as cli_main
    port = free_port()
    # serve blocks for good, so it keeps this process's stdout (a
    # redirect would swallow every later line); a daemon thread ends
    # with the process
    srv = threading.Thread(
        target=cli_main, daemon=True,
        args=(["serve", "-d", dbpath + ".oswt", "--port", str(port),
               "--warmup-qlen", "0"],))
    srv.start()
    deadline = time.time() + 600
    while True:
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=5).read()
            break
        except OSError:
            check(srv.is_alive() and time.time() < deadline,
                  "serve did not come up")
            time.sleep(1)
    for q in queries:
        t = time.perf_counter()
        got = post(port, {"query": decode(q)})["results"][0]["hits"]
        dt = time.perf_counter() - t
        cli = cli_hits[f"q{len(q)}"]
        check([(h["score"], h["id"]) for h in got] ==
              [(h["score"], h["id"]) for h in cli],
              f"serve qlen {len(q)}: hits differ from the CLI")
        say(f"  serve POST /search qlen {len(q)}: {dt:.3f}s (first call "
            f"includes compile), hits = CLI's")


def phase_four(size, card, seed, n_dev):
    import jax
    from oswald_tpu.dist import DistributedSearchEngine, make_device_mesh
    from oswald_tpu.engine import SearchEngine, SearchConfig
    from oswald_tpu.io import pack_sequences
    from oswald_tpu.submat import get_submat

    check(jax.device_count() >= n_dev,
          f"--devices {n_dev} needs {n_dev} devices, JAX found "
          f"{jax.device_count()}")
    flat, lengths, titles, queries = make_corpus(size, seed)
    db = pack_sequences(flat, lengths, titles)
    del flat
    say(f"  corpus: {db.n_seqs} sequences, {db.n_residues} residues")
    cfg = SearchConfig()
    sm = get_submat(cfg.matrix)
    one = SearchEngine(db, cfg)
    mesh = make_device_mesh(n_dev)
    for mode, qs in (("precompute", queries[1:2]),
                     ("host_stream", queries[1:2])):
        t = time.perf_counter()
        eng = DistributedSearchEngine(
            db, SearchConfig(profile_mode=mode), mesh=mesh)
        say(f"  {n_dev}-device {mode} engine built in "
            f"{time.perf_counter() - t:.1f}s")
        if mode == "precompute":
            shards = eng.prof_flat.addressable_shards
            devs = {s.device for s in shards}
            check(len(devs) == n_dev and
                  all(s.data.shape[0] * n_dev == eng.prof_flat.shape[0]
                      for s in shards),
                  f"profiles not split over {n_dev} devices: "
                  f"{[(s.device, s.data.shape) for s in shards]}")
            say(f"  profile shards on {sorted(d.id for d in devs)}: "
                f"{shards[0].data.shape} each")
        for q in qs:
            w = one.search(q)
            eng.search(q)                     # compile
            t = time.perf_counter()
            res = eng.search(q)
            dt = time.perf_counter() - t
            check(np.array_equal(res.scores, w.scores) and
                  np.array_equal(res.seq_ids, w.seq_ids),
                  f"{mode} qlen {len(q)}: {n_dev}-device top-k differs "
                  f"from one device")
            ora = oracle_scores(db, q, res.seq_ids, sm, cfg.open_gap,
                                cfg.extend_gap)
            check(np.array_equal(ora, res.scores),
                  f"{mode} qlen {len(q)}: hit scores differ from the "
                  f"oracle")
            say(f"  {mode} qlen {len(q)}: {dt:.3f}s, "
                f"{len(q) * db.n_residues / dt / 1e9:.1f} GCUPS on "
                f"{n_dev} devices [{card}]; top-k = one device's, hit "
                f"scores = oracle")
        del eng


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the distributed phase on 4 devices")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny sizes on the CPU; exits 3, prints no result")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rehearsal = args.cpu_rehearsal
    if rehearsal:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        if args.devices > 1:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "") +
                f" --xla_force_host_platform_device_count={args.devices}")
    import jax
    if rehearsal:
        jax.config.update("jax_platforms", "cpu")

    say("phase 1: device check")
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not rehearsal:
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    card = card_line(rehearsal)
    print(card, flush=True)
    say(f"  {jax.devices()} ({dev.device_kind})")
    size = REHEARSAL if rehearsal else FULL
    try:
        if args.devices > 1:
            say(f"phase 4 ({args.devices} devices): distributed search")
            phase_four(size, card, args.seed, args.devices)
        else:
            say("phase 2: kernel check at real widths")
            phase_kernels(rehearsal)
            say("phase 3: engine parity")
            phase_parity(rehearsal)
            say("phase 4: main path (preprocess, search, align, serve)")
            phase_main_path(size, card, args.seed)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 2
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    say(f"all phases passed [{card}]")
    if rehearsal:
        print("chip_smoke: CPU rehearsal passed (no result: no card)")
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
