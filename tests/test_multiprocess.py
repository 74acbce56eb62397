"""Real multi-process distributed execution (VERDICT round-1 item #3).

Launches TWO actual OS processes (CPU backend, 4 virtual devices each)
that form one 8-device mesh through `jax.distributed` + Gloo and run the
full distributed search.  This executes the code paths an in-process
8-device mesh never touches: `bootstrap`, `process_group_slice` with
process_count == 2, and `jax.make_array_from_process_local_data`.

Reference analog: the multi-device scheduler loop
(/root/reference/host/src/FPGAsearch.c:132-239) — which was still a single
process; a mesh that spans hosts needs this.  The test stays on the CPU:
a JAX process reserves most of each card it opens, so two processes on
one card would not run.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

WORKER = os.path.join(os.path.dirname(__file__), "mp_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_mesh_matches_single_chip(tmp_path):
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(WORKER)))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=repo_root + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    procs, outs = [], []
    for rank in (0, 1):
        out = tmp_path / f"rank{rank}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(port), str(rank), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(log)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

    results = [json.load(open(o)) for o in outs]
    # both ranks computed the identical replicated answer
    assert results[0]["q1_scores"] == results[1]["q1_scores"]
    assert results[0]["q1_ids"] == results[1]["q1_ids"]
    assert results[0]["q2_scores"] == results[1]["q2_scores"]
    assert results[0]["q2_ids"] == results[1]["q2_ids"]

    # ... and it matches the single-process engine on the same seed
    from oswald_tpu.io import pack_sequences
    from oswald_tpu.engine import SearchEngine, SearchConfig

    rng = np.random.default_rng(42)
    n = 700
    lengths = rng.integers(1, 120, size=n)
    flat = rng.integers(0, 20, size=int(lengths.sum())).astype(np.int8)
    db = pack_sequences(flat, lengths, [f"s{i}" for i in range(n)])
    eng = SearchEngine(db, SearchConfig(top=12, profile_mode="precompute"))
    q1 = rng.integers(0, 20, size=33).astype(np.int8)
    q2 = rng.integers(0, 20, size=57).astype(np.int8)
    r1, r2 = eng.search(q1), eng.search(q2)
    assert results[0]["q1_scores"] == r1.scores.tolist()
    assert results[0]["q1_ids"] == np.asarray(r1.seq_ids).tolist()
    assert results[0]["q2_scores"] == r2.scores.tolist()
    assert results[0]["q2_ids"] == np.asarray(r2.seq_ids).tolist()


def test_bootstrap_noarg_single_process_noop():
    """The auto-discovery path must not crash when the XLA backend is
    already initialized and no cluster environment exists — it falls back
    to single-process (regression: probing jax.default_backend() before
    jax.distributed.initialize() made the no-arg path raise on hosts with
    an accelerator)."""
    import jax
    from oswald_tpu.dist import bootstrap, is_bootstrapped
    jax.devices()                     # force backend init, like a real app
    pid, count = bootstrap()          # no cluster env -> stays local
    assert (pid, count) == (0, 1)
    assert not is_bootstrapped()      # nothing to tear down
