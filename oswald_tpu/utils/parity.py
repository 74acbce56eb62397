"""Correctness certification: the compiled kernel vs an independent oracle.

The tests run every kernel in Pallas interpret mode on the CPU; this module
closes the remaining gap by checking exact score parity of the kernel as it
was compiled for the attached device against the anti-diagonal oracle
(`core.sw_score_diag_batch`), which always runs on the host CPU.  Scores are
integers, so the tolerance is zero.  The reference's device-kernel
semantics (/root/reference/device/sw.cl:44-86) are the contract being
certified.

- `kernel_parity`: `sw_chunk` alone at the widths a real database bin has
  (a realistic corpus's largest bins, 512- and 5632-row queries, full
  128-column chunks and the 32/64/96 tails, packed segments with a
  `seg_map`, the dummy-row-block skip).
- `run_parity`: whole engines: >= 2 matrices including a negative-min
  config (pam30 7/1), a titin-length (5478) query, multi-chunk bins, and
  the packed-segment batched path.
"""

import time

import numpy as np

from oswald_tpu.alphabet import DUMMY


def _oracle_layout(seqs, lengths):
    """Length-ascending padded [n, nmax] matrix + lengths, matching the
    packed db's sorted order."""
    n = len(seqs)
    order = np.argsort(lengths, kind="stable")
    nmax = int(lengths.max())
    bs = np.full((n, nmax), DUMMY, np.int32)
    for i, src in enumerate(order):
        bs[i, : lengths[src]] = seqs[src]
    return bs, lengths[order].astype(np.int32)


def _oracle(q, bs, ns, submat, og, eg):
    """Oracle scores on the host CPU device, float matmuls pinned to full
    precision (the oracle has none; the pin keeps a future change from
    comparing against TF32 by accident)."""
    import jax
    from oswald_tpu.core import sw_score_diag_batch
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        return np.asarray(sw_score_diag_batch(
            np.asarray(q, np.int32), bs, ns, submat, og, eg))


# sw_chunk at the widths a SwissProt-scale realistic corpus has
# (io.synth.make_realistic_corpus at 570k sequences: its largest bins hold
# 40-44 groups at L = 128..256).  Each case: bin (L, G), query lengths
# packed in one program (one length = a plain query), padded rows, the
# accumulator, scoring.  Together they cover full 128-column chunks and
# the 32/64/96 tails, 512 and 5632 query rows, the dummy-row-block skip
# (n_blocks), packed segments with a seg_map, both E-updates.
KERNEL_CASES = (
    dict(L=224, G=44, qlens=(512,), m_pad=512, acc="float32",
         matrix="blosum62", gaps=(10, 2), noadj=True),
    dict(L=160, G=32, qlens=(450,), m_pad=512, acc="int32",
         matrix="pam30", gaps=(7, 1), noadj=True),
    dict(L=192, G=40, qlens=(5478,), m_pad=5632, acc="float32",
         matrix="blosum62", gaps=(10, 2), noadj=True),
    dict(L=256, G=42, qlens=(100, 250, 64), m_pad=512, acc="float32",
         matrix="blosum62", gaps=(10, 2), noadj=False),
)


def kernel_parity(cases=KERNEL_CASES, n_sample: int = 256, seed: int = 0,
                  u_rows: int = 8, group_block: int = 1,
                  col_unroll: int = 1, interpret=None, log=None) -> dict:
    """`sw_chunk` on the attached device vs the oracle, case by case.

    Each case scans one random bin [G, L, 8, 128] (per-lane true lengths
    in (L-32, L], DUMMY after) chunk by chunk through the engine's stream
    scan (build_profile + sw_chunk with the colH/colE carry), then checks
    n_sample random lanes (a quarter as many for queries longer than
    2048) against the oracle exactly.  Returns
    {"kernel_parity": "ok"|"FAIL", "checks", "failures"?}."""
    import jax
    import jax.numpy as jnp
    from oswald_tpu.engine.search import (
        _search_bin_stream, _search_bin_stream_pack, mixed_pack_plan,
        kernel_interpret, MIXED_PACK_SEGS)
    from oswald_tpu.io.db import SUBLANES, LANES
    from oswald_tpu.kernels import CHUNK_WIDTH
    from oswald_tpu.submat import get_submat

    if interpret is None:
        interpret = kernel_interpret()
    rng = np.random.default_rng(seed)
    failures, checks = [], 0
    for case in cases:
        L, G, qlens, m_pad = case["L"], case["G"], case["qlens"], \
            case["m_pad"]
        og, eg = case["gaps"]
        sm = get_submat(case["matrix"])
        acc = {"int32": jnp.int32, "float32": jnp.float32}[case["acc"]]
        lanes = G * SUBLANES * LANES
        n_b = rng.integers(max(L - 31, 1), L + 1, size=lanes)
        subj = rng.integers(0, 23, size=(lanes, L)).astype(np.int8)
        subj[np.arange(L)[None, :] >= n_b[:, None]] = DUMMY
        seq = subj.reshape(G, SUBLANES, LANES, L).transpose(0, 3, 1, 2)
        C = L // CHUNK_WIDTH
        main = jnp.asarray(np.ascontiguousarray(
            seq[:, :C * CHUNK_WIDTH].reshape(
                G, C, CHUNK_WIDTH, SUBLANES, LANES).transpose(
                    1, 0, 2, 3, 4)))
        tail = jnp.asarray(seq[:, C * CHUNK_WIDTH:]) if L % CHUNK_WIDTH \
            else None
        queries = [rng.integers(0, 23, size=n).astype(np.int8)
                   for n in qlens]
        kw = dict(u_rows=u_rows, interpret=interpret,
                  group_block=group_block, acc_dtype=acc,
                  col_unroll=col_unroll, noadj=case["noadj"])
        gaps = jnp.asarray([og, eg], jnp.int32)
        t0 = time.perf_counter()
        if len(queries) == 1:
            q_pad = np.full(m_pad, DUMMY, np.int32)
            q_pad[:qlens[0]] = queries[0]
            nb = -(-qlens[0] // u_rows)
            got = np.asarray(_search_bin_stream(
                jnp.asarray(q_pad), gaps, jnp.asarray(sm), main,
                seq_tail=tail, nb=None if nb * u_rows == m_pad else
                jnp.asarray(nb, jnp.int32), **kw)).reshape(1, -1)
        else:
            (bin_,), rest = mixed_pack_plan(m_pad, u_rows, queries)
            idxs, q_packed, seg_map, used = bin_
            assert not rest and q_packed.shape[0] == m_pad, \
                (rest, q_packed.shape)
            out = np.asarray(_search_bin_stream_pack(
                jnp.asarray(q_packed), gaps, jnp.asarray(sm), main,
                q_segs=MIXED_PACK_SEGS, seq_tail=tail,
                seg_map=jnp.asarray(seg_map),
                nb=None if used == seg_map.shape[0] else
                jnp.asarray(used, jnp.int32), **kw)).reshape(
                    MIXED_PACK_SEGS, -1)
            got = np.empty((len(queries), lanes), np.int64)
            for slot, i in enumerate(idxs):
                got[i] = out[slot]
        t1 = time.perf_counter()
        k = n_sample if max(qlens) <= 2048 else max(n_sample // 4, 1)
        sample = rng.choice(lanes, size=min(k, lanes), replace=False)
        for qi, q in enumerate(queries):
            want = _oracle(q, subj[sample], n_b[sample], sm, og, eg)
            ok = np.array_equal(got[qi, sample], want)
            checks += 1
            label = (f"L={L} G={G} qlen={len(q)} m_pad={m_pad} "
                     f"{case['acc']} {case['matrix']} {og}/{eg} "
                     f"noadj={case['noadj']} segs={len(queries)}")
            if log:
                log(f"kernel {label}: {'EXACT' if ok else 'MISMATCH'} "
                    f"over {len(sample)} lanes (device "
                    f"{t1 - t0:.2f}s incl. compile)")
            if not ok:
                bad = np.flatnonzero(got[qi, sample] != want)[:5]
                failures.append({"check": label,
                                 "lanes": sample[bad].tolist(),
                                 "got": got[qi, sample][bad].tolist(),
                                 "want": want[bad].tolist()})
    out = {"kernel_parity": "ok" if not failures else "FAIL",
           "checks": checks}
    if failures:
        out["failures"] = failures
    return out


def run_parity(n: int = 4096, lmax: int = 700, seed: int = 7,
               titin_sample: int = 256, log=None) -> dict:
    """Run the full parity suite; returns {"parity": "ok"|"FAIL", ...}.

    The engines under test run on the default backend; the oracle runs on
    host CPU jax.  Exactness is exact int
    equality — any mismatch is reported with its first failing slots.
    """
    import jax
    from oswald_tpu.io import pack_sequences
    from oswald_tpu.engine import SearchEngine, SearchConfig
    from oswald_tpu.submat import get_submat

    def say(msg):
        if log:
            log(msg)

    t_start = time.perf_counter()
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, lmax, size=n)
    seqs = [rng.integers(0, 23, int(l)).astype(np.int8) for l in lengths]
    db = pack_sequences(np.concatenate(seqs), lengths,
                        [f"s{i}" for i in range(n)])
    bs, ns = _oracle_layout(seqs, lengths)
    checks = 0
    failures = []

    for matrix, og, eg in (("blosum62", 10, 2), ("pam30", 7, 1)):
        eng = SearchEngine(db, SearchConfig(matrix=matrix, open_gap=og,
                                            extend_gap=eg))
        sm = get_submat(matrix)
        # 64/512: exact pad multiples (branch-free kernel variant); 65:
        # one row past the quantum — certifies the dummy-row-block SKIP
        # program on hardware (15 of 16 row blocks in its pad class are
        # padding); 5478: titin-scale, multi-row-block carry + skip
        for qlen in (64, 65, 512, 5478):
            q = rng.integers(0, 23, size=qlen).astype(np.int8)
            t0 = time.perf_counter()
            got = np.asarray(eng.score_all(q))[np.asarray(eng.valid)]
            t1 = time.perf_counter()
            # titin-length diagonal scans are too slow for the full db —
            # verify a random sample against the host-CPU oracle (the
            # engine under test scores the full db either way)
            if qlen > 2048:
                sample = rng.choice(n, size=titin_sample, replace=False)
            else:
                sample = np.arange(n)
            want = _oracle(q, bs[sample], ns[sample], sm, og, eg)
            got_cmp = got[sample]
            ok = np.array_equal(got_cmp, want)
            checks += 1
            say(f"parity {matrix} {og}/{eg} qlen {qlen}: "
                f"{'EXACT' if ok else 'MISMATCH'} over {len(sample)} seqs "
                f"(engine {t1 - t0:.2f}s, oracle "
                f"{time.perf_counter() - t1:.2f}s)")
            if not ok:
                bad = np.flatnonzero(got_cmp != want)[:5]
                failures.append(
                    {"check": f"{matrix}:{qlen}", "slots": bad.tolist(),
                     "got": got_cmp[bad].tolist(),
                     "want": want[bad].tolist()})

        # packed-segment (q_segs) batched path: a mixed batch of short
        # queries through search_many must equal per-query search results
        # (which the score_all checks above certify against the oracle)
        qs = [rng.integers(0, 23, size=int(l)).astype(np.int8)
              for l in (40, 64, 55, 128, 100, 61, 200, 90)]
        n_fail = len(failures)
        batched = eng.search_many(qs, batch=True)
        singles = [eng.search(q) for q in qs]
        for b, s in zip(batched, singles):
            ok = (np.array_equal(b.scores, s.scores) and
                  np.array_equal(b.seq_ids, s.seq_ids))
            checks += 1
            if not ok:
                failures.append(
                    {"check": f"{matrix}:packed",
                     "got": b.scores.tolist(), "want": s.scores.tolist()})
        say(f"parity {matrix} packed batch ({len(qs)} mixed short "
            f"queries): {'EXACT' if len(failures) == n_fail else 'MISMATCH'}")
        del eng

    out = {"parity": "ok" if not failures else "FAIL",
           "checks": checks,
           "backend": jax.default_backend(),
           "seconds": round(time.perf_counter() - t_start, 1)}
    if failures:
        out["failures"] = failures
    return out
