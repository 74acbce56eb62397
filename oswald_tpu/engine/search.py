"""Single-device database search pipeline.

Replaces the reference's search drivers (fpga_search,
/root/reference/host/src/FPGAsearch.c:4-374, and hybrid_search_*,
HybridSearch.c:4-2529).  The reference streams dynamically-sized chunks to
devices and rescues overflowed lanes on the host; here every length bin is a
fixed-shape array that streams through the Smith-Waterman kernel as a
`lax.scan` over column chunks, so the whole per-(bin, query-shape) search is
one compiled XLA program.  There is no overflow rescue (exact 32-bit
arithmetic end to end) and no calibration phase (a single device type;
multi-chip balancing is static residue-count sharding in oswald_tpu.dist).
"""

import dataclasses
import functools
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from oswald_tpu.alphabet import DUMMY
from oswald_tpu.submat import get_submat
from oswald_tpu.io.db import PackedDB, SUBLANES, LANES
from oswald_tpu.kernels import (sw_chunk, build_profile, noadj_ok,
                                kernel_interpret, CHUNK_WIDTH)
from oswald_tpu.engine.planner import plan_profile_mode
from oswald_tpu.stats import fit_score_model, tail_calibrate
from oswald_tpu.utils.metrics import Metrics


@dataclasses.dataclass
class SearchConfig:
    matrix: str = "blosum62"
    open_gap: int = 10          # reference defaults (arguments.h:13-14)
    extend_gap: int = 2
    top: int = 10
    u_rows: int = 8             # query rows register-blocked per kernel step
    group_block: int = 1        # groups whose lanes one GPU thread advances
                                # in lockstep (a power of two; bins are
                                # padded with score-inert dummy groups to a
                                # multiple)
    col_unroll: int = 1         # DP columns advanced per kernel loop
                                # iteration (see kernels.DEFAULT_COL_UNROLL
                                # for the H100 measurement); must divide 32
                                # (the smallest tail chunk)
    # Query padding: m rounds up to a multiple of max(query_pad_quantum,
    # 2^floor(log2(m))/8).  The adaptive term caps dummy-row compute at
    # ~12.5% while keeping the number of distinct compiled query shapes
    # logarithmic in the length range (dummy query rows cost real DP work,
    # unlike the reference whose per-query kernel launches take m verbatim,
    # FPGAsearch.c:204-219).
    query_pad_quantum: int = 64
    # Batched searches can pad to a coarser quantum to cut the number of
    # (m_pad, batch-size) programs, trading dummy-row compute for fewer
    # compiles; raise for compile-bound workloads.  Default: same as
    # single-query.
    batch_query_pad_quantum: int = 64
    interpret: bool | None = None  # None = the platform seam
                                   # (kernels.kernel_interpret)
    # Longest query the engine accepts.  The memory planner budgets scan
    # state (colH/colE scale with padded query rows) for THIS length, so
    # a database declared resident can never OOM at query time; longer
    # queries are rejected with a clear error instead (the reference's
    # hard analog is its FPGA channel depth, CHANNEL_MAX_DEPTH=5478 =
    # titin, /root/reference/device/sw.cl:5 — the same default here).
    # Lowering it shrinks the planner's state reserve, letting larger
    # databases stay fully resident on the device.
    max_query_len: int = 5478
    # Kernel accumulator: "float32" is exact for SW scores (integers far
    # below 2^24; max possible score ~ 15 * 5478 << 2^24, and
    # resolve_exact_acc_dtype demotes to int32 where that bound fails).
    # On Hopper a float max is one FMNMX; which accumulator is faster on
    # the card is not measured yet.
    acc_dtype: str = "float32"
    # "auto": let the device-memory planner (engine/planner.py, the analog
    # of the reference's 0.8*global_mem chunk cap, utils.c:162-168) pick the
    # most resident mode that fits.  "precompute": 24x score profiles
    # resident on the device.  "stream": packed residues resident, profiles
    # rebuilt per chunk inside the scan (24x less memory).  "host_stream": residues
    # stay host-side (mmap); group slices are transferred per search,
    # double-buffered under compute — for databases larger than the
    # device's memory (the
    # reference's bounded-chunk streaming, FPGAsearch.c:180-237).
    profile_mode: str = "auto"
    # Planner memory budget override (bytes); None = the device's own
    # limit (planner.device_hbm_bytes).  Tests set a tiny budget to force
    # host_stream on small databases.
    hbm_budget_bytes: int | None = None
    # host_stream transfer granularity: target packed-residue bytes per
    # host->device slice (rounded to whole group_block multiples per bin).
    host_stream_slice_mb: int = 256
    # host_stream double buffering: enqueue slice i+1's transfer before
    # slice i's compute dispatch so the link and the kernel overlap.  False
    # forces the serial transfer->compute->readback round — the A/B that
    # PROVES the overlap (bench suite records the ratio); production
    # always leaves this True.
    host_stream_overlap: bool = True
    # Batched searches: pack up to this many QUERY ROWS of same-padded-
    # length queries into ONE kernel program as independent segments
    # (kernels.sw_chunk q_segs) — each profile block is read once
    # per program instead of once per query, which is the dominant cost
    # for short queries.  The cap bounds the scan-state HBM (colH/colE
    # scale with packed rows) to one 1024-row query's worth.  0 disables.
    # Precompute and stream modes (both engines); applies when >= 2
    # queries fit.
    batch_query_pack_rows: int = 1024
    # search_stream readback windowing: group up to this many consecutive
    # queries' packed top-k outputs into ONE device->host transfer (a
    # jitted stack on device), so a stream pays one readback round trip
    # per window instead of per query; results are identical, only the
    # transfer schedule changes (each result is built from its own packed
    # columns).  Whether this pays on a locally attached card is not
    # measured yet.  1 = one readback per query.
    stream_readback_window: int = 4
    # One jitted program per search (bins + top-k) instead of one dispatch
    # per bin.  None = auto: fused for EVERY single query in precompute
    # mode (never in interpret mode — one giant traced program is much
    # slower to build on CPU).  One program per pad class instead of one
    # per (C, G) class also shrinks the warmup/compile-cache ladder.
    # DistributedSearchEngine fuses too (dist/shard.py _fused_fn): one
    # shard_map program AND one collective merge per search instead of
    # one of each per bin (host_stream keeps its own slice pipeline).
    fused_dispatch: bool | None = None

    def __post_init__(self):
        u = self.u_rows
        if not (isinstance(u, int) and 1 <= u <= 64 and (u & (u - 1)) == 0):
            raise ValueError(
                f"u_rows must be a power of two in [1, 64], got {u!r} "
                "(it must divide every padded query length)")
        if not (isinstance(self.group_block, int) and self.group_block >= 1):
            raise ValueError(
                f"group_block must be a positive integer, got "
                f"{self.group_block!r}")
        cu = self.col_unroll
        if not (isinstance(cu, int) and 1 <= cu <= 32 and 32 % cu == 0):
            raise ValueError(
                f"col_unroll must be a divisor of 32, got {cu!r} (it must "
                "divide full 128-column chunks AND the 32/64/96-column "
                "tail chunks the 32-residue bin quantum produces)")
        if not (isinstance(self.batch_query_pack_rows, int) and
                self.batch_query_pack_rows >= 0):
            raise ValueError(
                f"batch_query_pack_rows must be a non-negative int, got "
                f"{self.batch_query_pack_rows!r}")
        for field in ("query_pad_quantum", "batch_query_pad_quantum"):
            q = getattr(self, field)
            if not (isinstance(q, int) and 8 <= q <= 8192 and
                    (q & (q - 1)) == 0):
                raise ValueError(
                    f"{field} must be a power of two in [8, 8192], got "
                    f"{q!r} (padded query lengths must stay multiples of "
                    "u_rows)")
        if self.top < 1:
            raise ValueError(f"top must be >= 1, got {self.top!r}")
        if not (isinstance(self.max_query_len, int) and
                self.max_query_len >= 1):
            raise ValueError(
                f"max_query_len must be a positive int, got "
                f"{self.max_query_len!r}")
        # reference CLI contract: open gap 0..255, extend gap 0..127
        # (/root/reference/host/src/arguments.c:81-92); the kernel is
        # exact at any width, but accepting values the reference rejects
        # would make the two CLIs disagree on the same flag string
        if not (0 <= self.open_gap <= 255):
            raise ValueError(
                f"open_gap must be in [0, 255], got {self.open_gap!r}")
        if not (0 <= self.extend_gap <= 127):
            raise ValueError(
                f"extend_gap must be in [0, 127], got {self.extend_gap!r}")
        if self.acc_dtype not in ("int32", "float32"):
            raise ValueError(
                f"acc_dtype must be 'int32' or 'float32', got "
                f"{self.acc_dtype!r}")
        if self.profile_mode not in ("auto", "precompute", "stream",
                                     "host_stream"):
            raise ValueError(
                f"profile_mode must be 'auto', 'precompute', 'stream' or "
                f"'host_stream', got {self.profile_mode!r}")
        if not (1 <= self.host_stream_slice_mb <= 2048):
            raise ValueError(
                f"host_stream_slice_mb must be in [1, 2048], got "
                f"{self.host_stream_slice_mb!r} (span byte offsets are "
                "int32 device operands, so a slice buffer must stay "
                "under 2 GiB)")
        if not (isinstance(self.stream_readback_window, int) and
                self.stream_readback_window >= 1):
            raise ValueError(
                f"stream_readback_window must be a positive int, got "
                f"{self.stream_readback_window!r}")

    def resolved_interpret(self) -> bool:
        """Kernel mode for the engine being built: the explicit setting,
        else the platform seam (kernels.kernel_interpret)."""
        if self.interpret is None:
            return kernel_interpret()
        return self.interpret

    def resolved_acc_dtype(self):
        return {"int32": jnp.int32, "float32": jnp.float32}[self.acc_dtype]


# Largest integer magnitude a float32 represents exactly (24-bit mantissa).
# Module-level (not inlined) so the exactness-guard test can shrink it and
# exercise the int32 fallback on an ordinary-sized database.
FP32_EXACT_LIMIT = 1 << 24


def resolve_exact_acc_dtype(config: "SearchConfig", submat, db):
    """The kernel accumulator dtype, demoted to int32 when fp32 exactness
    is not PROVABLE for this (matrix, database) pair.

    Every DP intermediate is bounded by max_score + max(submat) where
    max_score <= min(m, n) * max(submat) <= L_max * max(submat) (n, the
    subject length, never exceeds the longest bin).  When that bound stays
    under 2^24 every value is an exactly-representable float32 integer and
    fp32 (the ~10% faster issue rate, SearchConfig.acc_dtype) is exact for
    EVERY query length; otherwise — degenerate megaresidue-scale subjects —
    the engine silently switches to int32 rather than lose exactness.  The
    reference faces the analogous width problem per-lane and solves it with
    its 8->16->32-bit escalation ladder
    (/root/reference/host/src/HybridSearch.c:398-609); here the guard is a
    one-time static bound check.
    """
    acc = config.resolved_acc_dtype()
    if acc != jnp.float32:
        return acc
    smax = int(np.max(submat))
    l_max = max(db.bin_lengths, default=0)
    if smax > 0 and (l_max + 1) * smax >= FP32_EXACT_LIMIT:
        print(
            f"oswald-tpu: fp32 accumulator demoted to int32 — max subject "
            f"bin {l_max} x max substitution score {smax} reaches the "
            f"float32 exact-integer limit (2^24)", file=sys.stderr)
        return jnp.int32
    return acc


@dataclasses.dataclass
class SearchResult:
    query_title: str
    query_length: int
    scores: np.ndarray        # int32[k], descending
    seq_ids: np.ndarray       # int32[k], sorted-order ids into db.titles
    titles: list              # top-k subject titles
    # Wall seconds of the search call that produced this result.  For a
    # batched search (search_many) this is the WHOLE batch's wall time,
    # shared by all batch_n results — the queries ran inside common
    # device programs, so no truthful per-query split exists; divide by
    # batch_n for an amortised rate, never read it as one query's
    # latency when batch_n > 1.
    elapsed: float
    batch_n: int = 1          # queries sharing this elapsed (1 = alone)
    # empirical significance statistics (oswald_tpu.stats; None when the
    # database is too small for a meaningful extreme-value fit)
    evalues: np.ndarray | None = None      # float64[k]
    bit_scores: np.ndarray | None = None   # float64[k]
    stats: object | None = None            # stats.ScoreStats

    def per_query_elapsed(self) -> float:
        """Amortised per-query wall seconds (elapsed / batch_n) — the
        deliberate way to compute a rate from a batched result (see
        `elapsed`; for single searches this is just elapsed)."""
        return self.elapsed / max(self.batch_n, 1)


def _db_len_stats(db):
    """Static per-database length terms for the significance fit: the
    per-sorted-id float32 ln-length table (what the device dots against
    the scores), its float64 moment pair (sum, sum^2) over all sequences,
    and the (unique_lengths, counts) histogram the E-value integral uses.
    """
    lnl = np.log(np.maximum(np.asarray(db.lengths, np.float64),
                            1.0)).astype(np.float32)
    l64 = lnl.astype(np.float64)
    hist = np.unique(np.asarray(db.lengths), return_counts=True)
    return lnl, (float(l64.sum()), float((l64 * l64).sum())), hist


# packed trailing moment columns: [sum, sumsq, slnl, T1] row 0 and
# [c0, c1, T0, 0] row 1 (bitcast float32) — score moments for the
# length-regressed fit plus the censored tail summary for the round-5
# lambda recalibration (stats.tail_calibrate).  T1 = -1 is the sentinel
# for paths that cannot see the whole database in one program (per-bin
# distributed dispatch, distributed host_stream slices): they keep the
# moment-only fit.
MOM_COLS = 4
# tail thresholds for the count-ratio lambda estimator
# (stats.tail_calibrate): ~1.2 and ~2.5 hit-excluded sd above the mean
# put P(S >= T) around 1e-1 and 1e-2 — both in the exponential tail,
# far enough apart that ln(c0/c1)/(T1-T0) is a stable rate estimate
# even on a few-thousand-sequence database
TAIL_SDS0 = 1.2
TAIL_SDS = 2.5


def _result_stats(db, lnl_table, lnl_mom, len_hist,
                  top_scores, top_ids, mom, query_len):
    """Fit the length-regressed null model from streamed moments and score
    the hits.  mom: (msum, msumsq, mslnl, T1, c0, c1, T0) — see
    MOM_COLS.  Returns (evalues, bit_scores, ScoreStats|None); the
    reported hits (scores AND ln-lengths) are excluded from the fit so
    true positives can't tilt the trend or inflate the variance, and the
    tail summary recalibrates lambda (stats.tail_calibrate)."""
    msum, msumsq, mslnl, t1, c0, c1, t0 = [float(x) for x in mom]
    ids = np.maximum(np.asarray(top_ids, np.int64), 0)
    st = fit_score_model(db.n_seqs, msum, msumsq, mslnl,
                         lnl_mom[0], lnl_mom[1],
                         exclude_scores=top_scores,
                         exclude_lnl=lnl_table[ids])
    st = tail_calibrate(st, db.n_seqs, len_hist, t0, t1, c0, c1,
                        exclude_scores=top_scores)
    if st is None:
        return None, None, None
    ev = st.evalues(top_scores, db.n_seqs, len_hist)
    bits = st.bit_scores(top_scores, query_len,
                         db.n_residues / max(db.n_seqs, 1))
    return ev, bits, st


def _host_moments(scores_flat, valid_mask, lnl_flat, top_scores):
    """Host-side moment + tail payload of the valid scores (the
    host_stream analog of _append_moments: full score vectors are
    already in host RAM).  scores_flat: [n] or [Q, n]; top_scores the
    reported hits per row ([k] / [Q, k]) — excluded from the mean/sd the
    tail threshold derives from, exactly like the device path.  Returns
    (msum, msumsq, mslnl, T1, c0, c1, T0) scalars or [Q] arrays."""
    sf = np.asarray(scores_flat, np.float64)[..., valid_mask]
    l = np.asarray(lnl_flat, np.float64)[valid_mask]
    msum, msumsq = sf.sum(-1), (sf * sf).sum(-1)
    mslnl = (sf * l).sum(-1)
    tops = np.asarray(top_scores, np.float64)
    tv = tops >= 0
    n_ex = np.maximum(valid_mask.sum() - tv.sum(-1), 1)
    tf = np.where(tv, tops, 0.0)
    mean = (msum - tf.sum(-1)) / n_ex
    var = np.maximum((msumsq - (tf * tf).sum(-1)) / n_ex - mean * mean,
                     0.0)
    sd = np.sqrt(var)
    t0 = np.ceil(mean + TAIL_SDS0 * sd)
    t1 = np.ceil(mean + TAIL_SDS * sd)
    up = (lambda t: t[..., None]) if sf.ndim > 1 else (lambda t: t)
    c0 = (sf >= up(t0)).sum(-1).astype(np.float64)
    c1 = (sf >= up(t1)).sum(-1).astype(np.float64)
    return msum, msumsq, mslnl, t1, c0, c1, t0


def _search_bin_impl(q_pad, gaps, prof_stack, u_rows, interpret,
                     group_block=1, acc_dtype=jnp.int32, prof_tail=None,
                     col_unroll=16, noadj=False, nb=None):
    """Scan all column chunks of one bin; returns [G, 8, 128] int32 scores.

    prof_stack: int8[C, G, 24, POS, 128] precomputed score profiles for the
    full-width (128-position) chunks; prof_tail: optional int8[G, 24,
    POS/2, 128] profile for a trailing 64-position chunk (bins whose padded
    length is an odd multiple of 64).
    acc_dtype: kernel accumulator type — int32 or float32 (both exact for
    protein SW scores).
    Not jitted so it can be used inside shard_map (oswald_tpu.dist).
    """
    C, G = prof_stack.shape[0], prof_stack.shape[1]
    m_pad = q_pad.shape[0]
    colH = jnp.zeros((G, m_pad, SUBLANES, LANES), acc_dtype)
    colE = jnp.zeros_like(colH)
    scores = jnp.zeros((G, SUBLANES, LANES), acc_dtype)

    def one_chunk(carry, prof_c):
        colH, colE, scores = carry
        # per row block r the kernel needs only H[r*U - 1] of the previous
        # chunk's boundary column: a strided [G, R, 8, 128] slice, not a
        # full shifted copy of colH
        colHd = jnp.concatenate(
            [jnp.zeros((G, 1, SUBLANES, LANES), acc_dtype),
             colH[:, u_rows - 1::u_rows][:, :-1]], axis=1)
        scores, colH, colE = sw_chunk(q_pad, gaps, prof_c, colH, colHd,
                                      colE, scores, u_rows=u_rows,
                                      group_block=group_block,
                                      acc_dtype=acc_dtype,
                                      interpret=interpret,
                                      col_unroll=col_unroll, noadj=noadj,
                                      n_blocks=nb)
        return (colH, colE, scores), None

    carry, _ = jax.lax.scan(one_chunk, (colH, colE, scores), prof_stack)
    if prof_tail is not None:
        carry, _ = one_chunk(carry, prof_tail)
    return carry[2].astype(jnp.int32)


def _search_bin_stream_impl(q_pad, gaps, submat, seq_chunks, u_rows,
                            interpret, group_block=1, acc_dtype=jnp.int32,
                            seq_tail=None, col_unroll=16, noadj=False,
                            nb=None):
    """Like `_search_bin_impl` but builds each chunk's score profile on the
    fly from the packed residues (seq_chunks: int8[C, G, W, 8, 128],
    seq_tail: optional int8[G, W/2, 8, 128]).

    Trades one extra profile build per query for 24x less device memory —
    the mode for databases whose precomputed profiles would not fit (the
    reference always rebuilds profiles per chunk,
    /root/reference/host/src/HybridSearch.c:141-173; here it is a config
    choice because the precomputed profile is usually affordable).
    """
    C, G = seq_chunks.shape[0], seq_chunks.shape[1]
    m_pad = q_pad.shape[0]
    colH = jnp.zeros((G, m_pad, SUBLANES, LANES), acc_dtype)
    colE = jnp.zeros_like(colH)
    scores = jnp.zeros((G, SUBLANES, LANES), acc_dtype)

    def one_chunk(carry, seq_c):
        colH, colE, scores = carry
        prof_c = build_profile(seq_c, submat)
        colHd = jnp.concatenate(
            [jnp.zeros((G, 1, SUBLANES, LANES), acc_dtype),
             colH[:, u_rows - 1::u_rows][:, :-1]], axis=1)
        scores, colH, colE = sw_chunk(q_pad, gaps, prof_c, colH, colHd,
                                      colE, scores, u_rows=u_rows,
                                      group_block=group_block,
                                      acc_dtype=acc_dtype,
                                      interpret=interpret,
                                      col_unroll=col_unroll, noadj=noadj,
                                      n_blocks=nb)
        return (colH, colE, scores), None

    carry, _ = jax.lax.scan(one_chunk, (colH, colE, scores), seq_chunks)
    if seq_tail is not None:
        carry, _ = one_chunk(carry, seq_tail)
    return carry[2].astype(jnp.int32)


def _seg_start_mask(seg_map, R, q_segs, u_rows):
    """bool[R] marking segment-start row blocks — from the dynamic seg_map
    when given, else the uniform bps-periodic layout."""
    if seg_map is None:
        return (jnp.arange(R) % (R // q_segs)) == 0
    return jnp.concatenate(
        [jnp.ones((1,), bool), seg_map[1:] != seg_map[:-1]])


def _search_bin_flat_pack_impl(q_packed, gaps, prof_flat, tail_flat, off,
                               C, G, toff, q_segs, u_rows, interpret,
                               group_block=1, acc_dtype=jnp.int32,
                               col_unroll=16, noadj=False, seg_map=None,
                               nb=None):
    """Like `_search_bin_flat_impl` but with q_segs INDEPENDENT queries
    packed along the row axis (kernels.sw_chunk q_segs): one kernel pass
    per chunk scores every packed query, reading each profile block from
    HBM once instead of once per query.  For short queries the profile
    stream dominates the scan, so this multiplies arithmetic intensity by
    q_segs — the fix for the short-query batch gap (qlen-64 batches
    measured ~0.6x the qlen-512 rate with the per-query scan).

    q_packed: int32[q_segs * seg_rows] (each segment DUMMY-padded), or —
    with seg_map (int32[R], see sw_chunk) — UNEQUAL segments, so a mixed
    100-400aa batch rides one program (mixed_pack_plan builds the layout).
    Returns int32[q_segs, G, 8, 128].
    """
    m_tot = q_packed.shape[0]
    A, POS = prof_flat.shape[1], prof_flat.shape[2]
    R = m_tot // u_rows
    start = _seg_start_mask(seg_map, R, q_segs, u_rows)
    colH = jnp.zeros((G, m_tot, SUBLANES, LANES), acc_dtype)
    colE = jnp.zeros_like(colH)
    scores = jnp.zeros((G, q_segs, SUBLANES, LANES), acc_dtype)

    def one_chunk(carry, prof_c):
        colH, colE, scores = carry
        colHd = jnp.concatenate(
            [jnp.zeros((G, 1, SUBLANES, LANES), acc_dtype),
             colH[:, u_rows - 1::u_rows][:, :-1]], axis=1)
        # segment-start row blocks take no carried diagonal from the
        # previous row (it belongs to the previous packed query)
        colHd = jnp.where(start[None, :, None, None], 0, colHd)
        scores, colH, colE = sw_chunk(q_packed, gaps, prof_c, colH, colHd,
                                      colE, scores, u_rows=u_rows,
                                      group_block=group_block,
                                      acc_dtype=acc_dtype,
                                      interpret=interpret,
                                      col_unroll=col_unroll, noadj=noadj,
                                      q_segs=q_segs, seg_map=seg_map,
                                      n_blocks=nb)
        return (colH, colE, scores)

    def body(c, carry):
        prof_c = jax.lax.dynamic_slice(
            prof_flat, (off + c * G, 0, 0, 0), (G, A, POS, LANES))
        return one_chunk(carry, prof_c)

    carry = (colH, colE, scores)
    if C:
        carry = jax.lax.fori_loop(0, C, body, carry)
    if toff is not None:
        tail_c = jax.lax.dynamic_slice(
            tail_flat, (toff, 0, 0, 0), (G,) + tuple(tail_flat.shape[1:]))
        carry = one_chunk(carry, tail_c)
    return carry[2].astype(jnp.int32).transpose(1, 0, 2, 3)


def _search_bin_stream_pack_impl(q_packed, gaps, submat, seq_chunks,
                                 q_segs, u_rows, interpret, group_block=1,
                                 acc_dtype=jnp.int32, seq_tail=None,
                                 col_unroll=16, noadj=False, seg_map=None,
                                 nb=None):
    """Packed-segment variant of `_search_bin_stream_impl` (see
    `_search_bin_flat_pack_impl`): q_segs independent queries per kernel
    pass, so the per-chunk profile gather AND its HBM read are paid once
    per chunk for the whole pack.  Returns int32[q_segs, G, 8, 128]."""
    C, G = seq_chunks.shape[0], seq_chunks.shape[1]
    m_tot = q_packed.shape[0]
    start = _seg_start_mask(seg_map, m_tot // u_rows, q_segs, u_rows)
    colH = jnp.zeros((G, m_tot, SUBLANES, LANES), acc_dtype)
    colE = jnp.zeros_like(colH)
    scores = jnp.zeros((G, q_segs, SUBLANES, LANES), acc_dtype)

    def one_chunk(carry, seq_c):
        colH, colE, scores = carry
        prof_c = build_profile(seq_c, submat)
        colHd = jnp.concatenate(
            [jnp.zeros((G, 1, SUBLANES, LANES), acc_dtype),
             colH[:, u_rows - 1::u_rows][:, :-1]], axis=1)
        colHd = jnp.where(start[None, :, None, None], 0, colHd)
        scores, colH, colE = sw_chunk(q_packed, gaps, prof_c, colH, colHd,
                                      colE, scores, u_rows=u_rows,
                                      group_block=group_block,
                                      acc_dtype=acc_dtype,
                                      interpret=interpret,
                                      col_unroll=col_unroll, noadj=noadj,
                                      q_segs=q_segs, seg_map=seg_map,
                                      n_blocks=nb)
        return (colH, colE, scores), None

    carry, _ = jax.lax.scan(one_chunk, (colH, colE, scores), seq_chunks)
    if seq_tail is not None:
        carry, _ = one_chunk(carry, seq_tail)
    return carry[2].astype(jnp.int32).transpose(1, 0, 2, 3)


def _search_bin_stream_batch_impl(q_batch, gaps, submat, seq_chunks,
                                  u_rows, interpret, group_block=1,
                                  acc_dtype=jnp.int32, seq_tail=None,
                                  col_unroll=16, noadj=False, nbs=None):
    """Batched `_search_bin_stream_impl`: same-padded-length queries scan
    sequentially inside ONE compiled program (int32[Q, G, 8, 128]), so
    stream-mode batches amortise dispatch like the precompute flat-batch
    path does.  nbs: optional int32[Q] per-query real row-block counts
    (each query skips ITS OWN quantum padding, see sw_chunk n_blocks)."""
    def one(_, qn):
        q_pad, nb = qn if nbs is not None else (qn, None)
        return None, _search_bin_stream_impl(
            q_pad, gaps, submat, seq_chunks, u_rows, interpret,
            group_block, acc_dtype, seq_tail, col_unroll, noadj, nb=nb)
    _, scores = jax.lax.scan(one, None,
                             (q_batch, nbs) if nbs is not None else q_batch)
    return scores


def _search_bin_hostslice_impl(q_batch, gaps, submat, seq_slice, u_rows,
                               interpret, group_block=1,
                               acc_dtype=jnp.int32, col_unroll=16,
                               noadj=False, nbs=None):
    """Scores for a query batch against one host-streamed group slice.

    seq_slice: int8[Gs, L, 8, 128] packed residues as stored on disk — the
    slice is transferred in its storage layout (so a memory-mapped .oswt
    bin can be device_put without any host-side copy) and rearranged into
    chunk-major [C, Gs, W, 8, 128] on device, where the reshuffle is HBM
    bandwidth, not PCIe.  Returns int32[Q, Gs, 8, 128].
    """
    Gs, L = seq_slice.shape[0], seq_slice.shape[1]
    C = L // CHUNK_WIDTH
    main = seq_slice[:, :C * CHUNK_WIDTH].reshape(
        Gs, C, CHUNK_WIDTH, SUBLANES, LANES).transpose(1, 0, 2, 3, 4)
    tail = seq_slice[:, C * CHUNK_WIDTH:] if L % CHUNK_WIDTH else None

    def one(_, qn):
        q_pad, nb = qn if nbs is not None else (qn, None)
        return None, _search_bin_stream_impl(
            q_pad, gaps, submat, main, u_rows, interpret, group_block,
            acc_dtype, tail, col_unroll, noadj, nb=nb)
    _, scores = jax.lax.scan(one, None,
                             (q_batch, nbs) if nbs is not None else q_batch)
    return scores


def _search_bin_hostflat_impl(q_batch, gaps, submat, buf, off, Gs, L,
                              u_rows, interpret, group_block=1,
                              acc_dtype=jnp.int32, col_unroll=16,
                              noadj=False, nbs=None):
    """`_search_bin_hostslice_impl` over a SPAN of a coalesced transfer
    buffer: buf is one flat int8 array holding whole groups from SEVERAL
    bins (one host->device transfer per byte-budget slice, matching the
    reference's fixed-size chunks that ignore sequence-group boundaries,
    /root/reference/host/src/FPGAsearch.c:180-237 + sequences.c:505-541);
    the span's [Gs, L, 8, 128] window is dynamic-sliced out ON DEVICE (a
    traced byte offset, so spans sharing (Gs, L) share one compiled
    program regardless of where they sit in the buffer)."""
    nbytes = Gs * L * SUBLANES * LANES
    seq_slice = jax.lax.dynamic_slice(buf, (off,), (nbytes,)).reshape(
        Gs, L, SUBLANES, LANES)
    return _search_bin_hostslice_impl(
        q_batch, gaps, submat, seq_slice, u_rows, interpret, group_block,
        acc_dtype, col_unroll, noadj, nbs=nbs)


def _search_bin_flat_impl(q_pad, gaps, prof_flat, tail_flat, off, C, G,
                          toff, u_rows, interpret, group_block=1,
                          acc_dtype=jnp.int32, col_unroll=16, noadj=False,
                          nb=None):
    """Like `_search_bin_impl` but reads this bin's chunk profiles out of
    the ENGINE-WIDE flat profile array.

    prof_flat: int8[Ctot, 24, POS, 128] — profiles of every 128-wide chunk
    of every bin, bin (c, g) entries at `off + c*G + g`; tail_flat:
    int8[Ttot, 24, POS/2, 128] with this bin's tail block (if toff is not
    None) at [toff, toff+G).  One flat array + static offsets means engine
    setup runs ONE compiled profile gather for the whole database instead
    of one per bin shape (per-bin-shape programs made setup
    compile-bound)."""
    m_pad = q_pad.shape[0]
    A, POS = prof_flat.shape[1], prof_flat.shape[2]
    colH = jnp.zeros((G, m_pad, SUBLANES, LANES), acc_dtype)
    colE = jnp.zeros_like(colH)
    scores = jnp.zeros((G, SUBLANES, LANES), acc_dtype)

    def one_chunk(carry, prof_c):
        colH, colE, scores = carry
        colHd = jnp.concatenate(
            [jnp.zeros((G, 1, SUBLANES, LANES), acc_dtype),
             colH[:, u_rows - 1::u_rows][:, :-1]], axis=1)
        scores, colH, colE = sw_chunk(q_pad, gaps, prof_c, colH, colHd,
                                      colE, scores, u_rows=u_rows,
                                      group_block=group_block,
                                      acc_dtype=acc_dtype,
                                      interpret=interpret,
                                      col_unroll=col_unroll, noadj=noadj,
                                      n_blocks=nb)
        return (colH, colE, scores)

    def body(c, carry):
        prof_c = jax.lax.dynamic_slice(
            prof_flat, (off + c * G, 0, 0, 0), (G, A, POS, LANES))
        return one_chunk(carry, prof_c)

    carry = (colH, colE, scores)
    if C:       # static; a tail-only bin traces no fori body (prof_flat
                # may be empty when the whole database is tail bins)
        carry = jax.lax.fori_loop(0, C, body, carry)
    if toff is not None:
        tail_c = jax.lax.dynamic_slice(
            tail_flat, (toff, 0, 0, 0), (G,) + tuple(tail_flat.shape[1:]))
        carry = one_chunk(carry, tail_c)
    return carry[2].astype(jnp.int32)


def _search_bin_flat_batch_impl(q_batch, gaps, prof_flat, tail_flat, off,
                                C, G, toff, u_rows, interpret,
                                group_block=1, acc_dtype=jnp.int32,
                                col_unroll=16, noadj=False, nbs=None):
    """Query-batch scan over `_search_bin_flat_impl`: queries run
    sequentially inside one compiled program, amortising dispatch (the
    reference loops queries inside one chunk's device round the same way,
    FPGAsearch.c:204-219); _search_bin_flat_pack_impl goes further for
    short queries by also sharing the profile reads."""
    def one(_, qn):
        q_pad, nb = qn if nbs is not None else (qn, None)
        return None, _search_bin_flat_impl(
            q_pad, gaps, prof_flat, tail_flat, off, C, G, toff, u_rows,
            interpret, group_block, acc_dtype, col_unroll, noadj, nb=nb)
    _, scores = jax.lax.scan(one, None,
                             (q_batch, nbs) if nbs is not None else q_batch)
    return scores


_STATIC = ("u_rows", "interpret", "group_block", "acc_dtype", "col_unroll",
           "noadj")
# off/toff stay traced (dynamic_slice takes traced starts), so bins that
# share (C, G) shapes also share one compiled search program
_FLAT_STATIC = _STATIC + ("C", "G")
_search_bin = jax.jit(_search_bin_impl, static_argnames=_STATIC)
_search_bin_stream = jax.jit(_search_bin_stream_impl, static_argnames=_STATIC)
_search_bin_stream_batch = jax.jit(_search_bin_stream_batch_impl,
                                   static_argnames=_STATIC)
_search_bin_stream_pack = jax.jit(_search_bin_stream_pack_impl,
                                  static_argnames=_STATIC + ("q_segs",))
_search_bin_hostslice = jax.jit(_search_bin_hostslice_impl,
                                static_argnames=_STATIC)
_search_bin_hostflat = jax.jit(_search_bin_hostflat_impl,
                               static_argnames=_STATIC + ("Gs", "L"))
_search_bin_flat = jax.jit(_search_bin_flat_impl,
                           static_argnames=_FLAT_STATIC)
_search_bin_flat_batch = jax.jit(_search_bin_flat_batch_impl,
                                 static_argnames=_FLAT_STATIC)
_search_bin_flat_pack = jax.jit(_search_bin_flat_pack_impl,
                                static_argnames=_FLAT_STATIC + ("q_segs",))


_build_profile_jit = jax.jit(build_profile)


@functools.partial(jax.jit, static_argnames=_STATIC + ("k", "geom"))
def _fused_search(q_pad, nb, gaps, submat, stacks, valid, lnl, *, k, geom,
                  u_rows, interpret, group_block, acc_dtype, col_unroll,
                  noadj):
    """Every bin's scan plus the masked top-k as one program (see
    SearchEngine._search_fn).  geom: ((L, (off, C, G, toff, tw)), ...) in
    precompute mode, where stacks = (prof_flat, tail_flats); ((L, None),
    ...) in stream mode, where stacks = {L: (main, tail)}."""
    outs = []
    for L, g in geom:
        if g is not None:
            prof_flat, tail_flats = stacks
            off, C, G, toff, tw = g
            s = _search_bin_flat_impl(
                q_pad, gaps, prof_flat,
                tail_flats[tw] if toff is not None else None, off, C, G,
                toff, u_rows, interpret, group_block, acc_dtype, col_unroll,
                noadj, nb=nb)
        else:
            main, tail = stacks[L]
            s = _search_bin_stream_impl(
                q_pad, gaps, submat, main, u_rows, interpret, group_block,
                acc_dtype, tail, col_unroll, noadj, nb=nb)
        outs.append(s.reshape(-1))
    flat = jnp.concatenate(outs) if outs else jnp.zeros((0,), jnp.int32)
    masked = jnp.where(valid, flat, -1)
    vals, idx = jax.lax.top_k(masked, k)
    # packed [2, k+MOM_COLS] incl. score moments: one readback (see _topk)
    return _append_moments(
        jnp.stack([vals, idx.astype(jnp.int32)]), flat, valid, lnl)


@jax.jit
def _stack_packed(*arrs):
    """Stack a readback window's per-query packed arrays on device so the
    host pays ONE transfer per window instead of one per query (see
    SearchConfig.stream_readback_window)."""
    return jnp.stack(arrs)


def _append_moments(packed, scores_flat, valid, lnl):
    """Append MOM_COLS int32 columns holding the bitcast f32 score
    moments [sum(S), sum(S^2), sum(S*lnL), T1] / [c0, c1, T0, 0]
    over the valid slots to a packed [2, k] top-k array: the moments
    feed the host-side length-regressed extreme-value significance fit
    (oswald_tpu.stats), the (T0, T1, c0, c1) censored tail counts its
    round-5 lambda recalibration (stats.tail_calibrate) — and all of it
    rides the SAME readback as the hits, so the full score vector never
    crosses the host boundary and no extra round trip is paid.

    The tail threshold T1 derives from the mean/sd EXCLUDING the top-k
    the program just computed (packed row 0), so a planted true positive
    cannot inflate its own null's threshold; the counts themselves
    include the hits (the host subtracts the reported scores >= T1 —
    it knows them exactly)."""
    sf = jnp.where(valid, scores_flat, 0).astype(jnp.float32)
    n = jnp.sum(valid.astype(jnp.float32))
    s1, s2 = jnp.sum(sf), jnp.sum(sf * sf)
    slnl = jnp.sum(sf * lnl)
    top = packed[0].astype(jnp.float32)
    topv = top >= 0                   # masked padding tops read -1
    tf = jnp.where(topv, top, 0.0)
    n_ex = jnp.maximum(n - jnp.sum(topv.astype(jnp.float32)), 1.0)
    mean = (s1 - jnp.sum(tf)) / n_ex
    var = jnp.maximum((s2 - jnp.sum(tf * tf)) / n_ex - mean * mean, 0.0)
    sd = jnp.sqrt(var)
    t0 = jnp.ceil(mean + TAIL_SDS0 * sd)
    t1 = jnp.ceil(mean + TAIL_SDS * sd)
    c0 = jnp.sum((valid & (sf >= t0)).astype(jnp.float32))
    c1 = jnp.sum((valid & (sf >= t1)).astype(jnp.float32))
    z = jnp.zeros((), jnp.float32)
    mom = jnp.stack([s1, s2, slnl, t1, c0, c1, t0, z])
    cols = jax.lax.bitcast_convert_type(mom, jnp.int32).reshape(2, MOM_COLS)
    return jnp.concatenate([packed, cols], axis=1)


def _unpack_topk(arr):
    """Host unpack of a packed readback int32[..., 2, k+MOM_COLS] ->
    (scores[..., k], slots[..., k], mom) where mom = (sum, sumsq, slnl,
    T1, c0, c1, T0) each [...]-shaped float64 (see _append_moments)."""
    mom = np.ascontiguousarray(arr[..., :, -MOM_COLS:]).view(np.float32)
    m = tuple(mom[..., r, c].astype(np.float64)
              for r, c in ((0, 0), (0, 1), (0, 2), (0, 3),
                           (1, 0), (1, 1), (1, 2)))
    return arr[..., 0, :-MOM_COLS], arr[..., 1, :-MOM_COLS], m


def _split_packed(arr, widths):
    """Split a host-side concatenation of per-bin/per-program packed
    candidate arrays ([2, W] or [2, Q, W] int32, each contributing
    widths[i] columns whose last MOM_COLS columns are its bitcast
    moments — see _append_moments) into (scores, ids, mom): candidates
    re-concatenated without the moments columns; the SCORE moments (sum,
    sumsq, slnl) sum over segments; the tail payload (T1, c0, c1, T0)
    is NOT additive (counts are relative to a segment's own thresholds)
    and is taken from the single non-sentinel segment when one exists —
    at most one can: only a whole-database program emits it (the fused
    path emits exactly one segment; per-bin distributed programs emit
    the sentinel -1 in every segment, keeping the moment-only fit).
    Callers composing MULTIPLE whole-database segments would need a
    different aggregation — assert-guarded below."""
    s_parts, i_parts = [], []
    msum = msumsq = mslnl = 0.0
    t1, c0, c1, t0 = -1.0, 0.0, 0.0, -1.0
    tail_seen = False
    off = 0
    for w in widths:
        seg = arr[..., off:off + w]
        mom = np.ascontiguousarray(seg[..., -MOM_COLS:]).view(np.float32) \
            .astype(np.float64)
        msum = msum + mom[0, ..., 0]
        msumsq = msumsq + mom[0, ..., 1]
        mslnl = mslnl + mom[0, ..., 2]
        if np.all(mom[0, ..., 3] >= 0):
            # the one whole-database segment (fused dispatch) carries the
            # tail summary; per-bin segments all emit the sentinel
            assert not tail_seen, \
                "multiple tail-bearing segments cannot be aggregated"
            tail_seen = True
            t1, c0, c1, t0 = (mom[0, ..., 3], mom[1, ..., 0],
                              mom[1, ..., 1], mom[1, ..., 2])
        s_parts.append(seg[0, ..., :-MOM_COLS])
        i_parts.append(seg[1, ..., :-MOM_COLS])
        off += w
    return (np.concatenate(s_parts, axis=-1),
            np.concatenate(i_parts, axis=-1),
            (msum, msumsq, mslnl, t1, c0, c1, t0))


@functools.partial(jax.jit, static_argnames=("k",))
def _topk(scores_flat, valid, lnl, k):
    """Masked top-k, PACKED as one int32[2, k+2] array (scores row 0, slot
    indices row 1, score moments in the last columns — _append_moments).
    One output array means ONE device->host transfer instead of two for a
    (values, indices) tuple."""
    masked = jnp.where(valid, scores_flat, -1)
    vals, idx = jax.lax.top_k(masked, k)
    packed = jnp.stack([vals.astype(jnp.int32), idx.astype(jnp.int32)])
    return _append_moments(packed, scores_flat, valid, lnl)


def _host_topk(scores_flat, ids_flat, k):
    """Host-side top-k with lax.top_k's exact tie-break (lowest slot index
    first) — host_stream scores are already in host RAM, a device round
    trip for the reduction would cost more than the sort."""
    masked = np.where(ids_flat >= 0, scores_flat, -1)
    order = np.lexsort((np.arange(masked.size), -masked))[:k]
    return masked[order].astype(np.int32), order


# segment slots per mixed-pack bin: caps the per-bin query count (score
# slab rows and top-k fan-out scale with it) while letting a full
# 1024-row bin hold 32 tiny queries; the kernel touches only the slots
# its row blocks use, so the cap is a top-k-cost knob
MIXED_PACK_SEGS = 32


def mixed_pack_plan(pack_rows: int, u_rows: int, queries,
                    max_segs: int = MIXED_PACK_SEGS):
    """First-fit-decreasing bin plan for a MIXED-length query batch.

    Packs whole queries — padded only to the u_rows row quantum — into
    bins of at most pack_rows rows and max_segs queries; each bin runs as
    ONE packed kernel program (sw_chunk seg_map), so a mixed 100-400aa
    batch reads each profile block from HBM once for up to max_segs
    queries.  This is the general form of the reference's
    all-queries-per-uploaded-chunk loop (arbitrary per-query m,
    /root/reference/host/src/FPGAsearch.c:204-219).  A bin's row count is
    rounded up to a power of two, and seg_map is a traced operand, so
    every batch layout shares a logarithmic ladder of compiled programs
    keyed by (rows, max_segs) only.

    SHARED by the single-chip and distributed engines — their results are
    parity-tested against each other, so the bin policy must stay
    identical.

    Returns (bins, rest): bins = [(idxs, q_packed int32[m_tot],
    seg_map int32[m_tot//u_rows], used_blocks)] with idxs[s] the query in
    segment slot s and used_blocks the real (non-filler) row-block count
    — the kernel's dummy-block skip trip count (sw_chunk n_blocks); rest
    = indices of queries too long to pack (> pack_rows rows) that ride
    the per-pad-class batch path instead.
    """
    n = len(queries)
    if not pack_rows or pack_rows // u_rows < 2 or n < 2:
        return [], list(range(n))
    r_cap = pack_rows // u_rows
    qarrs = [np.asarray(q, np.int32) for q in queries]
    for q in qarrs:
        # same guard as pad_query (which packed queries bypass): raw
        # ASCII would index the 24-row profile out of bounds
        if q.size and (q.min() < 0 or q.max() > DUMMY):
            raise ValueError(
                "query contains codes outside 0..23 — encode residue "
                "strings with oswald_tpu.encode() first")
    blocks = [max(1, -(-int(q.size) // u_rows)) for q in qarrs]
    rest = [i for i in range(n) if blocks[i] > r_cap]
    order = sorted((i for i in range(n) if blocks[i] <= r_cap),
                   key=lambda i: (-blocks[i], i))
    bins = []                        # [used_blocks, [query index, ...]]
    for i in order:
        for b in bins:
            if b[0] + blocks[i] <= r_cap and len(b[1]) < max_segs:
                b[0] += blocks[i]
                b[1].append(i)
                break
        else:
            bins.append([blocks[i], [i]])
    out = []
    for used, idxs in bins:
        # pow2 ladder, but never past the configured row budget: the cap
        # bounds the scan-state HBM (colH/colE scale with packed rows), so
        # a non-pow2 pack_rows must not silently allocate the next pow2
        rb = min(r_cap, max(2, 1 << (used - 1).bit_length()))
        qp = np.full(rb * u_rows, DUMMY, np.int32)
        sm = np.empty(rb, np.int32)
        off = 0
        for s, i in enumerate(idxs):
            qp[off * u_rows: off * u_rows + qarrs[i].size] = qarrs[i]
            sm[off: off + blocks[i]] = s
            off += blocks[i]
        # trailing filler blocks: a fresh all-DUMMY slot when one is free
        # (score-inert, sliced away), else they extend the last segment
        # with DUMMY rows (also score-inert)
        sm[off:] = min(len(idxs), max_segs - 1)
        out.append((idxs, qp, sm, off))
    return out, rest


def warmup_engine(engine, max_query_len: int = 512, batch: bool = True,
                  log=None, jobs: int = 1):
    """Shared warmup for both engines: precompile every (bin, padded-query)
    program for queries up to max_query_len — in BOTH kernel variants
    (dummy-block skip and branch-free full-class, see sw_chunk n_blocks)
    — and (batch=True) the common packed/batched program rungs per batch
    pad class (1-query and 2-query packs, both variants).  Larger bursts
    whose pack rung wasn't warmed still compile their own (m_tot, S)
    program on first sight — the ladder is logarithmic, so a serving
    deployment converges after a handful of requests.

    jobs: warmup steps can run in a thread pool (the warmed programs are
    independent and compiles release the GIL).  Default 1 — serial:
    programs first-traced inside pool threads can hash to different
    persistent-cache keys than main-thread traces, fragmenting the cache
    across serve/CLI call contexts.  Whether jobs > 1 pays on a GPU host
    is not measured yet.

    With the persistent compilation cache primed
    (oswald_tpu.utils.compile_cache, on by default in the CLI/bench) a
    restart replays the ladder from the cache instead of recompiling.
    `log` gets one line per step so the startup is visibly progressing.
    Returns the single-query padded lengths compiled."""
    t_start = time.perf_counter()
    # never warm past the engine's accepted cap (pad_query rejects longer)
    max_query_len = min(max_query_len, engine.config.max_query_len)

    def say(msg):
        if log:
            log(f"warmup [{time.perf_counter() - t_start:5.0f}s] {msg}")

    items = []                      # (description, thunk)
    m_pads = []
    m = 1
    while True:
        m_pad = pad_query(np.zeros(m, np.int8), engine.config).shape[0]
        if not m_pads or m_pad != m_pads[-1]:
            m_pads.append(m_pad)
            # TWO lengths per pad class: the class start (compiles the
            # dummy-block-SKIP kernel variant, sw_chunk n_blocks) and the
            # full class length (compiles the branch-free nb=None variant
            # — a query that exactly fills its class selects a DIFFERENT
            # program, and warming only one leaves the other cold)
            q_skip = np.full(min(m, max_query_len), DUMMY, np.int8)
            items.append((f"single-query pad class {m_pad} (skip variant)",
                          lambda q=q_skip: engine.search(q)))
            if m_pad <= max_query_len and m_pad != m:
                q_full = np.full(m_pad, DUMMY, np.int8)
                items.append(
                    (f"single-query pad class {m_pad} (branch-free)",
                     lambda q=q_full: engine.search(q)))
        if m_pad >= max_query_len:
            break
        m = m_pad + 1
    if batch:
        # the packed-batch programs are keyed by (packed rows, S) with
        # pow2-laddered rows, each in a skip and a no-skip variant.  Per
        # pad class compile: the full-length pair (used = 2*b blocks, b
        # pow2, so rb == used -> the branch-free 2-pack rung), the
        # boundary-length pair (same rb, skip variant), and a forced
        # split against a pack-cap-sized query (separate bins -> the
        # 1-query rungs).  Larger bursts may still compile their rung on
        # first sight — the ladder is logarithmic and converges after a
        # few requests.
        b_pads = set()
        # the split-forcer must be sized against the PACK cap, not
        # max_query_len: qf + q_cap must exceed the bin budget so
        # mixed_pack_plan puts them in separate bins (compiling the
        # 1-query pack rungs); truncating to max_query_len let them share
        # one bin and left those rungs cold.  (Clamped to the engine's
        # accepted cap: a low-max_query_len engine simply skips the
        # forced-split rungs.)
        cap_rows = min(max(engine.config.batch_query_pack_rows,
                           engine.config.u_rows),
                       engine.config.max_query_len)
        q_cap = np.full(cap_rows, DUMMY, np.int8)
        m = 1
        while True:
            m_pad = pad_query(np.zeros(m, np.int8), engine.config,
                              for_batch=True).shape[0]
            if m_pad not in b_pads:
                b_pads.add(m_pad)
                qb = np.full(min(m, max_query_len), DUMMY, np.int8)
                qf = np.full(min(m_pad, max_query_len), DUMMY, np.int8)
                items.append((f"batch pad class {m_pad}: 2-query pack "
                              f"rungs", lambda q=qf:
                              engine.search_many([q, q])))
                if m != m_pad:
                    items.append((f"batch pad class {m_pad}: 2-query "
                                  f"boundary rungs", lambda q=qb:
                                  engine.search_many([q, q])))
                items.append((f"batch pad class {m_pad}: 1-query pack "
                              f"rungs", lambda q=qf:
                              engine.search_many([q, q_cap])))
            if m_pad >= max_query_len:
                break
            m = m_pad + 1

    def run_one(desc, thunk):
        say(desc)
        thunk()

    if jobs > 1 and len(items) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=jobs) as ex:
            futs = [ex.submit(run_one, d, t) for d, t in items]
            for f in futs:
                f.result()          # propagate the first failure
    else:
        for d, t in items:
            run_one(d, t)
    engine.metrics.add("warmup", 0.0)
    return m_pads


def nb_of(qlen: int, u_rows: int) -> int:
    """Real row-block count for a true query length — the kernel's
    dummy-row-block skip trip count (>= 1 so block 0 still initialises
    the kernel state; see sw_chunk n_blocks)."""
    return max(1, -(-int(qlen) // u_rows))


def nb_or_none(qlen: int, m_pad: int, u_rows: int):
    """Skip trip count as a traced scalar, or None when the query fills
    its pad class — None compiles the branch-free kernel variant (the
    always-on grid branch costs ~2% even when it never skips)."""
    nb = nb_of(qlen, u_rows)
    return None if nb * u_rows >= m_pad else jnp.asarray(nb, jnp.int32)


def pad_query(query, config: "SearchConfig", for_batch: bool = False):
    """Pad an encoded query with DUMMY rows per config.query_pad_quantum
    (adaptive: see SearchConfig; batched searches use the coarser
    batch_query_pad_quantum).  Rejects un-encoded input — raw ASCII would
    index the 24-row score profile out of bounds and silently score
    garbage."""
    q = np.asarray(query, dtype=np.int32)
    if q.size and (q.min() < 0 or q.max() > DUMMY):
        raise ValueError(
            "query contains codes outside 0..23 — encode residue strings "
            "with oswald_tpu.encode() first")
    if q.size > config.max_query_len:
        # the planner budgeted scan state for max_query_len only; running
        # a longer query could OOM a resident database mid-search (the
        # reference hard-caps at its channel depth the same way, sw.cl:5)
        raise ValueError(
            f"query length {q.size} exceeds the engine's configured "
            f"max_query_len {config.max_query_len} — rebuild the engine "
            f"with SearchConfig(max_query_len=...) / --max-query-len "
            f"(device memory is planned for the configured cap)")
    if q.size == 0:
        q = np.full(1, DUMMY, np.int32)
    base = config.batch_query_pad_quantum if for_batch else \
        config.query_pad_quantum
    quantum = max(base, config.u_rows,
                  (1 << max(int(q.size).bit_length() - 1, 0)) // 8)
    m_pad = -(-q.size // quantum) * quantum
    return np.concatenate([q, np.full(m_pad - q.size, DUMMY, np.int32)])


class SearchEngine:
    """Searches one packed database with a fixed matrix/gap configuration.

    Score profiles (24x the database residues, int8) are precomputed on
    device once and reused across queries — the reference rebuilds its
    SSSE3 profiles per chunk per search (HybridSearch.c:141-173); here the
    rebuild would cost device-memory bandwidth on every query instead of
    one gather at engine construction.
    """

    def __init__(self, db: PackedDB, config: SearchConfig = None):
        self.db = db
        self.config = config or SearchConfig()
        self.submat = get_submat(self.config.matrix)
        self._interpret = self.config.resolved_interpret()
        # fp32 accumulation demotes to int32 when the score bound reaches
        # the float32 exact-integer limit (see resolve_exact_acc_dtype)
        self._acc = resolve_exact_acc_dtype(self.config, self.submat, db)
        # relaxed E-update (one fewer op/cell) when exact for this
        # matrix/gap config — see kernels.noadj_ok
        self._noadj = noadj_ok(self.submat, self.config.extend_gap)
        self.gaps = jnp.asarray(
            [self.config.open_gap, self.config.extend_gap], jnp.int32)

        # resolve "auto" through the HBM capacity planner (the analog of
        # the reference's 0.8*global_mem chunk cap, utils.c:162-168)
        self.mode = self.config.profile_mode
        if self.mode == "auto":
            plan = plan_profile_mode(db, self.config.hbm_budget_bytes,
                                     max_query_len=self.config.max_query_len,
                                     config=self.config)
            self.mode = plan.mode
            # stderr: --json runs must keep stdout machine-readable
            print(f"oswald-tpu engine: {plan.describe()}", file=sys.stderr)

        # per bin, on device: [C, G, 24, POS, 128] int8 profiles
        # (precompute mode) or [C, G, W, 8, 128] int8 residues (stream
        # mode); host_stream keeps the mmap'd storage-layout bins on the
        # host and transfers group slices per search.  G is padded to a
        # multiple of group_block with dummy groups (DUMMY residues score 0
        # everywhere, ids -1 mask them out of top-k).
        self.metrics = Metrics()
        gb = self.config.group_block
        self.seq_stacks = {}
        self._hs_slices = []            # host_stream: [(buf_bytes, spans)]
        # precompute mode: engine-wide FLAT profile arrays + per-bin
        # geometry (see _search_bin_flat_impl).  Any device op whose shape
        # depends on the bin recompiles per bin, which made setup
        # compile-bound, so all per-bin layout work happens host-side in
        # numpy and the
        # device sees ONE transfer + ONE gather (+ one for tail chunks).
        self.prof_flat = None           # int8[Ctot, 24, POS, 128]
        # trailing sub-128 chunks, one flat profile array PER TAIL WIDTH
        # (the 32-residue bin quantum leaves tails of 32/64/96 positions;
        # bins of equal tail width share one array + offsets)
        self.tail_flats = {}            # w -> int8[Tw, 24, w*8, 128]
        self.bin_geom = {}              # L -> (off, C, G_pad, toff|None, tw)
        flat_parts = []
        tail_parts = {}                 # w -> [np arrays]
        toff_n = {}                     # w -> next offset
        coff = 0
        ids_flat = []
        t_setup = time.perf_counter()
        if self.mode == "host_stream":
            ids_flat = self._init_host_stream()
        for L in (() if self.mode == "host_stream" else db.bin_lengths):
            seq_np = np.asarray(db.bins[L]["seq"])
            ids_np = np.asarray(db.bins[L]["id"])
            G = seq_np.shape[0]
            G_pad = -(-G // gb) * gb
            if G_pad != G:
                seq_np = np.concatenate(
                    [seq_np, np.full((G_pad - G, L, SUBLANES, LANES),
                                     DUMMY, np.int8)])
                ids_np = np.concatenate(
                    [ids_np, np.full((G_pad - G, SUBLANES, LANES), -1,
                                     np.int32)])
            ids_flat.append(ids_np.reshape(-1))
            C = L // CHUNK_WIDTH
            main_np = seq_np[:, :C * CHUNK_WIDTH].reshape(
                G_pad, C, CHUNK_WIDTH, SUBLANES, LANES)
            tail_np = seq_np[:, C * CHUNK_WIDTH:] if L % CHUNK_WIDTH \
                else None
            if self.mode == "precompute":
                if C:
                    flat_parts.append(np.ascontiguousarray(
                        main_np.transpose(1, 0, 2, 3, 4)).reshape(
                            C * G_pad, CHUNK_WIDTH, SUBLANES, LANES))
                toff = tw = None
                if tail_np is not None:
                    tw = L % CHUNK_WIDTH
                    tail_parts.setdefault(tw, []).append(tail_np)
                    toff = toff_n.get(tw, 0)
                    toff_n[tw] = toff + G_pad
                self.bin_geom[L] = (coff, C, G_pad, toff, tw)
                coff += C * G_pad
            else:                       # "stream" (config validates the set)
                main_dev = jnp.asarray(np.ascontiguousarray(
                    np.swapaxes(main_np, 0, 1)))     # [C, G, W, 8, 128]
                tail_dev = jnp.asarray(tail_np) if tail_np is not None \
                    else None
                self.seq_stacks[L] = (main_dev, tail_dev)
        if self.mode == "precompute":
            POS = CHUNK_WIDTH * SUBLANES
            if flat_parts:
                self.prof_flat = _build_profile_jit(
                    jnp.asarray(np.concatenate(flat_parts)), self.submat)
            else:
                self.prof_flat = jnp.zeros((0, 24, POS, LANES), jnp.int8)
            for w, parts in tail_parts.items():
                self.tail_flats[w] = _build_profile_jit(
                    jnp.asarray(np.concatenate(parts)), self.submat)
        self.submat_dev = jnp.asarray(self.submat)

        # slot -> sorted-sequence-id map in slot order (bins ascending);
        # -1 marks padding slots (excluded from top-k)
        self.ids_flat = np.concatenate(ids_flat) if ids_flat else \
            np.zeros((0,), np.int32)
        self.valid = jnp.asarray(self.ids_flat >= 0)
        self.n_slots = int(self.valid.shape[0])
        # significance-fit state: per-slot ln(subject length) (0 on padding
        # slots), the static ln-length moments, and the length histogram
        # for the E-value integral (oswald_tpu.stats)
        lnl_by_id, self._lnl_mom, self._len_hist = _db_len_stats(db)
        self._lnl_by_id = lnl_by_id
        self.lnl_flat = np.where(
            self.ids_flat >= 0,
            lnl_by_id[np.maximum(self.ids_flat, 0)] if len(lnl_by_id)
            else 0.0, 0.0).astype(np.float32)
        self.lnl = jnp.asarray(self.lnl_flat)
        self.metrics.add("engine_setup", time.perf_counter() - t_setup)

    def _init_host_stream(self):
        """Cut the WHOLE database into coalesced transfer slices.

        A slice is ONE flat int8 transfer buffer of up to
        host_stream_slice_mb MiB holding whole groups from one or more
        bins — cross-bin coalescing: per-BIN slices (rounds 2-4) became
        small once the 32-residue quantum produced ~17 thin bins, and
        their per-transfer overhead rivalled the compute they overlap;
        the reference's fixed-size chunks likewise ignore group
        boundaries (/root/reference/host/src/FPGAsearch.c:180-237,
        sequences.c:505-541).  Each slice holds SPANS — (L, Gs, byte_off,
        src_lo, take) group windows of one bin — whose compute programs
        dynamic-slice their window out of the transferred buffer (traced
        offset: spans sharing (Gs, L) share one compiled program).  Full
        slices all pad to ONE static buffer size (the budget) and the
        final partial slice to an adaptive-eighth rung, so the distinct
        compiled buffer shapes stay ~2.  Returns the per-span id rows for
        ids_flat (slot order matches the span score layout)."""
        gb = self.config.group_block
        lanes = SUBLANES * LANES
        conf = self.config.host_stream_slice_mb << 20
        total = sum(int(self.db.bins[L]["seq"].shape[0]) * L * lanes
                    for L in self.db.bin_lengths)
        # adaptive budget: aim for >= ~8 slices so the double buffer has
        # something to overlap (a database smaller than the configured
        # budget would otherwise coalesce into ONE slice — no pipeline),
        # floored at 16 MiB so per-transfer overhead stays amortised; an
        # explicitly smaller configured budget is always honored
        budget = min(conf, max(-(-total // 8), 1))
        budget = max(budget, min(conf, 16 << 20))
        slices, cur, cur_bytes = [], [], 0
        ids_out = []

        def close(final=False):
            nonlocal cur, cur_bytes
            if not cur:
                return
            if final:
                # adaptive-eighth rung bounds distinct final-slice shapes
                rung = max(1, (1 << max(cur_bytes.bit_length() - 1, 0))
                           // 8)
                size = -(-cur_bytes // rung) * rung
            else:
                size = max(budget, cur_bytes)
            slices.append((size, cur))
            cur, cur_bytes = [], 0

        for L in self.db.bin_lengths:
            seq_np = self.db.bins[L]["seq"]       # keep mmap, no asarray
            ids_np = np.asarray(self.db.bins[L]["id"])
            G = seq_np.shape[0]
            per_group = L * lanes
            lo = 0
            while lo < G:
                room = (budget - cur_bytes) // per_group // gb * gb
                if room < gb:
                    if cur:
                        close()
                        continue
                    room = gb          # groups bigger than the budget:
                                       # a one-span oversized slice
                take = min(room, G - lo)
                Gs = -(-take // gb) * gb
                cur.append((L, Gs, cur_bytes, lo, take))
                cur_bytes += Gs * per_group
                ids_s = ids_np[lo:lo + take].reshape(-1)
                if Gs != take:
                    ids_s = np.concatenate(
                        [ids_s, np.full((Gs - take) * lanes, -1, np.int32)])
                ids_out.append(ids_s)
                lo += take
        close(final=True)
        self._hs_slices = slices
        return ids_out

    def _hs_assemble(self, buf_bytes: int, spans):
        """Enqueue one coalesced slice's host->device transfer (a single
        flat int8 array).  A whole-bin single-span slice with no group
        padding transfers the mmap view directly (zero host copy); mixed
        slices assemble their spans into one buffer — DUMMY-filling only
        the padded-group extents (gap/tail bytes are never read by any
        span program)."""
        lanes = SUBLANES * LANES
        if len(spans) == 1:
            L, Gs, off, lo, take = spans[0]
            if Gs == take and buf_bytes == Gs * L * lanes:
                return jax.device_put(np.asarray(
                    self.db.bins[L]["seq"][lo:lo + take]).reshape(-1))
        buf = np.empty(buf_bytes, np.int8)
        for L, Gs, off, lo, take in spans:
            pg = L * lanes
            buf[off:off + take * pg] = np.asarray(
                self.db.bins[L]["seq"][lo:lo + take]).reshape(-1)
            if Gs != take:
                buf[off + take * pg:off + Gs * pg] = DUMMY
        return jax.device_put(buf)

    def _host_stream_scores_multi(self, classes):
        """One streaming sweep of the database for SEVERAL query classes
        at once: every slice is transferred ONCE and scanned by each
        class's programs (the batched path used to sweep the whole
        database once per padded-length class), double-buffered — slice
        i+1's transfer is enqueued before slice i's compute dispatch, and
        the host blocks only on slice i-1's score readbacks, so at most
        two slices plus the scan state live in HBM at any time.  classes:
        [(q_batch [Q, m_pad], nbs | None)]; returns one int32[Q, n_slots]
        per class."""
        cfg = self.config
        cls = [(jnp.asarray(qb),
                None if nbs is None else jnp.asarray(nbs, jnp.int32))
               for qb, nbs in classes]
        outs = [[] for _ in cls]

        def dispatch(dev, spans):
            res = []
            for ci, (qb, nbs) in enumerate(cls):
                for L, Gs, off, lo, take in spans:
                    s = _search_bin_hostflat(
                        qb, self.gaps, self.submat_dev, dev,
                        jnp.asarray(off, jnp.int32), Gs=Gs, L=L,
                        u_rows=cfg.u_rows, interpret=self._interpret,
                        group_block=cfg.group_block, acc_dtype=self._acc,
                        col_unroll=cfg.col_unroll, noadj=self._noadj,
                        nbs=nbs)
                    res.append((ci, s))
            return res

        def drain(res):
            for ci, s in res:
                outs[ci].append(np.asarray(s).reshape(s.shape[0], -1))

        slices = self._hs_slices
        if not cfg.host_stream_overlap:
            # forced-serial A/B reference: block on each transfer, then
            # on each compute, before touching the next slice — no
            # link/kernel overlap.  Results are identical; only the
            # schedule differs.
            for nbytes, spans in slices:
                dev = self._hs_assemble(nbytes, spans)
                jax.block_until_ready(dev)
                drain(dispatch(dev, spans))
        else:
            pending = None
            dev = self._hs_assemble(*slices[0]) if slices else None
            for i, (nbytes, spans) in enumerate(slices):
                nxt = self._hs_assemble(*slices[i + 1]) \
                    if i + 1 < len(slices) else None
                res = dispatch(dev, spans)
                if pending is not None:
                    # blocking readback of slice i-1's scores: the
                    # backpressure that bounds in-flight slices (and
                    # frees their HBM)
                    drain(pending)
                pending = res
                dev = nxt
            if pending is not None:
                drain(pending)
        return [np.concatenate(o, axis=1) if o else
                np.zeros((int(qb.shape[0]), 0), np.int32)
                for o, (qb, _) in zip(outs, cls)]

    def _host_stream_scores(self, q_batch, nbs=None) -> np.ndarray:
        """int32[Q, n_slots] scores with the database streamed
        host->device in coalesced slices (see _host_stream_scores_multi;
        the reference's analog is its per-chunk clEnqueueWriteBuffer
        round, FPGAsearch.c:180-237)."""
        return self._host_stream_scores_multi([(q_batch, nbs)])[0]

    def _pad_query(self, query):
        return pad_query(query, self.config)

    def _search_fn(self, k: int):
        """One jitted program for a whole search: every bin's scan plus the
        masked top-k, in a single dispatch.  The program is module-level
        and keyed by static geometry, so engines over the same database
        in one process (CLI, server, tests) share its compilation."""
        if self.mode == "precompute":
            geom = tuple((L, self.bin_geom[L]) for L in self.db.bin_lengths)
        else:
            geom = tuple((L, None) for L in self.db.bin_lengths)
        return functools.partial(
            _fused_search, k=k, geom=geom,
            u_rows=self.config.u_rows, interpret=self._interpret,
            group_block=self.config.group_block, acc_dtype=self._acc,
            col_unroll=self.config.col_unroll, noadj=self._noadj)

    def score_all(self, query) -> jnp.ndarray:
        """Scores for every database sequence, in sorted-id slot order."""
        q_pad = jnp.asarray(self._pad_query(query))
        nb = nb_or_none(np.asarray(query).size, q_pad.shape[0],
                        self.config.u_rows)
        if self.mode == "host_stream":
            return jnp.asarray(self._host_stream_scores(
                q_pad[None], None if nb is None else nb[None])[0])
        outs = []
        for L in self.db.bin_lengths:
            if self.mode == "precompute":
                off, C, G, toff, tw = self.bin_geom[L]
                s = _search_bin_flat(q_pad, self.gaps, self.prof_flat,
                                     self.tail_flats[tw] if toff is not None
                                     else None, off, C=C, G=G, toff=toff,
                                     u_rows=self.config.u_rows,
                                     interpret=self._interpret,
                                     group_block=self.config.group_block,
                                     acc_dtype=self._acc,
                                     col_unroll=self.config.col_unroll,
                                     noadj=self._noadj, nb=nb)
            else:
                main, tail = self.seq_stacks[L]
                s = _search_bin_stream(q_pad, self.gaps, self.submat_dev,
                                       main, self.config.u_rows,
                                       self._interpret,
                                       self.config.group_block, self._acc,
                                       tail, self.config.col_unroll,
                                       noadj=self._noadj, nb=nb)
            outs.append(s.reshape(-1))
        return jnp.concatenate(outs) if outs else jnp.zeros((0,), jnp.int32)

    def _dispatch(self, query, query_title: str):
        """Enqueue one query's full search on the device WITHOUT blocking;
        returns an opaque pending tuple for _finish.  host_stream mode has
        its own internal transfer pipeline and completes synchronously."""
        t0 = time.perf_counter()
        k = min(self.config.top, self.db.n_seqs)
        if self.mode == "host_stream":
            q_pad_hs = self._pad_query(query)
            nb1 = nb_or_none(np.asarray(query).size, q_pad_hs.shape[0],
                             self.config.u_rows)
            scores = self._host_stream_scores(
                jnp.asarray(q_pad_hs)[None],
                None if nb1 is None else nb1[None])[0]
            top_scores, top_slots = _host_topk(scores, self.ids_flat, k)
            mom = _host_moments(scores, self.ids_flat >= 0, self.lnl_flat,
                                top_scores)
            done = (top_scores, top_slots, mom)
            return (query, query_title, t0, None, done)
        q_pad_np = self._pad_query(query)
        fused = self.config.fused_dispatch
        if fused is None:           # auto: see SearchConfig.fused_dispatch
            fused = self.mode == "precompute" and not self._interpret
        if fused:
            q_pad = jnp.asarray(q_pad_np)
            nb = nb_or_none(np.asarray(query).size, q_pad_np.shape[0],
                            self.config.u_rows)
            stacks = (self.prof_flat, self.tail_flats) if \
                self.mode == "precompute" else self.seq_stacks
            packed = self._search_fn(k)(
                q_pad, nb, self.gaps, self.submat_dev, stacks, self.valid,
                self.lnl)
        else:
            scores = self.score_all(query)
            packed = _topk(scores, self.valid, self.lnl, k)
        return (query, query_title, t0, packed, None)

    def _finish(self, pend) -> SearchResult:
        """Block on a _dispatch's packed readback and build the result."""
        query, query_title, t0, packed, done = pend
        if done is not None:
            top_scores, top_slots, mom = done
        else:
            packed = np.asarray(packed)      # the ONE blocking readback
            top_scores, top_slots, mom = _unpack_topk(packed)
        top_scores = np.asarray(top_scores)
        # slots -> sorted-sequence ids (slot order preserves id order, so
        # top_k's lowest-index tie-break is a lowest-id tie-break)
        top_ids = self.ids_flat[np.asarray(top_slots)]
        qlen = int(np.asarray(query).size)
        ev, bits, st = _result_stats(
            self.db, self._lnl_by_id, self._lnl_mom, self._len_hist,
            top_scores, top_ids, mom, qlen)
        elapsed = time.perf_counter() - t0
        self.metrics.add("search", elapsed)
        titles = [self.db.title_of(int(i)) for i in top_ids]
        return SearchResult(query_title=query_title, query_length=qlen,
                            scores=top_scores, seq_ids=top_ids,
                            titles=titles, elapsed=elapsed,
                            evalues=ev, bit_scores=bits, stats=st)

    def search(self, query, query_title: str = "query") -> SearchResult:
        return self._finish(self._dispatch(query, query_title))

    def search_stream(self, queries, titles=None):
        """Pipelined single-query stream: query i+1's programs dispatch
        BEFORE query i's (tiny) top-k readback blocks, so the device->host
        round trip overlaps the next query's compute.  This is the
        latency-hiding mode for sequential clients: each query still runs
        alone (no shared batch program).  The reference's analog is its
        async per-query kernel queue inside one chunk round
        (/root/reference/host/src/FPGAsearch.c:204-223: all queries
        enqueued, one clWaitForEvents).  Results are identical to
        [search(q) for q in queries].

        Readback windowing: grouping stream_readback_window consecutive
        queries' packed outputs into one device-side stack pays one
        readback round trip per window instead of per query."""
        titles = titles or [f"query{i}" for i in range(len(queries))]
        W = max(self.config.stream_readback_window, 1)
        results, prev = [], None
        for lo in range(0, len(queries), W):
            grp = [self._dispatch(q, t)
                   for q, t in zip(queries[lo:lo + W], titles[lo:lo + W])]
            packs = [p[3] for p in grp]
            stacked = _stack_packed(*packs) \
                if len(packs) > 1 and all(p is not None for p in packs) \
                else None
            if prev is not None:
                results.extend(self._finish_group(*prev))
            prev = (grp, stacked)
        if prev is not None:
            results.extend(self._finish_group(*prev))
        return results

    def _finish_group(self, grp, stacked):
        """Finish one readback window: one blocking transfer for the
        whole stack, then per-query result builds from each query's own
        packed rows (identical results to per-query readbacks)."""
        if stacked is None:
            return [self._finish(p) for p in grp]
        big = np.asarray(stacked)               # the ONE window readback
        return [self._finish((q, t, t0, big[i], done))
                for i, (q, t, t0, _, done) in enumerate(grp)]

    def warmup(self, max_query_len: int = 512, batch: bool = True,
               log=None, jobs: int = 1):
        """Precompile every (bin, padded-query-shape) program for queries up
        to max_query_len, in both kernel variants plus the common pack
        rungs (see warmup_engine) — a serving deployment calls this once
        so the first real query doesn't pay XLA compilation.  jobs
        parallelises the steps (compiles/loads overlap).  Returns the
        list of padded lengths compiled."""
        return warmup_engine(self, max_query_len, batch, log, jobs=jobs)

    def align(self, query, result: SearchResult):
        """Gapped alignments (traceback) for a SearchResult's hits — a
        host-side post-pass over the k reported sequences only (see
        engine/align.py).  Returns [align.Alignment]."""
        from oswald_tpu.engine.align import align_hits
        return align_hits(self.db, query, result, self.submat,
                          self.config.open_gap, self.config.extend_gap)

    def search_many(self, queries, titles=None, batch: bool = True):
        """Search a list of queries.  With batch=True (default) queries are
        grouped by padded length and each group runs as ONE compiled
        program per bin (amortising dispatch + profile residency); the
        reference's analog is its per-query kernel loop inside one chunk
        round (FPGAsearch.c:204-219)."""
        titles = titles or [f"query{i}" for i in range(len(queries))]
        # fail fast on over-cap queries BEFORE any device work (the packed
        # path bypasses pad_query's guard)
        cap = self.config.max_query_len
        for i, q in enumerate(queries):
            if np.asarray(q).size > cap:
                raise ValueError(
                    f"query {i} length {np.asarray(q).size} exceeds the "
                    f"engine's configured max_query_len {cap} — rebuild "
                    f"with SearchConfig(max_query_len=...) / "
                    f"--max-query-len")
        if not batch or len(queries) <= 1:
            # unbatched = pipelined single-query stream: identical results
            # to a sequential loop, with each readback hidden under the
            # next query's compute (see search_stream)
            return self.search_stream(queries, titles)

        t0 = time.perf_counter()
        results = [None] * len(queries)
        k = min(self.config.top, self.db.n_seqs)
        # two phases: dispatch EVERY group's programs before blocking on
        # any readback, so group j+1's device work (and its host-side
        # profile scheduling) overlaps group j's compute
        pending = []

        # mixed-length packed bins: whole queries (any lengths) as row
        # segments of one kernel program per bin (sw_chunk seg_map), so a
        # mixed batch reads each profile block once for the whole bin
        S = MIXED_PACK_SEGS
        if self.mode in ("precompute", "stream"):
            bins, rest = mixed_pack_plan(
                self.config.batch_query_pack_rows, self.config.u_rows,
                queries)
        else:
            bins, rest = [], list(range(len(queries)))
        for sub, qp_np, sm_np, used in bins:
            q_packed = jnp.asarray(qp_np)
            seg_map = jnp.asarray(sm_np)
            nb = None if used == sm_np.shape[0] else \
                jnp.asarray(used, jnp.int32)
            outs = []
            for L in self.db.bin_lengths:
                if self.mode == "stream":
                    main, tail = self.seq_stacks[L]
                    s = _search_bin_stream_pack(
                        q_packed, self.gaps, self.submat_dev,
                        main, q_segs=S,
                        u_rows=self.config.u_rows,
                        interpret=self._interpret,
                        group_block=self.config.group_block,
                        acc_dtype=self._acc, seq_tail=tail,
                        col_unroll=self.config.col_unroll,
                        noadj=self._noadj, seg_map=seg_map, nb=nb)
                else:
                    off, C, G, toff, tw = self.bin_geom[L]
                    s = _search_bin_flat_pack(
                        q_packed, self.gaps, self.prof_flat,
                        self.tail_flats[tw] if toff is not None
                        else None,
                        off, C=C, G=G, toff=toff, q_segs=S,
                        u_rows=self.config.u_rows,
                        interpret=self._interpret,
                        group_block=self.config.group_block,
                        acc_dtype=self._acc,
                        col_unroll=self.config.col_unroll,
                        noadj=self._noadj, seg_map=seg_map, nb=nb)
                outs.append(s.reshape(S, -1))
            # top-k over a pow2 slot count (not all S): unused slots are
            # uninitialised, and the pow2 ladder bounds compile count
            n2 = 1 << (len(sub) - 1).bit_length()
            packed = jax.vmap(
                lambda sc: _topk(sc, self.valid, self.lnl, k))(
                    jnp.concatenate(outs, axis=1)[:n2])[:len(sub)]
            pending.append((sub, packed, None, None, None))

        # unpacked leftovers (longer than the pack-row budget): batched
        # per padded-length class
        padded = {i: pad_query(queries[i], self.config, for_batch=True)
                  for i in rest}
        by_len = {}
        for i in rest:
            by_len.setdefault(padded[i].shape[0], []).append(i)
        u = self.config.u_rows
        class_args = {}
        for m_pad, idxs in by_len.items():
            qb = jnp.asarray(np.stack([padded[i] for i in idxs]))
            nb_l = [nb_of(np.asarray(queries[i]).size, u) for i in idxs]
            nbs = None if all(b * u >= m_pad for b in nb_l) else \
                jnp.asarray(nb_l, jnp.int32)
            class_args[m_pad] = (qb, nbs)
        hs_flats = {}
        if self.mode == "host_stream" and class_args:
            # ONE streaming sweep of the database scores EVERY padded-
            # length class (each transferred slice is scanned by every
            # class's programs before the next slice replaces it) —
            # sweeping once per class re-paid the whole transfer cost
            # per class
            keys = sorted(class_args)
            flats = self._host_stream_scores_multi(
                [class_args[m] for m in keys])
            hs_flats = dict(zip(keys, flats))
        for m_pad, idxs in by_len.items():
            qb, nbs = class_args[m_pad]
            if self.mode == "host_stream":
                flat_np = hs_flats[m_pad]
                packed = None
                top_scores = np.empty((len(idxs), k), np.int32)
                top_slots = np.empty((len(idxs), k), np.int64)
                for row in range(len(idxs)):
                    top_scores[row], top_slots[row] = _host_topk(
                        flat_np[row], self.ids_flat, k)
                mom = _host_moments(flat_np, self.ids_flat >= 0,
                                    self.lnl_flat, top_scores)
            else:
                outs = []
                for L in self.db.bin_lengths:
                    if self.mode == "stream":
                        main, tail = self.seq_stacks[L]
                        s = _search_bin_stream_batch(
                            qb, self.gaps, self.submat_dev, main,
                            u_rows=self.config.u_rows,
                            interpret=self._interpret,
                            group_block=self.config.group_block,
                            acc_dtype=self._acc, seq_tail=tail,
                            col_unroll=self.config.col_unroll,
                            noadj=self._noadj, nbs=nbs)
                    else:
                        off, C, G, toff, tw = self.bin_geom[L]
                        s = _search_bin_flat_batch(
                            qb, self.gaps, self.prof_flat,
                            self.tail_flats[tw] if toff is not None
                            else None,
                            off, C=C, G=G, toff=toff,
                            u_rows=self.config.u_rows,
                            interpret=self._interpret,
                            group_block=self.config.group_block,
                            acc_dtype=self._acc,
                            col_unroll=self.config.col_unroll,
                            noadj=self._noadj, nbs=nbs)
                    outs.append(s.reshape(len(idxs), -1))
                packed = jax.vmap(
                    lambda sc: _topk(sc, self.valid, self.lnl, k))(
                        jnp.concatenate(outs, axis=1))      # [Q, 2, k+2]
                top_scores = top_slots = mom = None
            pending.append((idxs, packed, top_scores, top_slots, mom))

        for idxs, packed, top_scores, top_slots, mom in pending:
            if top_scores is None:
                # one packed readback per group (scores+slots+moments,
                # a single transfer — see _topk)
                top_scores, top_slots, mom = _unpack_topk(
                    np.asarray(packed))
            for row, i in enumerate(idxs):
                ids = self.ids_flat[top_slots[row]]
                qlen = int(np.asarray(queries[i]).size)
                ev, bits, st = _result_stats(
                    self.db, self._lnl_by_id, self._lnl_mom, self._len_hist,
                    top_scores[row], ids,
                    tuple(m[row] for m in mom), qlen)
                results[i] = SearchResult(
                    query_title=titles[i], query_length=qlen,
                    scores=top_scores[row], seq_ids=ids,
                    titles=[self.db.title_of(int(j)) for j in ids],
                    elapsed=0.0, evalues=ev, bit_scores=bits, stats=st)
        elapsed = time.perf_counter() - t0
        self.metrics.add("search_batch", elapsed)
        # honest timing: every result carries the batch's REAL wall time
        # plus batch_n — a per-query average would be fiction (queries
        # shared device programs; no per-query split exists)
        for r in results:
            r.elapsed = elapsed
            r.batch_n = len(queries)
        return results
