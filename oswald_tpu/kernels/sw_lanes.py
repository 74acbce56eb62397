"""Inter-sequence Smith-Waterman kernel (the hot path), Pallas on Triton.

The reference's scoring engines (the FPGA char16 pipeline,
/root/reference/device/sw.cl:16-94, and the SSE/AVX2 inter-sequence
kernels, /root/reference/host/src/HybridSearch.c:236-612) run many database
sequences side by side, one per SIMD lane.  Here one GPU thread owns one
database sequence:

- **One thread per subject.**  A packed group is an [8, 128] grid of 1024
  subjects ("lanes"); at one residue position the group's 1024 lanes are
  contiguous bytes, so a program that owns a [GB, SB, 128] block of lanes
  (GB groups x SB sublanes x 128 lanes) issues coalesced loads.  Each
  thread advances its GB*SB lanes in lockstep (independent dependency
  chains, for instruction-level parallelism).
- **Exact 32-bit arithmetic** (int32, or float32 which is exact for SW
  scores far below 2^24).  The reference's int8/int16 saturating fast
  paths rescue every saturated lane with an exact 32-bit recompute, so
  their semantics are exact 32-bit scores; computing those directly drops
  the overflow-detect/recompute ladder.
- **Register blocking over U query rows.**  Per column j a thread keeps
  H/E of U consecutive query rows in registers and loads/stores the
  H-row and F-column state once per column instead of once per cell (the
  analog of the reference's `#pragma unroll 10`).
- **Row blocks as a loop inside the program.**  GPU programs carry no
  state from one grid step to the next, so a program sweeps all of its
  row blocks itself: a `fori_loop` whose trip count is the traced
  `n_blocks` (the dummy-row skip is a shorter loop).  The H-row/F-column
  state between row blocks lives in a per-program slice of a scratch
  buffer in device memory, which L1/L2 hold.
- **Column chunks with carried boundary state.**  The DP matrix is swept
  in column chunks of CHUNK_WIDTH db positions; H/E at a chunk's last
  column go to device memory and feed the next chunk's call, the
  functional equivalent of the FPGA kernel's depth-5478 `lastCols`/
  `maxRows` channels (sw.cl:9-10,48-54,79-85).
- **Score profile instead of per-cell lookup.**  s(a_i, b_j) for a whole
  chunk is a precomputed [24, POS, 128] int8 table indexed by query
  residue (the reference's SSSE3 profile-gather, HybridSearch.c:141-173).

The route is Pallas with `backend="triton"`: the recurrence is add/max on
32-bit registers with no matrix product, so the tensor-core machinery of
Mosaic GPU buys nothing.  On the CPU the same kernel runs in Pallas
interpret mode (the tests).
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from oswald_tpu.io.db import SUBLANES, LANES

CHUNK_WIDTH = 128                 # db positions per chunk
POS_PER_CHUNK = CHUNK_WIDTH * SUBLANES   # flattened (j, sublane) rows
DEFAULT_U_ROWS = 8
# Columns per loop iteration.  Owned by SearchConfig.col_unroll; this is
# only the default.  On the H100 (bin G=44, m=512, one 128-column chunk)
# unrolling slowed the kernel (1: 372, 4: 108-131, 8: 91-125, 16: 85-125
# Gcells/s) and its Triton compile grew from ~1 s to ~60 s at 16.
DEFAULT_COL_UNROLL = 1
# Sublanes of a group per program.  Compiled: 1 gives the most programs
# per launch (G/group_block * 8), which thin bins need to fill the card's
# SMs.  Interpreted: the whole group, ~5x fewer interpreter steps.  Lanes
# are independent, so the launch geometry never changes a score.
COMPILED_SUBLANE_BLOCK = 1
INTERPRET_SUBLANE_BLOCK = SUBLANES
NUM_WARPS = 4


def kernel_interpret(platform: str | None = None) -> bool:
    """The platform seam: how `sw_chunk` runs on this platform (default:
    the first JAX device's).  "cpu": Pallas interpret mode (the tests);
    "gpu": the kernel compiled through Triton.  Any other platform has no
    kernel, and says so instead of silently interpreting."""
    if platform is None:
        platform = jax.devices()[0].platform
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(
        f"no Smith-Waterman kernel for platform {platform!r}: the kernel "
        f"is compiled for NVIDIA GPUs and interpreted on the CPU")


def build_profile(db_chunk, submat):
    """Score profile for one column chunk.

    db_chunk: int8[G, W, 8, 128] packed residues (codes 0..23)
    submat:   int8/int32 [24, 24]
    returns:  int8[G, 24, W*8, 128] with prof[g, c, j*8+s, l] =
              submat[c, db[g, j, s, l]]

    One XLA gather from the 24 x 24 table, exact in int8.
    """
    G, W = db_chunk.shape[:2]
    sm = jnp.asarray(submat, jnp.int8)
    flat = db_chunk.reshape(G, 1, W * SUBLANES, LANES).astype(jnp.int32)
    return jnp.take(sm, jnp.arange(sm.shape[0], dtype=jnp.int32)
                    [None, :, None, None] * sm.shape[1] + flat)


def noadj_ok(submat, extend_gap: int) -> bool:
    """True: the `noadj` E-update is exact for EVERY scoring config.

    The relaxed update opens E from the F-independent candidate `cur'`
    instead of `cur = max(cur', F)` (see _kernel), dropping only paths
    where a query-gap run (E) opens directly from a subject-gap value
    (an F->E corner).  That is never uniquely optimal: between two
    anchors (diagonal steps or the 0 start) a path segment is a sequence
    of maximal gap runs whose cost — one open plus len*extend per run —
    does not depend on run ORDER, so reorder the segment E-runs-first
    (merging adjacent same-type runs, which only removes opens).  The
    reordered path consumes the same spans at <= the cost, its E-runs
    open from anchors (contained in cur'), and its F-runs open from
    max(cur', E) which the relaxed recurrence keeps (F opens from cur',
    and cur' includes E).  Hence every optimal score survives.

    Verified adversarially by machine, not just prose: (1)
    scripts/noadj_fuzz.py — 4000 random configs (random [24,24] matrices
    incl. positive-heavy and ±30-range, og/eg in {0..100} incl. both 0)
    through scalar implementations of BOTH recurrences, zero mismatches;
    (2) tests/test_adversarial.py — the ACTUAL kernel with random
    matrices, og=0/eg=0, noadj on/off A/B vs the classical oracle, in CI;
    (3) tests/test_engine.py — 4000 random pairs on pam30 2/1 (where the
    retired conservative gate `min(submat) + 2*extend >= 0` claimed
    inexactness) plus six gate-excluded configs over multi-chunk
    databases.  The function is kept (always True) so the classical
    branch remains reachable for A/B verification.
    """
    return True


def _kernel(U, GB, SB, acc_dtype, col_unroll, noadj, bps, has_nb, has_seg,
            q_ref, gaps_ref, *refs):
    # bps is None in the DYNAMIC segment layout (unequal packed-query
    # lengths): row block r belongs to score slot seg_ref[r].  bps set =
    # the static uniform layout (every segment bps row blocks).
    refs = list(refs)
    nb_ref = refs.pop(0) if has_nb else None
    seg_ref = refs.pop(0) if has_seg else None
    (prof_ref, colh_ref, colhd_ref, cole_ref, sin_ref, scores_ref,
     colho_ref, coleo_ref, state_ref) = refs
    # each ref is this program's GB-group block (see sw_chunk's specs)
    gi = pl.ds(0, GB)
    s0 = pl.program_id(1) * SB
    si = pl.ds(s0, SB)
    W = prof_ref.shape[2] // SUBLANES
    R = colhd_ref.shape[1]
    S = sin_ref.shape[1]
    eg = gaps_ref[1].astype(acc_dtype)
    oeg = (gaps_ref[0] + gaps_ref[1]).astype(acc_dtype)
    zero = jnp.zeros((GB, SB, LANES), acc_dtype)

    # every score slot starts as its input, so slots that no row block
    # visits (unused packed segments) pass through unchanged
    for t in range(S):
        scores_ref[gi, t, si, :] = sin_ref[gi, t, si, :]

    def zero_state(j, c):
        p = pl.ds(j * SUBLANES + s0, SB)
        state_ref[gi, 0, p, :] = zero
        state_ref[gi, 1, p, :] = zero
        return c

    def row_block(r, score):
        if seg_ref is None:
            # lax.div/rem: r >= 0, and jnp's floor-division lowers to a
            # sign fix-up Triton's lowering rejects
            seg = jax.lax.div(r, bps)
            start = jax.lax.rem(r, bps) == 0
        else:
            seg = seg_ref[r]
            start = jnp.logical_or(
                r == 0, seg != seg_ref[jnp.maximum(r - 1, 0)])

        # first row block of a segment (a packed query): H[-1, :] = 0, F
        # candidates = 0 (0 is equivalent to -inf here because H = max(0,
        # ...) >= 0 and gap candidates only decay; same initialisation as
        # sw.cl:39).  Zeroing at every segment start is what makes packed
        # segments independent queries: no DP state crosses the boundary.
        @pl.when(start)
        def _init():
            jax.lax.fori_loop(0, W, zero_state, 0)

        score = jnp.where(start, sin_ref[gi, seg, si, :], score)
        i0 = r * U
        a = [q_ref[i0 + u] for u in range(U)]
        # chunk-boundary state from the previous chunk (zeros for chunk 0):
        #   hl[u]  = H[i0+u, -1]   (colH)
        #   hprev  = H[i0-1, -1]   (colHd: colH shifted down one row)
        #   e[u]   = E[i0+u, 0] candidate (colE)
        e0 = tuple(cole_ref[gi, i0 + u, si, :] for u in range(U))
        hl0 = tuple(colh_ref[gi, i0 + u, si, :] for u in range(U))
        carry0 = (colhd_ref[gi, r, si, :], score, e0, hl0)

        # Column body.  Since extend <= open+extend,
        #   max(f - eg, max(cur', f) - oeg)  ==  max(f - eg, cur' - oeg)
        # where cur' = max(diag + s, 0, e) is the F-INDEPENDENT part of the
        # cell, so a column decomposes into
        #   (1) cur'[u] for all U rows             — independent
        #   (2) f[u+1] = max(f[u]-eg, cur'[u]-oeg)  — 2-op/row serial scan
        #   (3) cur = max(cur', f); E/smax/H        — independent
        # cutting the critical path per column to ~2 ops/row.
        def one_col(j, carry):
            hprev, smax, e, hl = carry
            p = pl.ds(j * SUBLANES + s0, SB)
            hrow_j = state_ref[gi, 0, p, :]
            f_in = state_ref[gi, 1, p, :]
            # diag[u] = H[i0+u-1, j-1]: hprev for u=0, prev column's hl
            diag = (hprev,) + hl[:U - 1]
            s = [prof_ref[gi, a[u], p, :].astype(acc_dtype)
                 for u in range(U)]
            curp = [jnp.maximum(jnp.maximum(diag[u] + s[u], 0), e[u])
                    for u in range(U)]
            c = [curp[u] - oeg for u in range(U)]
            f = [f_in]
            for u in range(1, U):
                f.append(jnp.maximum(f[u - 1] - eg, c[u - 1]))
            cur = [jnp.maximum(curp[u], f[u]) for u in range(U)]
            if noadj:
                # E opens from cur' (reusing c = cur' - oeg): drops F->E
                # gap corners, which always have an equal-cost E->F twin —
                # exact for every scoring config (proof in noadj_ok); one
                # subtract per cell fewer.  The classical branch is kept
                # as the reference recurrence for A/B verification.
                e = tuple(jnp.maximum(e[u] - eg, c[u]) for u in range(U))
            else:
                e = tuple(jnp.maximum(e[u] - eg, cur[u] - oeg)
                          for u in range(U))
            # smax over cur' (not cur) is exact unconditionally: every f
            # value is max(earlier c[v] - k*eg) or a chunk-carried f_in
            # with the same provenance, so each f is dominated by an
            # earlier cur' in the same column (and f_in=0 <= any 0-clamped
            # cur'), hence max over cur == max over cur'.  This breaks
            # smax's dependence on the serial F scan.
            for u in range(U):
                smax = jnp.maximum(smax, curp[u])
            state_ref[gi, 0, p, :] = cur[U - 1]
            state_ref[gi, 1, p, :] = jnp.maximum(f[U - 1] - eg, c[U - 1])
            return hrow_j, smax, e, tuple(cur)

        def cols(jj, carry):
            for k in range(col_unroll):
                carry = one_col(jj * col_unroll + k, carry)
            return carry

        _, score, e, hl = jax.lax.fori_loop(0, W // col_unroll, cols,
                                            carry0)
        for u in range(U):
            colho_ref[gi, i0 + u, si, :] = hl[u]
            coleo_ref[gi, i0 + u, si, :] = e[u]
        scores_ref[gi, seg, si, :] = score
        return score

    # Dummy-row-block skip: row blocks past the query's TRUE length (the
    # quantum padding) are score-inert — a dummy row's F-independent
    # candidate is max(diag, 0, e), every term of which is dominated by
    # an earlier real row's candidate in the same column, so smax cannot
    # move — and their carried state feeds only other dummy blocks.  The
    # trip count is a traced scalar, so ONE compiled (m_pad, ...) program
    # serves every true length in its pad class at true-length cost.
    # colH/colE rows past n_blocks*U are left unwritten; only skipped
    # blocks would ever read them.
    n = nb_ref[0] if has_nb else R
    jax.lax.fori_loop(0, n, row_block, zero)



@functools.partial(jax.jit,
                   static_argnames=("u_rows", "group_block", "acc_dtype",
                                    "interpret", "col_unroll", "noadj",
                                    "q_segs"))
def sw_chunk(q, gaps, prof_chunk, colH, colHd, colE, scores_in,
             u_rows: int = DEFAULT_U_ROWS, group_block: int = 1,
             acc_dtype=jnp.int32, interpret: bool = False,
             col_unroll: int = DEFAULT_COL_UNROLL, noadj: bool = False,
             q_segs: int = 1, seg_map=None, n_blocks=None):
    """Score one column chunk of the DP matrix for all groups.

    q:          int32[m_pad]               encoded query
    gaps:       int32[2]                    (open_gap, extend_gap)
    prof_chunk: int8[G, 24, POS, 128]       score profile (build_profile)
    colH:       acc[G, m_pad, 8, 128]       H at previous chunk's last column
    colHd:      acc[G, R, 8, 128]           per row block r, H[r*U - 1] of
                                            the previous chunk's last column
                                            (zeros for segment-start blocks)
    colE:       acc[G, m_pad, 8, 128]       E candidates at this chunk's col 0
    scores_in:  acc[G, 8, 128] (q_segs=1)   running per-lane max, or
                acc[G, q_segs, 8, 128]      one slab per packed segment

    q_segs: number of INDEPENDENT queries packed along the row axis (each
    an equal m_pad/q_segs-row segment).  The kernel re-initialises its
    H-row/F state and score slot at every segment start, so one launch
    scores q_segs queries while reading each profile block once — for
    short queries the profile stream dominates, so packing multiplies
    arithmetic intensity by q_segs (the batched analog of the reference's
    per-query kernel loop inside one chunk round, FPGAsearch.c:204-219,
    which likewise reuses the uploaded chunk).

    seg_map: optional int32[R] (R = m_pad/u_rows row blocks) giving each
    row block's score-slab slot — UNEQUAL segment lengths, so a mixed
    100-400aa query batch rides one program and one profile stream (the
    general form of the reference's arbitrary-m per-query loop).  Slots
    must be non-decreasing with block index, < q_segs, each slot's blocks
    contiguous; trailing filler blocks may extend the last segment with
    DUMMY rows (score-inert).  The map is a traced operand: every layout
    with the same (m_pad, q_segs) shares ONE compiled program.  None = the
    static uniform layout.  Slots no row block visits return scores_in.

    group_block: groups whose lanes one thread advances in lockstep
    (independent chains, for instruction-level parallelism); a power of
    two that divides G.  col_unroll: columns advanced per loop iteration;
    must divide the chunk's column count.  noadj: relaxed E-update that
    saves one op/cell — exact for every scoring config (see noadj_ok).

    n_blocks: optional TRACED row-block trip count (int32 scalar): row
    blocks >= n_blocks — the quantum padding's DUMMY rows — are skipped
    entirely (exact: dummy rows are score-inert, see _kernel), so one
    compiled (m_pad, ...) program serves every true query length in its
    pad class at true-length compute cost.  None = all blocks real.  The
    reference's analog: its kernel launches take m verbatim
    (FPGAsearch.c:204-219).  colH/colE rows of skipped blocks are
    undefined on return.
    Returns (scores, colH_out, colE_out); scores match scores_in's shape.
    """
    G, _, POS, _ = prof_chunk.shape
    m_pad = q.shape[0]
    W_cols = POS // SUBLANES
    if not (isinstance(col_unroll, int) and col_unroll >= 1 and
            W_cols % col_unroll == 0):
        # explicit raise (not assert): a bad value under `python -O` would
        # silently skip trailing columns and corrupt scores
        raise ValueError(
            f"col_unroll must be a positive divisor of the chunk column "
            f"count {W_cols}, got {col_unroll!r}")
    GB = group_block
    if m_pad % u_rows:
        raise ValueError(f"m_pad {m_pad} is not a multiple of u_rows "
                         f"{u_rows}")
    if GB < 1 or GB & (GB - 1) or G % GB:
        raise ValueError(f"group_block must be a power of two dividing the "
                         f"{G} groups, got {GB!r}")
    SB = INTERPRET_SUBLANE_BLOCK if interpret else COMPILED_SUBLANE_BLOCK
    R = m_pad // u_rows
    squeeze = scores_in.ndim == 3
    if squeeze:
        scores_in = scores_in[:, None]
    if scores_in.shape[1] != q_segs:
        raise ValueError(f"scores_in has {scores_in.shape[1]} slots, "
                         f"q_segs is {q_segs}")
    has_nb = n_blocks is not None
    ops = [jnp.asarray(q, jnp.int32), jnp.asarray(gaps, jnp.int32)]
    if has_nb:
        ops.append(jnp.asarray(n_blocks, jnp.int32).reshape(1))
    bps = None
    if seg_map is None:
        if R % q_segs:
            raise ValueError(
                f"q_segs={q_segs} must divide the {R} row blocks (m_pad "
                f"{m_pad}, u_rows {u_rows})")
        bps = R // q_segs                 # row blocks per segment
    else:
        seg_map = jnp.asarray(seg_map, jnp.int32)
        if seg_map.shape != (R,):
            raise ValueError(
                f"seg_map must have one slot per row block, expected "
                f"({R},), got {seg_map.shape}")
        ops.append(seg_map)

    # interpret mode executes the traced body op by op, so unrolling only
    # slows it down
    cu = 1 if interpret else col_unroll
    kernel = functools.partial(_kernel, u_rows, GB, SB, acc_dtype, cu,
                               noadj, bps, has_nb, seg_map is not None)
    cells = G * m_pad * POS * LANES
    acc = lambda shape: jax.ShapeDtypeStruct(shape, acc_dtype)
    # Per-program blocks of GB groups: the kernel's IR then never names G,
    # so every bin with the same (m_pad, POS, q_segs) compiles to the same
    # kernel.  Scalar operands are passed whole.
    whole = lambda x: pl.BlockSpec(x.shape, lambda g, s: (0,) * x.ndim)
    groups = lambda shape: pl.BlockSpec((GB,) + shape[1:],
                                        lambda g, s: (g, 0, 0, 0))
    operands = (prof_chunk, colH, colHd, colE, scores_in)
    out_shapes = [acc((G, q_segs, SUBLANES, LANES)),
                  acc((G, m_pad, SUBLANES, LANES)),
                  acc((G, m_pad, SUBLANES, LANES)),
                  # H-row / F-column state between row blocks, one slice
                  # per program: [g, 0|1, j*8 + s, lane]
                  acc((G, 2, POS, LANES))]
    scores, colH_out, colE_out, _ = pl.pallas_call(
        kernel,
        grid=(G // GB, SUBLANES // SB),
        in_specs=[whole(x) for x in ops] +
        [groups(x.shape) for x in operands],
        out_specs=[groups(o.shape) for o in out_shapes],
        out_shape=out_shapes,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        cost_estimate=pl.CostEstimate(
            flops=10 * cells, bytes_accessed=prof_chunk.size,
            transcendentals=0),
        interpret=interpret,
        name="sw_chunk",
    )(*ops, prof_chunk, colH, colHd, colE, scores_in)
    return (scores[:, 0] if squeeze else scores), colH_out, colE_out
