"""Reference Smith-Waterman scorers (the correctness oracle).

Score-only, affine-gap, local alignment with the reference recurrence
(/root/reference/device/sw.cl:44-86):

    H[i,j] = max(0, H[i-1,j-1] + S(a_i, b_j), E[i,j], F[i,j])
    E[i,j] = max(H[i,j-1] - (open+extend), E[i,j-1] - extend)   # gap in query
    F[i,j] = max(H[i-1,j] - (open+extend), F[i-1,j] - extend)   # gap in db seq
    score  = max over all cells of H

All arithmetic is exact int32 — this equals the reference's final semantics,
whose int8/int16 fast paths are always rescued to exact 32-bit scores on
saturation (/root/reference/host/src/FPGAsearch.c:241-274,
HybridSearch.c:398-609), so no overflow-escalation machinery is needed.

Two implementations:

- `sw_score_numpy`: scalar O(m*n) loop; trivially auditable ground truth for
  tiny inputs in tests.
- `sw_score_diag`: an anti-diagonal wavefront `lax.scan` — each scan step
  computes one full anti-diagonal as a vector, so a single long pair runs
  vectorised.  It is `vmap`-batchable over database sequences and
  doubles as the long-sequence / single-pair scoring path of the engine.
"""

import numpy as np

import jax
import jax.numpy as jnp

from oswald_tpu.alphabet import DUMMY, ALPHA_SIZE


def sw_score_numpy(a, b, submat, open_gap: int = 10, extend_gap: int = 2) -> int:
    """Scalar-loop oracle. a, b: int code arrays; submat: [24,24] ints."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    sm = np.asarray(submat, dtype=np.int64)
    oe, e = open_gap + extend_gap, extend_gap
    m, n = len(a), len(b)
    H = np.zeros(n + 1, dtype=np.int64)   # H[i-1, :] row buffer
    E = np.zeros(n + 1, dtype=np.int64)
    F = np.zeros(n + 1, dtype=np.int64)   # F carried down column j
    best = 0
    for i in range(m):
        diag = 0                           # H[i-1, j-1]
        h_left = 0                         # H[i, j-1]
        e_run = 0                          # E[i, j]
        for j in range(n):
            E_ij = max(h_left - oe, e_run - e)
            F[j] = max(H[j] - oe, F[j] - e)
            h = max(0, diag + sm[a[i], b[j]], E_ij, F[j])
            best = max(best, h)
            diag = H[j]
            H[j] = h
            h_left = h
            e_run = E_ij
    return int(best)


def _sw_score_diag_impl(a, b, n_b, submat, open_gap, extend_gap):
    m = a.shape[0]
    n = b.shape[0]
    oe = (open_gap + extend_gap).astype(jnp.int32)
    eg = extend_gap.astype(jnp.int32)
    sm = submat.astype(jnp.int32).reshape(-1)

    # bp_rev[k] = b[n + m - 1 - d + i] trick: pad b on both sides with DUMMY
    # then reverse, so that the window for diagonal d is a dynamic slice.
    bp = jnp.concatenate([
        jnp.full((m,), DUMMY, dtype=jnp.int32),
        b,
        jnp.full((m,), DUMMY, dtype=jnp.int32),
    ])
    br = bp[::-1]                              # br[k] = bp[n + 2m - 1 - k]

    i_vec = jnp.arange(m, dtype=jnp.int32)
    row_gather = a * jnp.int32(ALPHA_SIZE)     # submat row offsets per i

    def step(carry, d):
        h_d1, h_d2, e_d1, f_d1, best = carry
        j_vec = d - i_vec
        # b[j_vec] = bp[j_vec + m] = br[n + m - 1 - d + i]
        bwin = jax.lax.dynamic_slice(br, (n + m - 1 - d,), (m,))
        s = jnp.take(sm, row_gather + bwin)

        # E[i, j] from (i, j-1): previous diagonal, same i
        e_new = jnp.maximum(h_d1 - oe, e_d1 - eg)
        # F[i, j] from (i-1, j): previous diagonal, i-1 -> shift down by one
        h_up = jnp.concatenate([jnp.zeros((1,), jnp.int32), h_d1[:-1]])
        f_up = jnp.concatenate([jnp.zeros((1,), jnp.int32), f_d1[:-1]])
        f_new = jnp.maximum(h_up - oe, f_up - eg)
        # H from (i-1, j-1): two diagonals back, i-1
        diag = jnp.concatenate([jnp.zeros((1,), jnp.int32), h_d2[:-1]])
        h_new = jnp.maximum(jnp.maximum(diag + s, 0),
                            jnp.maximum(e_new, f_new))
        valid = (j_vec >= 0) & (j_vec < n_b)
        h_new = jnp.where(valid, h_new, 0)
        e_new = jnp.where(valid, e_new, 0)
        f_new = jnp.where(valid, f_new, 0)
        best = jnp.maximum(best, jnp.max(h_new))
        return (h_new, h_d1, e_new, f_new, best), None

    zeros = jnp.zeros((m,), jnp.int32)
    init = (zeros, zeros, zeros, zeros, jnp.int32(0))
    (_, _, _, _, best), _ = jax.lax.scan(
        step, init, jnp.arange(m + n - 1, dtype=jnp.int32))
    return best


_sw_score_diag_jit = jax.jit(_sw_score_diag_impl)
_sw_score_diag_batch_jit = jax.jit(
    jax.vmap(_sw_score_diag_impl, in_axes=(None, 0, 0, None, None, None)))


def sw_score_diag(a, b, n_b, submat, open_gap=10, extend_gap=2):
    """Anti-diagonal wavefront scorer (jitted; gaps/matrix are traced args,
    so different matrices and gap penalties reuse one compilation per shape).

    a:    int32[m]  encoded query (may contain DUMMY padding rows; dummy
                    scores 0 so padding never raises the max)
    b:    int32[n]  encoded subject, padded with DUMMY
    n_b:  int32     true subject length (cells with j >= n_b are masked)
    Returns the int32 local alignment score.

    Scans diagonals d = i + j; each step updates length-m vectors indexed by
    i, with j = d - i.  This replaces the reference's
    FPGA column-block pipeline for the one-pair case.
    """
    return _sw_score_diag_jit(
        jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32),
        jnp.asarray(n_b, jnp.int32), jnp.asarray(submat),
        jnp.asarray(open_gap, jnp.int32), jnp.asarray(extend_gap, jnp.int32))


def sw_score_diag_batch(a, bs, n_bs, submat, open_gap=10, extend_gap=2):
    """vmap of `sw_score_diag` over a [B, n] batch of subjects."""
    return _sw_score_diag_batch_jit(
        jnp.asarray(a, jnp.int32), jnp.asarray(bs, jnp.int32),
        jnp.asarray(n_bs, jnp.int32), jnp.asarray(submat),
        jnp.asarray(open_gap, jnp.int32), jnp.asarray(extend_gap, jnp.int32))
