"""Device auto-tuner for the kernel geometry (`oswald-tpu tune`).

The shipping defaults (u_rows=8, group_block=1, col_unroll=1) were
measured on an H100 for one 128-column chunk of a 44-group bin at m=512
(kernels.sw_lanes, DEFAULT_COL_UNROLL); another card, or another bin
shape, may prefer others, so a deployment runs `oswald-tpu tune` once on
its card and passes the winning flags to `search`/`serve`.

The measurement drives the REAL kernel (`engine.search._search_bin` — the
same compiled scan the engine dispatches) over a synthetic profile stack,
so it needs no database.  Tuning is coordinate descent over the three
geometry axes from the current default; every candidate's score checksum
must equal the default's (a miscompiled candidate disqualifies itself
rather than winning).  It needs a GPU: the CPU runs the kernel
interpreted, where no geometry is faster for a reason that carries over.

Reference analog: OSWALD's compile-time geometry knobs
(FPGA_VECTOR_LENGTH, FPGA_BLOCK_WIDTH, CPU_BLOCK_SIZE —
/root/reference/host/src/arguments.h:24-28), which its papers tuned per
board; here the tune is a runtime measurement instead of a rebuild.
"""

import time

import numpy as np

import jax
import jax.numpy as jnp

from oswald_tpu.io.db import SUBLANES, LANES
from oswald_tpu.kernels import build_profile, kernel_interpret, CHUNK_WIDTH
from oswald_tpu.submat import get_submat

# coordinate-descent axes (validated values only: u_rows pow2 <= 64,
# group_block a power of two dividing the synthetic G, col_unroll divides
# 32; unrolling past 4 compiles for minutes per kernel on the GPU)
U_ROWS_AXIS = (4, 8, 16)
GROUP_BLOCK_AXIS = (1, 2, 4)
COL_UNROLL_AXIS = (1, 2, 4)
SYNTH_G = 24                    # divisible by every group_block candidate


def _measure(q, gaps, prof, u, gb, cu, iters, interpret):
    """(gcells_per_s, checksum) for one geometry on the attached device."""
    from oswald_tpu.engine.search import _search_bin

    def run():
        return int(jnp.sum(_search_bin(
            q, gaps, prof, u, interpret, gb, jnp.float32, None, cu, True)))

    checksum = run()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    m = q.shape[0]
    C, G = prof.shape[0], prof.shape[1]
    cells = m * G * C * CHUNK_WIDTH * SUBLANES * LANES
    return cells / min(times) / 1e9, checksum


def autotune(m: int = 512, groups: int = SYNTH_G, chunks: int = 8,
             iters: int = 3, log=None, interpret: bool = False) -> dict:
    """Coordinate-descent tune; returns {"u_rows", "group_block",
    "col_unroll", "gcells", "results": [...]} (results = every candidate
    measured, for the record).  interpret=True runs the descent on the
    interpreted kernel (its numbers measure nothing; for tests)."""
    def say(msg):
        if log:
            log(msg)

    dev = jax.devices()[0]
    if not interpret and kernel_interpret(dev.platform):
        raise RuntimeError(
            f"tune measures the compiled kernel and needs a GPU; JAX found "
            f"{dev.platform}")
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.integers(0, 23, m), jnp.int32)
    gaps = jnp.asarray([10, 2], jnp.int32)
    sm = get_submat("blosum62")
    seq = rng.integers(0, 24, (groups, chunks, CHUNK_WIDTH, SUBLANES,
                               LANES)).astype(np.int8)
    prof = jnp.stack([build_profile(jnp.asarray(seq[:, c]), sm)
                      for c in range(chunks)])

    # baseline = the shipping geometry where the axes include it, else the
    # first entry of each (possibly monkeypatched/narrowed) axis — the
    # baseline must be a config the descent actually measures
    best = {"u_rows": 8 if 8 in U_ROWS_AXIS else U_ROWS_AXIS[0],
            "group_block": 1 if 1 in GROUP_BLOCK_AXIS
            else GROUP_BLOCK_AXIS[0],
            "col_unroll": 1 if 1 in COL_UNROLL_AXIS
            else COL_UNROLL_AXIS[0]}
    results = []
    ref_sum = None

    def try_cfg(u, gb, cu):
        nonlocal ref_sum
        if m % u or groups % gb or 32 % cu:
            return None
        key = (u, gb, cu)
        for r in results:                     # don't re-measure
            if r["cfg"] == key:
                return r["gcells"]
        try:
            gc, s = _measure(q, gaps, prof, u, gb, cu, iters, interpret)
        except Exception as e:                # noqa: BLE001 — a candidate
            say(f"  u={u} gb={gb} cu={cu}: FAILED ({type(e).__name__})")
            results.append({"cfg": key, "gcells": 0.0, "error": str(e)[:80]})
            return 0.0                        # that can't compile loses
        if ref_sum is None:
            ref_sum = s
        if s != ref_sum:                      # exactness gate
            say(f"  u={u} gb={gb} cu={cu}: CHECKSUM MISMATCH — disqualified")
            results.append({"cfg": key, "gcells": 0.0, "error": "checksum"})
            return 0.0
        say(f"  u={u} gb={gb} cu={cu}: {gc:.1f} Gcells/s")
        results.append({"cfg": key, "gcells": round(gc, 3)})
        return gc

    if m % best["u_rows"] or groups % best["group_block"]:
        raise ValueError(
            f"m={m} must be a multiple of u_rows {best['u_rows']} and "
            f"groups={groups} of group_block {best['group_block']} (the "
            "baseline geometry must be measurable)")
    say(f"tuning on {jax.devices()[0].device_kind} "
        f"(m={m}, G={groups}, C={chunks})")
    best_gc = try_cfg(best["u_rows"], best["group_block"],
                      best["col_unroll"]) or 0.0
    for axis, values in (("u_rows", U_ROWS_AXIS),
                         ("group_block", GROUP_BLOCK_AXIS),
                         ("col_unroll", COL_UNROLL_AXIS)):
        for v in values:
            if v == best[axis]:
                continue
            cand = dict(best, **{axis: v})
            gc = try_cfg(cand["u_rows"], cand["group_block"],
                         cand["col_unroll"])
            if gc is not None and gc > best_gc:
                best, best_gc = cand, gc
    if not any("error" not in r for r in results):
        raise RuntimeError(
            "no tuning candidate ran successfully; see the per-candidate "
            "errors in the log")
    return {**best, "gcells": round(best_gc, 3),
            "device": jax.devices()[0].device_kind,
            "results": [{"u_rows": c[0], "group_block": c[1],
                         "col_unroll": c[2],
                         **{k: v for k, v in r.items() if k != "cfg"}}
                        for r in results for c in [r["cfg"]]]}
