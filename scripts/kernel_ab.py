"""Time the Triton kernel against the plain-XLA scan on one database bin.

    python -m scripts.kernel_ab [--L 224] [--G 44] [--m 512] [--iters 3]

One random bin [G, L, 8, 128] (per-lane true lengths in (L-32, L]) and one
query of length m.  Measured on the attached GPU, each with
`block_until_ready`, best of --iters after a compile run:

- `kernel`: the whole-bin precompute-mode scan (`sw_chunk` per column
  chunk, colH/colE carried) at the engine's default launch geometry;
- `plain`: `core.sw_score_diag_batch`, the vmapped anti-diagonal
  `lax.scan`, over the same subjects (what XLA makes of the plain
  recurrence);
- `profile`: `kernels.build_profile` (an XLA gather) against the one-hot
  int8 einsum it replaced, over a 256-chunk slab.

GCUPS count true cells (m x the lanes' true lengths), the same for both.
Every kernel result must equal the plain one.  Prints one JSON object
per line, each with the card's name and power limit.
"""

import argparse
import json
import subprocess
import time

import numpy as np

import jax
import jax.numpy as jnp

from oswald_tpu.alphabet import DUMMY
from oswald_tpu.core import sw_score_diag_batch
from oswald_tpu.io.db import SUBLANES, LANES
from oswald_tpu.kernels import sw_chunk, build_profile, CHUNK_WIDTH
from oswald_tpu.kernels.sw_lanes import COMPILED_SUBLANE_BLOCK
from oswald_tpu.submat import get_submat


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def best_of(fn, iters):
    jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return min(times)


def scan_bin(q, gaps, profs, tail, u=8, cu=1):
    G, m = profs.shape[1], q.shape[0]
    acc = jnp.float32
    colH = jnp.zeros((G, m, SUBLANES, LANES), acc)
    carry = (colH, colH, jnp.zeros((G, SUBLANES, LANES), acc))

    def one(carry, prof):
        colH, colE, sc = carry
        colHd = jnp.concatenate(
            [jnp.zeros((G, 1, SUBLANES, LANES), acc),
             colH[:, u - 1::u][:, :-1]], axis=1)
        sc, colH, colE = sw_chunk(
            q, gaps, prof, colH, colHd, colE, sc, u_rows=u, acc_dtype=acc,
            col_unroll=cu, noadj=True)
        return (colH, colE, sc), None

    carry, _ = jax.lax.scan(one, carry, profs)
    if tail is not None:
        carry, _ = one(carry, tail)
    return carry[2].astype(jnp.int32)


def profile_onehot(db_chunk, submat):
    """The replaced build_profile: a one-hot int8 einsum."""
    G, W = db_chunk.shape[:2]
    sm = jnp.asarray(submat, jnp.int8)
    flat = db_chunk.reshape(G, W * SUBLANES, LANES)
    oh = (flat[..., None] == jnp.arange(24, dtype=jnp.int8)).astype(jnp.int8)
    return jnp.einsum("gplk,ck->gcpl", oh, sm,
                      preferred_element_type=jnp.int32).astype(jnp.int8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--L", type=int, default=224)
    ap.add_argument("--G", type=int, default=44)
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform}")
    base = {"card": card(), "device_kind": dev.device_kind,
            "platform": dev.platform, "devices": jax.device_count()}
    say = lambda **kw: print(json.dumps({**kw, **base}), flush=True)

    L, G, m = args.L, args.G, args.m
    rng = np.random.default_rng(0)
    lanes = G * SUBLANES * LANES
    n_b = rng.integers(max(L - 31, 1), L + 1, size=lanes)
    subj = rng.integers(0, 23, size=(lanes, L)).astype(np.int8)
    subj[np.arange(L)[None, :] >= n_b[:, None]] = DUMMY
    seq = jnp.asarray(subj.reshape(G, SUBLANES, LANES, L)
                      .transpose(0, 3, 1, 2))
    sm = get_submat("blosum62")
    q = jnp.asarray(rng.integers(0, 23, m), jnp.int32)
    gaps = jnp.asarray([10, 2], jnp.int32)
    C = L // CHUNK_WIDTH
    profs = jnp.stack([build_profile(seq[:, c * CHUNK_WIDTH:
                                         (c + 1) * CHUNK_WIDTH], sm)
                       for c in range(C)])
    tail = build_profile(seq[:, C * CHUNK_WIDTH:], sm) \
        if L % CHUNK_WIDTH else None
    cells = float(m) * float(n_b.sum())

    bs, ns = jnp.asarray(subj, jnp.int32), jnp.asarray(n_b, jnp.int32)
    plain = lambda: sw_score_diag_batch(q, bs, ns, sm, 10, 2)
    want = np.asarray(plain())
    t = best_of(plain, args.iters)
    say(kind="plain", L=L, G=G, m=m, seconds=t, gcups=cells / t / 1e9)

    jf = jax.jit(scan_bin)
    fn = lambda: jf(q, gaps, profs, tail)
    t0 = time.perf_counter()
    got = np.asarray(fn()).reshape(-1)
    compile_s = time.perf_counter() - t0
    if not np.array_equal(got, want):
        raise SystemExit("kernel disagrees with the plain scan")
    t = best_of(fn, args.iters)
    say(kind="kernel", L=L, G=G, m=m, seconds=t, gcups=cells / t / 1e9,
        first_call_s=compile_s,
        programs=G * SUBLANES // COMPILED_SUBLANE_BLOCK)

    slab = jnp.asarray(rng.integers(0, 24, (256, CHUNK_WIDTH, SUBLANES,
                                            LANES)), jnp.int8)
    ref = None
    sm_dev = jnp.asarray(sm)
    for name, f in (("take", build_profile), ("onehot", profile_onehot)):
        fj = lambda jf=jax.jit(f): jf(slab, sm_dev)
        out = np.asarray(fj())
        if ref is None:
            ref = out
        elif not np.array_equal(out, ref):
            raise SystemExit("profile builds disagree")
        t = best_of(fj, args.iters)
        say(kind="profile", build=name, seconds=t,
            out_gb_per_s=out.nbytes / t / 1e9)


if __name__ == "__main__":
    main()
