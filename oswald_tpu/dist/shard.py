"""Distributed search: sharded database, collective top-k merge.

The replacement of the reference's multi-device machinery:

- The multi-FPGA round-robin chunk scheduler
  (/root/reference/host/src/FPGAsearch.c:132-239) becomes a
  `jax.sharding.Mesh` over all devices with the packed database's group axis
  sharded across the mesh — XLA runs every shard's scan concurrently; there
  is no host-side scheduling loop at all.
- The host/FPGA calibration-based workload balancer
  (/root/reference/host/src/sequences.c:827-1094, HybridSearch.c:124-622)
  becomes *static* balancing: within a length bin every group costs the
  same (identical padded shape), so an even split of groups is an even
  split of work; across bins every device owns a slice of every bin.
  No calibration phase exists.
- The host-side gather of per-chunk scores + global mergesort
  (FPGAsearch.c:236-237, utils.c:3-86) becomes a per-shard `lax.top_k`
  followed by an `all_gather` of the k candidates (NCCL over NVLink on one
  host) and a replicated
  global `lax.top_k` — O(k) bytes cross the interconnect per bin instead of
  one score per database sequence.

Multi-host note: the same program runs under `jax.distributed` with a mesh
spanning all processes; each host constructs its process-local group slice
(`np.ndarray` per bin) and `jax.make_array_from_process_local_data`
assembles the global sharded array.  Tests exercise the logic on a virtual
8-device CPU mesh.
"""

import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from oswald_tpu.alphabet import DUMMY
from oswald_tpu.submat import get_submat
from oswald_tpu.io.db import PackedDB, SUBLANES, LANES
from oswald_tpu.dist.repack import repack_for_mesh
from oswald_tpu.kernels import build_profile, noadj_ok, CHUNK_WIDTH
from oswald_tpu.engine.search import (
    SearchConfig, SearchResult, _search_bin_stream_impl,
    _search_bin_flat_impl, _search_bin_flat_batch_impl,
    _search_bin_stream_batch_impl, _search_bin_flat_pack_impl,
    _search_bin_stream_pack_impl, _search_bin_hostslice_impl,
    _split_packed, _result_stats, _db_len_stats, pad_query,
    mixed_pack_plan, MIXED_PACK_SEGS, resolve_exact_acc_dtype, nb_of,
    nb_or_none, MOM_COLS, TAIL_SDS, TAIL_SDS0,
)
from oswald_tpu.engine.planner import plan_profile_mode
from oswald_tpu.utils.metrics import Metrics

AXIS = "d"


def _psum_moments_col(flat, idsf, lnl_table, ndim, top_s=None):
    """Mesh-global score moments as packed int32 columns (the dist analog
    of engine.search._append_moments): sum(S), sum(S^2) and sum(S*lnL)
    over the valid local scores, psum'd over the mesh axis so every shard
    returns the SAME replicated moments, bitcast f32->int32 for
    concatenation onto the packed candidate array.  lnl_table is the
    REPLICATED per-sorted-id float32 ln-length table; the shard's own ids
    gather its lnL values, so no per-bin length arrays need sharding.

    top_s: the replicated GLOBAL top-k scores ([kk] / [Q, kk]) — when
    given (the fused whole-database program) the censored tail summary
    for stats.tail_calibrate is also computed: the threshold derives from
    the psum'd hit-excluded moments (identical on every shard), local
    exceedance counts psum.  When None (per-bin / per-slice programs,
    which cannot see the whole database) the sentinel T1 = -1 keeps the
    moment-only fit.

    flat: [n] or [Q, n] local scores; ndim 2 returns [2, MOM_COLS]
    (layout [[sum, sumsq, slnl, T1], [c0, c1, T0, 0]]), ndim 3
    returns [2, Q, MOM_COLS] — matching engine.search._append_moments."""
    valid = idsf >= 0
    sf = jnp.where(valid, flat, 0).astype(jnp.float32)
    lnl = jnp.where(valid, jnp.take(lnl_table, jnp.maximum(idsf, 0),
                                    fill_value=0.0), 0.0)
    parts = [jnp.sum(sf, axis=-1), jnp.sum(sf * sf, axis=-1),
             jnp.sum(sf * lnl, axis=-1)]
    # idsf is per-slot (shared across a query batch): broadcast the valid
    # count to the batch shape
    parts.append(jnp.sum(valid.astype(jnp.float32))
                 * jnp.ones_like(parts[0]))
    mom = jax.lax.psum(jnp.stack(parts), AXIS)      # [4] or [4, Q]
    s1, s2, slnl, n = mom[0], mom[1], mom[2], mom[3]
    z = jnp.zeros_like(s1)
    if top_s is None:
        t0, t1, c0, c1 = z - 1.0, z - 1.0, z, z
    else:
        top = top_s.astype(jnp.float32)
        topv = top >= 0
        tf = jnp.where(topv, top, 0.0)
        n_ex = jnp.maximum(n - jnp.sum(topv.astype(jnp.float32),
                                       axis=-1), 1.0)
        mean = (s1 - jnp.sum(tf, axis=-1)) / n_ex
        var = jnp.maximum((s2 - jnp.sum(tf * tf, axis=-1)) / n_ex
                          - mean * mean, 0.0)
        sd = jnp.sqrt(var)
        t0 = jnp.ceil(mean + TAIL_SDS0 * sd)
        t1 = jnp.ceil(mean + TAIL_SDS * sd)
        up = (lambda t: t[..., None]) if sf.ndim > 1 else (lambda t: t)
        tails = jnp.stack(
            [jnp.sum((valid & (sf >= up(t0))).astype(jnp.float32),
                     axis=-1),
             jnp.sum((valid & (sf >= up(t1))).astype(jnp.float32),
                     axis=-1)])
        tails = jax.lax.psum(tails, AXIS)
        c0, c1 = tails[0], tails[1]
    out = jnp.stack([s1, s2, slnl, t1, c0, c1, t0, z])
    if ndim == 3:
        # [8, Q] -> [2, Q, MOM_COLS] matching _append_moments' row layout
        return jax.lax.bitcast_convert_type(out, jnp.int32) \
            .reshape(2, MOM_COLS, -1).transpose(0, 2, 1)
    return jax.lax.bitcast_convert_type(out, jnp.int32) \
        .reshape(2, MOM_COLS)


@jax.jit
def _concat_cands(*cands):
    """Concatenate per-bin packed candidate arrays ([2, kk] or [2, Q, kk])
    along the last axis so the host reads ONE array per search instead of
    two per bin."""
    return jnp.concatenate(cands, axis=-1)


def make_device_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over all (or the first n) addressable devices.

    A flat axis is the right topology here: the computation is pure data
    parallelism over database groups, and the only collective is an
    all-gather of k candidates, so there is nothing to gain from a 2-D
    (hosts x chips) factorisation.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} devices are available")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def shard_groups(bin_arrays: dict, n_shards: int) -> dict:
    """Pad one bin's [G, ...] arrays so G divides n_shards.

    Padding groups hold dummy residues (score 0 vs everything) and id -1
    (masked out of top-k), so they change no result — the static-shape
    analog of the reference's chunk-count rounding to a device multiple
    (/root/reference/host/src/sequences.c:913-918).
    """
    G = bin_arrays["seq"].shape[0]
    G_pad = -(-G // n_shards) * n_shards
    if G_pad == G:
        return bin_arrays
    pad = G_pad - G
    L = bin_arrays["seq"].shape[1]
    return {
        "seq": np.concatenate(
            [bin_arrays["seq"],
             np.full((pad, L, SUBLANES, LANES), DUMMY, np.int8)]),
        "len": np.concatenate(
            [bin_arrays["len"], np.zeros((pad, SUBLANES, LANES), np.int32)]),
        "id": np.concatenate(
            [bin_arrays["id"], np.full((pad, SUBLANES, LANES), -1, np.int32)]),
    }


def process_group_slice(G_pad: int, mesh: Mesh):
    """Contiguous [lo, hi) group range owned by this process on a 1-D mesh.

    Groups shard evenly over mesh devices in order; a process owns the
    union of its addressable devices' ranges (contiguous for standard
    device orderings).  Multi-host input loading reads only this slice
    (the .oswt arrays are memory-mapped, so the read is shard-sized).
    """
    devs = mesh.devices.reshape(-1)
    per = G_pad // devs.size
    me = jax.process_index()
    local = [i for i, d in enumerate(devs) if d.process_index == me]
    if not local:
        return 0, 0
    lo, hi = min(local), max(local) + 1
    assert local == list(range(lo, hi)), \
        "process devices not contiguous in mesh order"
    return lo * per, hi * per


def _put_local(mesh: Mesh, spec: P, local_np, global_shape):
    """Assemble a mesh-sharded Array from this process's slice.

    Single-process: local == global, a plain device_put.  Multi-process
    SPMD: every process passes only its own contiguous slice
    (process_group_slice) and the global Array is assembled from
    process-local data with no cross-host transfer — each pod host only
    ever holds its shard in RAM.
    """
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        assert tuple(local_np.shape) == tuple(global_shape), \
            (local_np.shape, global_shape)
        return jax.device_put(local_np, sharding)
    return jax.make_array_from_process_local_data(
        sharding, local_np, tuple(global_shape))


class DistributedSearchEngine:
    """Database search over a device mesh with collective top-k merge.

    Device-resident state: precompute mode holds ONE device-major flat
    profile array int8[ndev*Ctot_loc, 24, POS, 128] (+ tails) sharded on
    axis 0 — every bin's window lives on the device that scans it, and
    setup runs a single compiled sharded gather (see __init__); stream
    mode holds per-bin packed residues int8[C, G, W, 8, 128] sharded over
    the group axis.  A search runs one jitted shard_map program per bin
    that scans the local chunks, takes the local top-k, all-gathers the
    candidates, and reduces to the replicated global top-k; bins merge on
    the host (k entries per bin).
    """

    def __init__(self, db: PackedDB, config: SearchConfig = None,
                 mesh: Mesh = None):
        self.config = config or SearchConfig()
        self.mesh = mesh if mesh is not None else make_device_mesh()
        self.ndev = self.mesh.devices.size
        # mesh-adaptive bin geometry (dist/repack.py): merge bins so the
        # ndev*group_block group rounding stops dominating small
        # databases — the analog of the reference adapting its chunk size
        # to the device count (sequences.c:913-918).  Exact (dummy
        # padding is score-inert); self.db is the merged view, the
        # original is kept for alignment/title lookups (identical
        # sequences either way).
        self.src_db = db
        self.db = db = repack_for_mesh(
            db, self.ndev * self.config.group_block)
        self.submat = get_submat(self.config.matrix)
        self._interpret = self.config.resolved_interpret()
        # fp32 demotes to int32 past the float32 exact-integer bound
        self._acc = resolve_exact_acc_dtype(self.config, self.submat, db)
        # relaxed E-update (one fewer op/cell) when exact for this
        # matrix/gap config — see kernels.noadj_ok
        self._noadj = noadj_ok(self.submat, self.config.extend_gap)
        self.gaps = jnp.asarray(
            [self.config.open_gap, self.config.extend_gap], jnp.int32)
        self.submat_dev = jax.device_put(
            jnp.asarray(self.submat), NamedSharding(self.mesh, P()))

        # resolve "auto" through the capacity planner with the per-device
        # share (the group axis shards evenly over the mesh)
        self.mode = self.config.profile_mode
        if self.mode == "auto":
            plan = plan_profile_mode(db, self.config.hbm_budget_bytes,
                                     n_devices=self.ndev,
                                     max_query_len=self.config.max_query_len,
                                     config=self.config)
            self.mode = plan.mode
            if jax.process_index() == 0:
                print(f"oswald-tpu dist engine [{self.ndev} devices]: "
                      f"{plan.describe()}", file=sys.stderr)
        self.metrics = Metrics()
        t_setup = time.perf_counter()
        self.seq_stacks = {}
        self.ids = {}
        self._bin_fns = {}
        # significance-fit state (see engine.search._db_len_stats); the
        # per-sorted-id ln-length table is replicated on every device so
        # each shard's moments gather lnL through the ids it already holds
        lnl_by_id, self._lnl_mom, self._len_hist = _db_len_stats(db)
        self._lnl_by_id = lnl_by_id
        self.lnl_table = jax.device_put(
            lnl_by_id if len(lnl_by_id) else np.zeros(1, np.float32),
            NamedSharding(self.mesh, P()))
        if self.mode == "host_stream":
            # database larger than the mesh's aggregate HBM budget: groups
            # stay host-side (mmap) and stream through the mesh in
            # device-major slices, double-buffered under compute (the
            # multi-device analog of the single-chip host_stream and of
            # the reference's per-chunk clEnqueueWriteBuffer round,
            # /root/reference/host/src/FPGAsearch.c:180-237)
            self._init_host_stream()
            self.metrics.add("engine_setup", time.perf_counter() - t_setup)
            return
        # precompute mode: ONE device-sharded flat chunk array for the
        # whole database (+ one for 64-wide tails), gathered into profiles
        # by a single compiled sharded program — the same
        # per-bin-shape-compiles-dominate-setup fix as the single-chip
        # engine (engine/search.py), with the flat axis laid out
        # DEVICE-MAJOR: device d's block rows are its own bins' (c, g_loc)
        # entries, so P(AXIS) on axis 0 puts every row on the device that
        # scans it.  Searches dynamic_slice their bin's window out of the
        # local block inside shard_map (_search_bin_flat_impl).
        self.prof_flat = None
        # per tail width w: one device-major flat tail-profile array (the
        # 32-residue bin quantum leaves 32/64/96-position tails)
        self.tail_flats = {}            # w -> sharded int8[Tw, 24, w*8, 128]
        self.bin_geom = {}        # L -> (off_loc, C, G_loc, toff|None, tw)
        flat_parts = []                 # per bin: [ndev_loc, C*G_loc, W,8,128]
        tail_parts = {}                 # w -> [[ndev_loc, G_loc, w,8,128]]
        toff_n = {}                     # w -> next local offset
        coff = 0
        ndev_loc = None

        for L in db.bin_lengths:
            # pad the global group count so every shard's local count also
            # divides group_block; then build only THIS PROCESS's group
            # slice (multi-host: the db arrays are mmap'd, so the read and
            # the host RAM stay shard-sized)
            G_real = db.bins[L]["seq"].shape[0]
            quanta = self.ndev * self.config.group_block
            G = -(-G_real // quanta) * quanta
            C = L // CHUNK_WIDTH
            G_loc = G // self.ndev
            lo, hi = process_group_slice(G, self.mesh)
            nloc = (hi - lo) // G_loc if G_loc else 0
            ndev_loc = nloc if ndev_loc is None else ndev_loc
            assert nloc == ndev_loc, (nloc, ndev_loc)
            seq_loc = np.full((hi - lo, L, SUBLANES, LANES), DUMMY, np.int8)
            ids_loc = np.full((hi - lo, SUBLANES, LANES), -1, np.int32)
            take = max(0, min(hi, G_real) - lo)
            if take:
                seq_loc[:take] = db.bins[L]["seq"][lo:lo + take]
                ids_loc[:take] = db.bins[L]["id"][lo:lo + take]

            main_loc = seq_loc[:, :C * CHUNK_WIDTH].reshape(
                hi - lo, C, CHUNK_WIDTH, SUBLANES, LANES)
            tail_loc = seq_loc[:, C * CHUNK_WIDTH:] if L % CHUNK_WIDTH \
                else None
            if self.mode == "precompute":
                if C:
                    # [ndev_loc, C*G_loc, W, 8, 128], chunk-major per device
                    flat_parts.append(np.ascontiguousarray(
                        main_loc.reshape(nloc, G_loc, C, CHUNK_WIDTH,
                                         SUBLANES, LANES)
                        .transpose(0, 2, 1, 3, 4, 5)).reshape(
                            nloc, C * G_loc, CHUNK_WIDTH, SUBLANES, LANES))
                toff = tw = None
                if tail_loc is not None:
                    tw = L % CHUNK_WIDTH
                    tail_parts.setdefault(tw, []).append(tail_loc.reshape(
                        nloc, G_loc, tw, SUBLANES, LANES))
                    toff = toff_n.get(tw, 0)
                    toff_n[tw] = toff + G_loc
                self.bin_geom[L] = (coff, C, G_loc, toff, tw)
                coff += C * G_loc
            else:
                # chunk-major [C, G, W, 8, 128] residues, group axis sharded
                seq_sharded = _put_local(
                    self.mesh, P(None, AXIS),
                    np.ascontiguousarray(np.swapaxes(main_loc, 0, 1)),
                    (C, G, CHUNK_WIDTH, SUBLANES, LANES))
                tail_sharded = None
                if tail_loc is not None:
                    tail_sharded = _put_local(
                        self.mesh, P(AXIS), np.ascontiguousarray(tail_loc),
                        (G,) + tail_loc.shape[1:])
                self.seq_stacks[L] = (seq_sharded, tail_sharded)
            self.ids[L] = _put_local(self.mesh, P(AXIS), ids_loc,
                                     (G, SUBLANES, LANES))

        if self.mode == "precompute":
            POS = CHUNK_WIDTH * SUBLANES
            build = jax.jit(build_profile,
                            out_shardings=NamedSharding(self.mesh, P(AXIS)))
            nloc = ndev_loc or 0
            if flat_parts:
                local = np.concatenate(
                    [np.concatenate([part[i] for part in flat_parts])
                     for i in range(nloc)]) if nloc else \
                    np.zeros((0, CHUNK_WIDTH, SUBLANES, LANES), np.int8)
                flat_sharded = _put_local(
                    self.mesh, P(AXIS), local,
                    (self.ndev * coff, CHUNK_WIDTH, SUBLANES, LANES))
                self.prof_flat = build(flat_sharded, self.submat_dev)
            else:
                self.prof_flat = _put_local(
                    self.mesh, P(AXIS),
                    np.zeros((0, 24, POS, LANES), np.int8),
                    (0, 24, POS, LANES))
            for w, parts in tail_parts.items():
                local = np.concatenate(
                    [np.concatenate([part[i] for part in parts])
                     for i in range(nloc)]) if nloc else \
                    np.zeros((0, w, SUBLANES, LANES), np.int8)
                tail_sharded = _put_local(
                    self.mesh, P(AXIS), local,
                    (self.ndev * toff_n[w], w, SUBLANES, LANES))
                self.tail_flats[w] = build(tail_sharded, self.submat_dev)
        self.metrics.add("engine_setup", time.perf_counter() - t_setup)

    def _init_host_stream(self):
        """Cut every bin into mesh-wide group slices for streaming.

        A slice is `S` consecutive groups of one bin (S a multiple of
        ndev * group_block so it shards evenly and every shard's group
        count stays a group_block multiple); the packed residues stay in
        the mmap-backed storage arrays and only slice-sized windows ever
        occupy host RAM or HBM.  Slices here stay per-bin (unlike the
        single-chip engine's round-5 cross-bin flat buffers) BY DESIGN:
        the mesh-adaptive re-cut (dist/repack.py) has already merged
        bins to the pod's quanta — at N=8 the bench db has ~13 bins, at
        N=64 three — so per-bin slices are already hundreds of MB and
        per-transfer overhead is amortised without a second layout.  Per search the slices are transferred
        device-sharded and double-buffered under compute
        (_host_stream_candidates)."""
        self._hs_slices = []        # (L, lo, Gs_glob) in bin order
        self._hs_ids = {}
        quanta = self.ndev * self.config.group_block
        for L in self.db.bin_lengths:
            seq_np = self.db.bins[L]["seq"]        # keep mmap, no asarray
            self._hs_ids[L] = np.asarray(self.db.bins[L]["id"])
            G = seq_np.shape[0]
            per_group = L * SUBLANES * LANES
            S = max(quanta, (self.config.host_stream_slice_mb << 20)
                    // per_group // quanta * quanta)
            for lo in range(0, G, S):
                Gs = min(S, -(-(G - lo) // quanta) * quanta)
                self._hs_slices.append((L, lo, Gs))

    def _hs_transfer(self, L: int, lo: int, Gs: int):
        """Enqueue one slice's host->device transfer; returns the sharded
        (residues, ids) Arrays.

        Multi-process SPMD: each process device_puts only its own devices'
        contiguous group range (a view of the mmap when no padding is
        needed), so a pod host's RAM traffic is its shard of the slice."""
        seq_np = self.db.bins[L]["seq"]
        ids_np = self._hs_ids[L]
        G_real = seq_np.shape[0]
        p_lo, p_hi = process_group_slice(Gs, self.mesh)
        rows = p_hi - p_lo
        a_lo = lo + p_lo
        take = max(0, min(lo + p_hi, G_real) - a_lo)
        if take == rows:
            arr = seq_np[a_lo:a_lo + rows]
            ids_loc = ids_np[a_lo:a_lo + rows]
        else:                       # final slice: pad to the quanta multiple
            arr = np.full((rows, L, SUBLANES, LANES), DUMMY, np.int8)
            ids_loc = np.full((rows, SUBLANES, LANES), -1, np.int32)
            if take > 0:
                arr[:take] = seq_np[a_lo:a_lo + take]
                ids_loc[:take] = ids_np[a_lo:a_lo + take]
        seq_dev = _put_local(self.mesh, P(AXIS), arr,
                             (Gs, L, SUBLANES, LANES))
        ids_dev = _put_local(self.mesh, P(AXIS), ids_loc,
                             (Gs, SUBLANES, LANES))
        return seq_dev, ids_dev

    def _hostslice_fn(self, L: int, Gs: int, k: int, skip: bool):
        """Compiled shard_map for one streamed slice shape: (q_batch, gaps,
        submat, seq_slice, ids) -> (scores[Q, kk], ids[Q, kk]) replicated
        slice-local top-k candidates."""
        key = ("hs", L, Gs, k, skip)
        if key in self._bin_fns:
            return self._bin_fns[key]
        u_rows, interpret = self.config.u_rows, self._interpret
        gb, acc, cu, na = (self.config.group_block, self._acc,
                           self.config.col_unroll, self._noadj)

        def inner(q_batch, nbs, gaps, submat, seq_slice, ids, lnl_table):
            scores = _search_bin_hostslice_impl(
                q_batch, gaps, submat, seq_slice, u_rows, interpret, gb,
                acc, cu, na, nbs=nbs)
            Q = q_batch.shape[0]
            flat = scores.reshape(Q, -1)
            idsf = ids.reshape(-1)
            masked = jnp.where(idsf[None] >= 0, flat, -1)
            kk = min(k, flat.shape[1])
            loc_s, loc_i = jax.lax.top_k(masked, kk)
            loc_ids = jnp.take(idsf, loc_i)
            all_s = jax.lax.all_gather(loc_s, AXIS, axis=1, tiled=True)
            all_ids = jax.lax.all_gather(loc_ids, AXIS, axis=1, tiled=True)
            top_s, top_i = jax.lax.top_k(all_s, min(k, all_s.shape[1]))
            # packed int32[2, Q, kk+2] incl. trailing moments columns:
            # one readback transfer (see _bin_fn)
            packed = jnp.stack(
                [top_s, jnp.take_along_axis(all_ids, top_i, axis=1)])
            return jnp.concatenate(
                [packed, _psum_moments_col(flat, idsf, lnl_table, 3)],
                axis=-1)

        if skip:
            local_fn = inner
            specs = (P(), P(), P(), P(), P(AXIS), P(AXIS), P())
        else:
            local_fn = lambda q_batch, gaps, submat, seq_slice, ids, \
                lnl_table: inner(q_batch, None, gaps, submat, seq_slice,
                                 ids, lnl_table)
            specs = (P(), P(), P(), P(AXIS), P(AXIS), P())
        fn = jax.jit(jax.shard_map(
            local_fn, mesh=self.mesh, in_specs=specs, out_specs=P(),
            check_vma=False))
        self._bin_fns[key] = fn
        return fn

    def _host_stream_candidates_multi(self, classes, k: int):
        """ONE streaming sweep of the database for SEVERAL query classes
        at once (the dist analog of SearchEngine._host_stream_scores_multi
        — the batched path used to sweep once per padded-length class):
        every slice is transferred once, scanned by each class's
        shard_map programs, double-buffered — slice i+1's sharded
        transfer is enqueued before slice i's compute dispatch, and the
        host blocks only on slice i-1's (k-sized) candidate readbacks —
        at most two slices plus scan state occupy HBM at any point,
        regardless of database size (the reference's bounded per-chunk
        clEnqueueWriteBuffer round, FPGAsearch.c:180-237).

        classes: [(qb [Q, m_pad], nbs | None)]; returns one
        (cand_scores [Q, ncand], cand_ids [Q, ncand], mom) per class."""
        cls = [(jnp.asarray(qb),
                None if nbs is None else jnp.asarray(nbs, jnp.int32))
               for qb, nbs in classes]
        outs = [([], [], np.zeros(int(qb.shape[0]), np.float64),
                 np.zeros(int(qb.shape[0]), np.float64),
                 np.zeros(int(qb.shape[0]), np.float64))
                for qb, _ in cls]

        def dispatch(dev, L, Gs):
            res = []
            for ci, (qb, nbs) in enumerate(cls):
                args = (qb,) + (() if nbs is None else (nbs,))
                res.append((ci, self._hostslice_fn(
                    L, Gs, k, nbs is not None)(
                        *args, self.gaps, self.submat_dev, dev[0], dev[1],
                        self.lnl_table)))
            return res

        def drain(res):
            for ci, packed in res:
                arr = np.asarray(packed)        # [2, Q, kk+MOM_COLS]
                mom = np.ascontiguousarray(arr[..., -MOM_COLS:]) \
                    .view(np.float32).astype(np.float64)
                cand_s, cand_i, msum, msumsq, mslnl = outs[ci]
                msum += mom[0, :, 0]
                msumsq += mom[0, :, 1]
                mslnl += mom[0, :, 2]
                cand_s.append(arr[0, :, :-MOM_COLS])
                cand_i.append(arr[1, :, :-MOM_COLS])

        if not self.config.host_stream_overlap:
            # forced-serial A/B reference (see SearchConfig): block on
            # each slice's transfer and candidates before the next
            # transfer — no link/compute overlap; identical results
            for L, lo, Gs in self._hs_slices:
                dev = self._hs_transfer(L, lo, Gs)
                jax.block_until_ready(dev)
                drain(dispatch(dev, L, Gs))
        else:
            pending = None
            nxt = self._hs_transfer(*self._hs_slices[0]) \
                if self._hs_slices else None
            for i, (L, lo, Gs) in enumerate(self._hs_slices):
                dev = nxt
                nxt = self._hs_transfer(*self._hs_slices[i + 1]) \
                    if i + 1 < len(self._hs_slices) else None
                res = dispatch(dev, L, Gs)
                if pending is not None:
                    # blocking readback of slice i-1 (ONE packed transfer
                    # per class): the backpressure that bounds in-flight
                    # slices (and frees HBM)
                    drain(pending)
                pending = res
            if pending is not None:
                drain(pending)
        results = []
        for (qb, _), (cand_s, cand_i, msum, msumsq, mslnl) \
                in zip(cls, outs):
            Q = int(qb.shape[0])
            # per-slice programs cannot see the whole database: sentinel
            # T1 (no tail payload) keeps the moment-only fit here
            mom = (msum, msumsq, mslnl, np.full(Q, -1.0), np.zeros(Q),
                   np.zeros(Q), np.full(Q, -1.0))
            if not cand_s:
                results.append((np.zeros((Q, 0), np.int32),
                                np.zeros((Q, 0), np.int32), mom))
            else:
                results.append((np.concatenate(cand_s, axis=1),
                                np.concatenate(cand_i, axis=1), mom))
        return results

    def _host_stream_candidates(self, qb, k: int, nbs=None):
        """Single-class wrapper of _host_stream_candidates_multi."""
        return self._host_stream_candidates_multi([(qb, nbs)], k)[0]

    def _merge_candidates(self, scores, ids, k: int):
        """Deterministic host merge of one query's candidate union: score
        descending, id ascending on ties (identical to the device-side
        lax.top_k tie-break over slot-ordered scores)."""
        valid = ids >= 0
        scores, ids = scores[valid], ids[valid]
        order = np.lexsort((ids, -scores))[:k]
        return scores[order], ids[order]

    def _bin_fn(self, L: int, k: int, skip: bool):
        """Compiled per-bin shard_map: (q[, nb], gaps, data, ids) ->
        packed replicated candidates.  skip compiles the dummy-row-block
        variant (see sw_chunk n_blocks)."""
        key = (L, k, skip)
        if key in self._bin_fns:
            return self._bin_fns[key]
        u_rows, interpret = self.config.u_rows, self._interpret
        gb, acc, cu, na = (self.config.group_block, self._acc,
                           self.config.col_unroll, self._noadj)
        precompute = self.mode == "precompute"
        geom = self.bin_geom.get(L)

        def inner(q_pad, nb, gaps, submat, data, ids, lnl_table):
            if precompute:
                prof_flat, tail_flat = data
                off, C, G_loc, toff, _tw = geom
                scores = _search_bin_flat_impl(
                    q_pad, gaps, prof_flat, tail_flat, off, C, G_loc,
                    toff, u_rows, interpret, gb, acc, cu, na, nb=nb)
            else:
                main, tail = data
                scores = _search_bin_stream_impl(q_pad, gaps, submat, main,
                                                 u_rows, interpret, gb, acc,
                                                 tail, cu, na, nb=nb)
            flat = scores.reshape(-1)
            idsf = ids.reshape(-1)
            masked = jnp.where(idsf >= 0, flat, -1)
            # a shard can contribute at most its own slot count; the global
            # reduction may still keep up to k from the gathered union
            kk = min(k, flat.shape[0])
            loc_s, loc_i = jax.lax.top_k(masked, kk)
            loc_ids = jnp.take(idsf, loc_i)
            # O(k) bytes per device — the collective merge
            all_s = jax.lax.all_gather(loc_s, AXIS, tiled=True)
            all_ids = jax.lax.all_gather(loc_ids, AXIS, tiled=True)
            top_s, top_i = jax.lax.top_k(all_s, min(k, all_s.shape[0]))
            # packed int32[2, kk+2] (scores row 0, ids row 1, mesh-global
            # score moments in the last columns): one output array costs
            # ONE device->host transfer at readback instead of two
            packed = jnp.stack([top_s, jnp.take(all_ids, top_i)])
            return jnp.concatenate(
                [packed, _psum_moments_col(flat, idsf, lnl_table, 2)],
                axis=-1)

        # precompute data = (prof_flat, tail_flat): device-major flat rows
        # shard on axis 0; stream data = (main [C, G, ...] on axis 1,
        # tail [G, ...] on axis 0)
        data_spec = (P(AXIS), P(AXIS)) if precompute else \
            (P(None, AXIS), P(AXIS))
        if skip:
            local_fn = inner
            specs = (P(), P(), P(), P(), data_spec, P(AXIS), P())
        else:
            local_fn = lambda q_pad, gaps, submat, data, ids, lnl_table: \
                inner(q_pad, None, gaps, submat, data, ids, lnl_table)
            specs = (P(), P(), P(), data_spec, P(AXIS), P())
        fn = jax.jit(jax.shard_map(
            local_fn, mesh=self.mesh, in_specs=specs, out_specs=P(),
            check_vma=False))
        self._bin_fns[key] = fn
        return fn

    def _fused_fn(self, k: int, skip: bool):
        """One compiled shard_map for a WHOLE single-query search: every
        bin's scan, ONE local top-k over the shard's full slot vector,
        ONE all_gather + global top-k, one psum'd moment block — the
        distributed analog of SearchEngine._search_fn.  Replaces 17+
        per-bin programs (each with its own collective) with one program
        and one collective per search; tie-break parity holds because a
        shard's local slot order is ascending sorted-id order (its bin
        slices ascend by bin, and ids ascend within a slice), so the
        local top-k keeps each shard's lowest-id boundary ties exactly
        like the single-chip flat top-k does."""
        key = ("fused", k, skip)
        if key in self._bin_fns:
            return self._bin_fns[key]
        u_rows, interpret = self.config.u_rows, self._interpret
        gb, acc, cu, na = (self.config.group_block, self._acc,
                           self.config.col_unroll, self._noadj)
        precompute = self.mode == "precompute"
        bin_lengths = tuple(self.db.bin_lengths)
        bin_geom = dict(self.bin_geom)

        def inner(q_pad, nb, gaps, submat, data, ids, lnl_table):
            flats, id_parts = [], []
            for i, L in enumerate(bin_lengths):
                if precompute:
                    prof_flat, tail_flats = data
                    off, C, G_loc, toff, tw = bin_geom[L]
                    s = _search_bin_flat_impl(
                        q_pad, gaps, prof_flat,
                        tail_flats[tw] if toff is not None else None,
                        off, C, G_loc, toff, u_rows, interpret, gb, acc,
                        cu, na, nb=nb)
                else:
                    main, tail = data[L]
                    s = _search_bin_stream_impl(
                        q_pad, gaps, submat, main, u_rows, interpret,
                        gb, acc, tail, cu, na, nb=nb)
                flats.append(s.reshape(-1))
                id_parts.append(ids[i].reshape(-1))
            flat = jnp.concatenate(flats)
            idsf = jnp.concatenate(id_parts)
            masked = jnp.where(idsf >= 0, flat, -1)
            kk = min(k, flat.shape[0])
            loc_s, loc_i = jax.lax.top_k(masked, kk)
            loc_ids = jnp.take(idsf, loc_i)
            all_s = jax.lax.all_gather(loc_s, AXIS, tiled=True)
            all_ids = jax.lax.all_gather(loc_ids, AXIS, tiled=True)
            top_s, top_i = jax.lax.top_k(all_s, min(k, all_s.shape[0]))
            packed = jnp.stack([top_s, jnp.take(all_ids, top_i)])
            # whole-database program: the tail summary rides along
            return jnp.concatenate(
                [packed, _psum_moments_col(flat, idsf, lnl_table, 2,
                                           top_s=top_s)],
                axis=-1)

        if precompute:
            data_spec = (P(AXIS), P(AXIS))      # prefix: flat + tail dict
        else:
            data_spec = {L: (P(None, AXIS), P(AXIS)) for L in bin_lengths}
        ids_spec = tuple(P(AXIS) for _ in bin_lengths)
        if skip:
            local_fn = inner
            specs = (P(), P(), P(), P(), data_spec, ids_spec, P())
        else:
            local_fn = lambda q_pad, gaps, submat, data, ids, lnl_table: \
                inner(q_pad, None, gaps, submat, data, ids, lnl_table)
            specs = (P(), P(), P(), data_spec, ids_spec, P())
        fn = jax.jit(jax.shard_map(
            local_fn, mesh=self.mesh, in_specs=specs, out_specs=P(),
            check_vma=False))
        self._bin_fns[key] = fn
        return fn

    def _bin_scores_fn(self, L: int, skip: bool):
        """Compiled per-bin shard_map returning the FULL slot-score vector
        (all_gathered over the mesh, replicated) — the diagnostic analog
        of SearchEngine.score_all.  O(G·1024) readback instead of O(k),
        so it only runs when explicitly requested (CLI -H histogram)."""
        key = ("all", L, skip)
        if key in self._bin_fns:
            return self._bin_fns[key]
        u_rows, interpret = self.config.u_rows, self._interpret
        gb, acc, cu, na = (self.config.group_block, self._acc,
                           self.config.col_unroll, self._noadj)
        precompute = self.mode == "precompute"
        geom = self.bin_geom.get(L)

        def inner(q_pad, nb, gaps, submat, data):
            if precompute:
                prof_flat, tail_flat = data
                off, C, G_loc, toff, _tw = geom
                scores = _search_bin_flat_impl(
                    q_pad, gaps, prof_flat, tail_flat, off, C, G_loc,
                    toff, u_rows, interpret, gb, acc, cu, na, nb=nb)
            else:
                main, tail = data
                scores = _search_bin_stream_impl(q_pad, gaps, submat, main,
                                                 u_rows, interpret, gb, acc,
                                                 tail, cu, na, nb=nb)
            # tiled gather in mesh-axis order == the global slot order of
            # self.ids[L] (its group axis is sharded contiguously per
            # device), so the result aligns with ids_flat
            return jax.lax.all_gather(scores.reshape(-1), AXIS, tiled=True)

        data_spec = (P(AXIS), P(AXIS)) if precompute else \
            (P(None, AXIS), P(AXIS))
        if skip:
            local_fn = inner
            specs = (P(), P(), P(), P(), data_spec)
        else:
            local_fn = lambda q_pad, gaps, submat, data: \
                inner(q_pad, None, gaps, submat, data)
            specs = (P(), P(), P(), data_spec)
        fn = jax.jit(jax.shard_map(
            local_fn, mesh=self.mesh, in_specs=specs, out_specs=P(),
            check_vma=False))
        self._bin_fns[key] = fn
        return fn

    def score_all(self, query) -> np.ndarray:
        """Scores for every packed slot in ids_flat order (slots with
        id -1 are padding).  Not available in host_stream mode, where the
        full score vector never materialises device-side."""
        if self.mode == "host_stream":
            raise ValueError("score_all is not available in host_stream "
                             "mode (scores stream through the mesh in "
                             "slices)")
        q_pad = jnp.asarray(self._pad_query(query))
        nb = nb_or_none(np.asarray(query).size, q_pad.shape[0],
                        self.config.u_rows)
        q_args = (q_pad,) + (() if nb is None else (nb,))
        outs = []
        for L in self.db.bin_lengths:
            data = (self.prof_flat, self._bin_tail(L)) if \
                self.mode == "precompute" else self.seq_stacks[L]
            outs.append(self._bin_scores_fn(L, nb is not None)(
                *q_args, self.gaps, self.submat_dev, data))
        return np.concatenate([np.asarray(o) for o in outs]) if outs \
            else np.zeros(0, np.int32)

    @property
    def ids_flat(self) -> np.ndarray:
        """Sorted-sequence id per packed slot, bin-major then device-major
        within each bin — the slot order score_all returns (-1 = padding)."""
        if getattr(self, "_ids_flat", None) is None:
            parts = [np.asarray(self.ids[L]).reshape(-1)
                     for L in self.db.bin_lengths]
            self._ids_flat = np.concatenate(parts) if parts \
                else np.zeros(0, np.int32)
        return self._ids_flat

    def _pad_query(self, query):
        return pad_query(query, self.config)

    def _bin_tail(self, L):
        """Bin L's sharded tail-profile array (or None if L has no
        sub-128 tail chunk) — per-bin data for the shard_map programs."""
        tw = self.bin_geom[L][4]
        return self.tail_flats.get(tw) if tw is not None else None

    def _dispatch(self, query, query_title: str):
        """Enqueue one query's per-bin shard_map programs without blocking
        (see SearchEngine._dispatch); host_stream completes synchronously
        (its sweep is its own internal pipeline)."""
        t0 = time.perf_counter()
        q_pad = jnp.asarray(self._pad_query(query))
        nb = nb_or_none(np.asarray(query).size, q_pad.shape[0],
                        self.config.u_rows)
        k = min(self.config.top, max(self.db.n_seqs, 1))
        if self.mode == "host_stream":
            cs, ci, mom = self._host_stream_candidates(
                q_pad[None], k, None if nb is None else nb[None])
            scores, ids = self._merge_candidates(cs[0], ci[0], k)
            done = (scores, ids, tuple(float(m[0]) for m in mom))
            return (query, query_title, t0, k, None, None, done)
        fused = self.config.fused_dispatch
        if fused is None:
            # auto: one fused program + ONE collective per search (see
            # _fused_fn) whenever the whole database is device-resident;
            # never in interpret mode (a giant traced program is much
            # slower to build on CPU than its dispatch savings)
            fused = not self._interpret and bool(self.db.bin_lengths)
        if fused and self.db.bin_lengths:
            data = (self.prof_flat, self.tail_flats) if \
                self.mode == "precompute" else self.seq_stacks
            q_args = (q_pad,) + (() if nb is None else (nb,))
            arr = self._fused_fn(k, nb is not None)(
                *q_args, self.gaps, self.submat_dev, data,
                tuple(self.ids[L] for L in self.db.bin_lengths),
                self.lnl_table)
            return (query, query_title, t0, k, arr,
                    [int(arr.shape[-1])], None)
        cands = []
        for L in self.db.bin_lengths:
            data = (self.prof_flat, self._bin_tail(L)) if \
                self.mode == "precompute" else \
                self.seq_stacks[L]
            q_args = (q_pad,) + (() if nb is None else (nb,))
            cands.append(self._bin_fn(L, k, nb is not None)(
                *q_args, self.gaps, self.submat_dev,  # all bins dispatch
                data, self.ids[L], self.lnl_table))  # before any block
        # one device-side concat of every bin's packed [2, kk+2]
        # candidates -> ONE readback for the whole search (in _finish)
        arr = _concat_cands(*cands) if cands else None
        widths = [int(c.shape[-1]) for c in cands]
        return (query, query_title, t0, k, arr, widths, None)

    def _finish(self, pend) -> SearchResult:
        query, query_title, t0, k, arr, widths, done = pend
        if done is not None:
            scores, ids, mom = done
        else:
            if arr is not None:
                scores, ids, mom = _split_packed(np.asarray(arr), widths)
            else:
                scores = ids = np.zeros(0, np.int32)
                mom = (0.0, 0.0, 0.0, -1.0, 0.0, 0.0, -1.0)
            # deterministic merge: score descending, id ascending on ties —
            # identical to a global top_k over the slot-ordered flat scores
            scores, ids = self._merge_candidates(scores, ids, k)
        qlen = int(np.asarray(query).size)
        ev, bits, st = _result_stats(
            self.db, self._lnl_by_id, self._lnl_mom, self._len_hist,
            scores, ids, mom, qlen)
        elapsed = time.perf_counter() - t0
        self.metrics.add("search", elapsed)
        titles = [self.db.title_of(int(i)) for i in ids]
        return SearchResult(query_title=query_title, query_length=qlen,
                            scores=scores, seq_ids=ids, titles=titles,
                            elapsed=elapsed, evalues=ev, bit_scores=bits,
                            stats=st)

    def search(self, query, query_title: str = "query") -> SearchResult:
        return self._finish(self._dispatch(query, query_title))

    def search_stream(self, queries, titles=None):
        """Pipelined single-query stream: dispatch query i+1's shard_map
        programs before blocking on query i's candidate readback, with
        readback windowing (see SearchEngine.search_stream — identical
        results to sequential search; one transfer per
        stream_readback_window queries)."""
        from oswald_tpu.engine.search import _stack_packed
        titles = titles or [f"query{i}" for i in range(len(queries))]
        W = max(self.config.stream_readback_window, 1)
        results, prev = [], None
        for lo in range(0, len(queries), W):
            grp = [self._dispatch(q, t)
                   for q, t in zip(queries[lo:lo + W], titles[lo:lo + W])]
            arrs = [p[4] for p in grp]
            stacked = _stack_packed(*arrs) \
                if len(arrs) > 1 and all(a is not None for a in arrs) \
                else None
            if prev is not None:
                results.extend(self._finish_group(*prev))
            prev = (grp, stacked)
        if prev is not None:
            results.extend(self._finish_group(*prev))
        return results

    def _finish_group(self, grp, stacked):
        """Finish one readback window (see SearchEngine._finish_group)."""
        if stacked is None:
            return [self._finish(p) for p in grp]
        big = np.asarray(stacked)               # the ONE window readback
        return [self._finish((q, t, t0, k, big[i], widths, done))
                for i, (q, t, t0, k, _, widths, done) in enumerate(grp)]

    def _bin_batch_fn(self, L: int, k: int, skip: bool):
        """Compiled per-bin shard_map for a query batch: (q_batch, gaps,
        submat, data, ids) -> (scores[Q, kk'], ids[Q, kk']) replicated."""
        key = ("batch", L, k, skip)
        if key in self._bin_fns:
            return self._bin_fns[key]
        u_rows, interpret = self.config.u_rows, self._interpret
        gb, acc, cu, na = (self.config.group_block, self._acc,
                           self.config.col_unroll, self._noadj)
        precompute = self.mode == "precompute"
        geom = self.bin_geom.get(L)

        def inner(q_batch, nbs, gaps, submat, data, ids, lnl_table):
            if precompute:
                prof_flat, tail_flat = data
                off, C, G_loc, toff, _tw = geom
                scores = _search_bin_flat_batch_impl(
                    q_batch, gaps, prof_flat, tail_flat, off, C, G_loc,
                    toff, u_rows, interpret, gb, acc, cu, na, nbs=nbs)
            else:
                main, tail = data
                scores = _search_bin_stream_batch_impl(
                    q_batch, gaps, submat, main, u_rows, interpret, gb,
                    acc, tail, cu, na, nbs=nbs)
            Q = q_batch.shape[0]
            flat = scores.reshape(Q, -1)
            idsf = ids.reshape(-1)
            masked = jnp.where(idsf[None] >= 0, flat, -1)
            kk = min(k, flat.shape[1])
            loc_s, loc_i = jax.lax.top_k(masked, kk)        # [Q, kk]
            loc_ids = jnp.take(idsf, loc_i)
            all_s = jax.lax.all_gather(loc_s, AXIS, axis=1, tiled=True)
            all_ids = jax.lax.all_gather(loc_ids, AXIS, axis=1, tiled=True)
            top_s, top_i = jax.lax.top_k(all_s,
                                         min(k, all_s.shape[1]))
            # packed int32[2, Q, kk+2] incl. moments: one readback (_bin_fn)
            packed = jnp.stack(
                [top_s, jnp.take_along_axis(all_ids, top_i, axis=1)])
            return jnp.concatenate(
                [packed, _psum_moments_col(flat, idsf, lnl_table, 3)],
                axis=-1)

        data_spec = (P(AXIS), P(AXIS)) if precompute else \
            (P(None, AXIS), P(AXIS))
        if skip:
            local_fn = inner
            specs = (P(), P(), P(), P(), data_spec, P(AXIS), P())
        else:
            local_fn = lambda q_batch, gaps, submat, data, ids, \
                lnl_table: inner(q_batch, None, gaps, submat, data, ids,
                                 lnl_table)
            specs = (P(), P(), P(), data_spec, P(AXIS), P())
        fn = jax.jit(jax.shard_map(
            local_fn, mesh=self.mesh, in_specs=specs, out_specs=P(),
            check_vma=False))
        self._bin_fns[key] = fn
        return fn

    def warmup(self, max_query_len: int = 512, batch: bool = True,
               log=None, jobs: int = 1):
        """Precompile every (bin, padded-query-shape) program for queries
        up to max_query_len, in both kernel variants plus the common pack
        rungs — same serving-deployment contract as SearchEngine.warmup
        (shared warmup_engine).  Multi-process note: warmup is SPMD
        (collective programs), so every rank must call it identically —
        and jobs defaults to 1 here because a thread pool would enqueue
        collectives in a nondeterministic order across ranks (a deadlock
        on a real multi-process mesh); raise it only on single-process
        meshes.  Returns the padded lengths compiled."""
        if jobs > 1 and jax.process_count() > 1:
            # enforce the constraint, don't just document it: a thread
            # pool enqueues collective programs in a nondeterministic
            # order across ranks, which deadlocks a real multi-process
            # mesh
            raise ValueError(
                f"warmup(jobs={jobs}) is not allowed on a multi-process "
                f"mesh (process_count={jax.process_count()}): parallel "
                "warmup enqueues collective programs in different orders "
                "on different ranks, which deadlocks the pod — call "
                "warmup(jobs=1) on every rank instead")
        from oswald_tpu.engine.search import warmup_engine
        return warmup_engine(self, max_query_len, batch, log, jobs=jobs)

    def align(self, query, result: SearchResult):
        """Gapped alignments for a SearchResult's hits (host post-pass;
        see SearchEngine.align).  Multi-host note: every process holds the
        full packed db mmap, so any process may align, but only rank 0's
        output is normally printed."""
        from oswald_tpu.engine.align import align_hits
        return align_hits(self.db, query, result, self.submat,
                          self.config.open_gap, self.config.extend_gap)

    def _bin_pack_fn(self, L: int, k: int, q_segs: int, n_used: int,
                     skip: bool):
        """Compiled per-bin shard_map for a PACKED query batch: q_segs
        independent queries as row segments of one kernel pass per shard,
        laid out by a dynamic seg_map (mixed lengths; see
        engine.search._search_bin_flat_pack_impl / mixed_pack_plan).
        n_used: slot count the merge keeps (pow2 — slots beyond the bin's
        query count are uninitialised and must not reach top_k)."""
        key = ("pack", L, k, q_segs, n_used, skip)
        if key in self._bin_fns:
            return self._bin_fns[key]
        u_rows, interpret = self.config.u_rows, self._interpret
        gb, acc, cu, na = (self.config.group_block, self._acc,
                           self.config.col_unroll, self._noadj)
        precompute = self.mode == "precompute"
        geom = self.bin_geom.get(L)

        def inner(q_packed, seg_map, nb, gaps, submat, data, ids,
                  lnl_table):
            if precompute:
                prof_flat, tail_flat = data
                off, C, G_loc, toff, _tw = geom
                scores = _search_bin_flat_pack_impl(
                    q_packed, gaps, prof_flat, tail_flat, off, C, G_loc,
                    toff, q_segs, u_rows, interpret, gb, acc, cu, na,
                    seg_map=seg_map, nb=nb)
            else:
                main, tail = data
                scores = _search_bin_stream_pack_impl(
                    q_packed, gaps, submat, main, q_segs, u_rows,
                    interpret, gb, acc, tail, cu, na, seg_map=seg_map,
                    nb=nb)
            flat = scores.reshape(q_segs, -1)[:n_used]
            idsf = ids.reshape(-1)
            masked = jnp.where(idsf[None] >= 0, flat, -1)
            kk = min(k, flat.shape[1])
            loc_s, loc_i = jax.lax.top_k(masked, kk)
            loc_ids = jnp.take(idsf, loc_i)
            all_s = jax.lax.all_gather(loc_s, AXIS, axis=1, tiled=True)
            all_ids = jax.lax.all_gather(loc_ids, AXIS, axis=1, tiled=True)
            top_s, top_i = jax.lax.top_k(all_s, min(k, all_s.shape[1]))
            packed = jnp.stack(
                [top_s, jnp.take_along_axis(all_ids, top_i, axis=1)])
            return jnp.concatenate(
                [packed, _psum_moments_col(flat, idsf, lnl_table, 3)],
                axis=-1)

        data_spec = (P(AXIS), P(AXIS)) if precompute else \
            (P(None, AXIS), P(AXIS))
        if skip:
            local_fn = inner
            specs = (P(), P(), P(), P(), P(), data_spec, P(AXIS), P())
        else:
            local_fn = lambda q_packed, seg_map, gaps, submat, data, ids, \
                lnl_table: inner(q_packed, seg_map, None, gaps, submat,
                                 data, ids, lnl_table)
            specs = (P(), P(), P(), P(), data_spec, P(AXIS), P())
        fn = jax.jit(jax.shard_map(
            local_fn, mesh=self.mesh, in_specs=specs, out_specs=P(),
            check_vma=False))
        self._bin_fns[key] = fn
        return fn

    def search_many(self, queries, titles=None, batch: bool = True):
        """Search a list of queries; with batch=True same-padded-length
        queries run as one shard_map program per bin (see
        SearchEngine.search_many)."""
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
            # unbatched = pipelined single-query stream (search_stream):
            # identical results, readback hidden under the next compute
            return self.search_stream(queries, titles)

        t0 = time.perf_counter()
        results = [None] * len(queries)
        k = min(self.config.top, max(self.db.n_seqs, 1))
        # dispatch every group's programs before blocking on any readback
        # (overlaps dispatch/compile of group j+1 with group j's compute)
        pending = []

        # mixed-length packed bins (mixed_pack_plan is shared with the
        # single-chip engine so both pack identically — their results are
        # parity-tested against each other)
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
            nb_args = () if nb is None else (nb,)
            n2 = 1 << (len(sub) - 1).bit_length()
            cands = []
            for L in self.db.bin_lengths:
                data = (self.prof_flat, self._bin_tail(L)) if \
                    self.mode == "precompute" else \
                    self.seq_stacks[L]
                cands.append(self._bin_pack_fn(L, k, S, n2,
                                               nb is not None)(
                    q_packed, seg_map, *nb_args, self.gaps,
                    self.submat_dev, data, self.ids[L], self.lnl_table))
            pending.append((sub, cands, None, None, None))

        # unpacked leftovers: batched per padded-length class
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
        if self.mode == "host_stream" and class_args:
            # ONE streaming sweep of the database scores EVERY padded-
            # length class (each transferred slice is scanned by every
            # class's shard_map programs before the next replaces it);
            # the sweep's readback loop is its own backpressure, so these
            # candidates are already host-side
            keys = sorted(class_args)
            sweeps = self._host_stream_candidates_multi(
                [class_args[m] for m in keys], k)
            for m_pad, (cs, ci, mom) in zip(keys, sweeps):
                pending.append((by_len[m_pad], None, cs, ci, mom))
        for m_pad, idxs in by_len.items():
            if self.mode == "host_stream":
                continue
            qb, nbs = class_args[m_pad]
            cands = []
            for L in self.db.bin_lengths:
                data = (self.prof_flat, self._bin_tail(L)) if \
                    self.mode == "precompute" else self.seq_stacks[L]
                q_args = (qb,) + (() if nbs is None else (nbs,))
                cands.append(self._bin_batch_fn(L, k, nbs is not None)(
                    *q_args, self.gaps, self.submat_dev, data, self.ids[L],
                    self.lnl_table))
            pending.append((idxs, cands, None, None, None))

        for idxs, cands, scores, ids, mom in pending:
            if cands is not None:
                if cands:
                    # one device concat + ONE readback per padded-length
                    # group (see _bin_fn's packed layout)
                    arr = np.asarray(_concat_cands(*cands))
                    scores, ids, mom = _split_packed(
                        arr, [int(c.shape[-1]) for c in cands])
                else:
                    scores = np.zeros((len(idxs), 0), np.int32)
                    ids = np.zeros((len(idxs), 0), np.int32)
                    z = np.zeros(len(idxs), np.float64)
                    mom = (z, z, z, z - 1.0, z, z, z - 1.0)
            for row, qi in enumerate(idxs):
                srow, irow = self._merge_candidates(scores[row], ids[row], k)
                qlen = int(np.asarray(queries[qi]).size)
                ev, bits, st = _result_stats(
                    self.db, self._lnl_by_id, self._lnl_mom,
                    self._len_hist, srow, irow,
                    tuple(np.asarray(m)[row] if np.ndim(m) else m
                          for m in mom), qlen)
                results[qi] = SearchResult(
                    query_title=titles[qi], query_length=qlen,
                    scores=srow, seq_ids=irow,
                    titles=[self.db.title_of(int(j)) for j in irow],
                    elapsed=0.0, evalues=ev, bit_scores=bits, stats=st)
        elapsed = time.perf_counter() - t0
        self.metrics.add("search_batch", elapsed)
        # honest timing (see SearchResult.elapsed): the batch's real wall
        # time + batch_n, not a fictional per-query average
        for r in results:
            r.elapsed = elapsed
            r.batch_n = len(queries)
        return results
