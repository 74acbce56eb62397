"""Device-memory capacity planner: pick the device data mode a database
fits in.

The analog of the reference's device-memory auto-tune
(`max_chunk_size = min(max_chunk_size, 0.8 * global_mem / SUBMAT_ROWS)`,
/root/reference/host/src/utils.c:162-168) and its bounded-chunk streaming
search (FPGAsearch.c:180-237).  The reference always streams host->device
chunks; here the planner picks the *most resident* mode that fits:

  precompute   24x int8 score profiles resident in device memory (no
               per-query profile build).  Costs 24 bytes/padded residue.
  stream       packed residues resident; profiles rebuilt per chunk
               inside the scan.  1 byte/padded residue.
  host_stream  packed residues stay host-side (mmap); group slices are
               transferred per search, double-buffered under compute.
               Device cost is two slices + scan state, independent of
               database size — the mode for databases larger than device
               memory.

The ladder is ordered by DATABASE residency plus the scan state of the
WORST query the engine is configured to accept (SearchConfig.
max_query_len, default titin 5478): a database the planner declares
resident can never run out of memory at query time, because queries past
the cap are rejected up front (engine.pad_query).  Speed does not move
the choice; whether precompute pays for its 24x residency on the GPU is
not measured yet.
"""

import dataclasses

import jax

# Documented stand-in for the CPU backend, which reports no device memory
# limit (tests, rehearsals).  A GPU must report its own; see
# device_hbm_bytes.  Overridable per engine via
# SearchConfig.hbm_budget_bytes.
CPU_DEFAULT_BYTES = 16 << 30
# Fraction of HBM the planner will commit to database residency — the
# reference reserves the same 0.8 headroom (utils.c:162-168); the rest
# covers XLA scratch, fragmentation and transient transfers.
SAFETY_FRACTION = 0.8
# Longest query the engine plans (and budgets scan state) for by default:
# titin, 5478 residues — the same cap the reference hardwires as its FPGA
# channel depth (/root/reference/device/sw.cl:5).  Configurable per engine
# via SearchConfig.max_query_len; queries longer than the configured cap
# are REJECTED with a clear error instead of risking a query-time OOM
# (the reference's chunk cap likewise never OOMs by construction,
# utils.c:162-168).
MAX_QUERY_LEN_DEFAULT = 5478
ALPHA_ROWS = 24
GROUP_LANES = 1024
ACC_BYTES = 4


def padded_query_rows(max_query_len: int, pad_quantum: int = 64,
                      batch_pad_quantum: int = 64, u_rows: int = 8,
                      pack_rows: int = 1024) -> int:
    """WORST-CASE padded row count the engine can allocate scan state for
    at this max query length — the same adaptive quantum formula as
    engine.pad_query (quantum = max(configured quantum, u_rows,
    2^floor(log2(m))/8)), without importing the engine (which imports
    this module).  The engine's effective quanta are passed in (an engine
    configured with query_pad_quantum=1024 pads titin to 6144 rows, not
    the default formula's 5632 — budgeting the default would re-open the
    query-time-OOM window the residency guarantee closes); the packed
    batch path's row budget (batch_query_pack_rows, bounded by
    mixed_pack_plan to whole multiples of u_rows) also caps scan state,
    so the max over all three paths is returned."""
    m = max(int(max_query_len), 1)
    adaptive = (1 << max(m.bit_length() - 1, 0)) // 8

    def rows(base):
        quantum = max(int(base), int(u_rows), adaptive)
        return -(-m // quantum) * quantum

    worst = max(rows(pad_quantum), rows(batch_pad_quantum))
    if pack_rows and pack_rows // max(u_rows, 1) >= 2:
        # packed bins hold up to pack_rows rows (pow2-laddered, never past
        # the cap) when at least two row blocks fit — see mixed_pack_plan;
        # a short-max_query_len engine can still fill a full pack with
        # many short queries, so the cap itself is the worst case
        worst = max(worst, int(pack_rows))
    return worst


def device_hbm_bytes(device=None) -> int:
    """Device memory the process may use: `memory_stats()["bytes_limit"]`
    (on a GPU, JAX's reservation of the card).  The CPU backend reports
    none and gets CPU_DEFAULT_BYTES; any other device without a limit is
    an error, never a guess."""
    if device is None:
        device = jax.devices()[0]
    try:
        stats = device.memory_stats()
    except Exception:       # noqa: BLE001 — a backend without the query
        stats = None
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    if device.platform == "cpu":
        return CPU_DEFAULT_BYTES
    raise RuntimeError(
        f"{device.device_kind} ({device.platform}) reports no device memory "
        f"limit; set SearchConfig.hbm_budget_bytes (--hbm-budget-mb)")


def db_padded_bytes(db) -> int:
    """Packed residue bytes (1 byte each) over all bins, padding included."""
    total = 0
    for L in db.bin_lengths:
        G = db.bins[L]["seq"].shape[0]
        total += G * L * GROUP_LANES
    return total


def _scan_state_bytes(db, n_devices: int, plan_rows: int) -> int:
    """colH + colE for the largest per-device bin share (2 arrays, double
    counted for XLA's scan in/out copies), sized for a plan_rows-row
    query — the worst case the engine is configured to accept."""
    worst = 0
    for L in db.bin_lengths:
        G = -(-db.bins[L]["seq"].shape[0] // n_devices)
        worst = max(worst, G)
    return 4 * ACC_BYTES * worst * plan_rows * GROUP_LANES


@dataclasses.dataclass
class Plan:
    mode: str                 # "precompute" | "stream" | "host_stream"
    db_bytes: int             # padded residue bytes (per device share)
    profile_bytes: int        # precompute-mode residency (per device share)
    state_bytes: int          # transient scan-state estimate
    budget_bytes: int         # SAFETY_FRACTION * HBM
    max_query_len: int = MAX_QUERY_LEN_DEFAULT   # state budgeted for this

    def describe(self) -> str:
        gib = 1 << 30
        msg = (f"profile_mode={self.mode} (planner: db "
               f"{self.db_bytes / gib:.2f} GiB packed, profiles "
               f"{self.profile_bytes / gib:.2f} GiB, scan state "
               f"{self.state_bytes / gib:.2f} GiB at max query "
               f"{self.max_query_len}, HBM budget "
               f"{self.budget_bytes / gib:.2f} GiB)")
        if self.mode != "precompute":
            # the degrade is deliberate and visible: faster residency
            # does not fit WITH the configured worst-case query's scan
            # state — a smaller --max-query-len buys residency back
            msg += (" — degraded from precompute: full residency + "
                    "worst-case query state exceeds the budget; lower "
                    "--max-query-len to restore it")
        return msg


def plan_profile_mode(db, hbm_bytes: int | None = None,
                      n_devices: int = 1,
                      max_query_len: int | None = None,
                      config=None) -> Plan:
    """Pick the fastest data mode whose residency fits the HBM budget.

    n_devices: the database's group axis shards evenly across the mesh, so
    each device holds a 1/n share (distributed engines pass their mesh
    size).  max_query_len: the longest query the engine will accept
    (SearchConfig.max_query_len); scan state is budgeted for it so a
    long query can never OOM a database the planner declared resident.
    config: the engine's SearchConfig, whose pad quanta / pack cap set the
    TRUE worst-case padded row count (see padded_query_rows)."""
    mq = max_query_len if max_query_len is not None else \
        MAX_QUERY_LEN_DEFAULT
    budget = int(SAFETY_FRACTION * (hbm_bytes if hbm_bytes is not None
                                    else device_hbm_bytes()))
    share = -(-db_padded_bytes(db) // max(n_devices, 1))
    if config is not None:
        rows = padded_query_rows(
            mq, pad_quantum=config.query_pad_quantum,
            batch_pad_quantum=config.batch_query_pad_quantum,
            u_rows=config.u_rows, pack_rows=config.batch_query_pack_rows)
    else:
        rows = padded_query_rows(mq)
    state = _scan_state_bytes(db, max(n_devices, 1), rows)
    prof = ALPHA_ROWS * share
    if prof + state <= budget:
        mode = "precompute"
    elif share + state <= budget:
        mode = "stream"
    else:
        mode = "host_stream"
    return Plan(mode=mode, db_bytes=share, profile_bytes=prof,
                state_bytes=state, budget_bytes=budget, max_query_len=mq)
