"""Multi-process bootstrap: `jax.distributed` initialization.

The reference never crosses a process boundary (its 16 FPGAs hang off one
host, /root/reference/host/src/FPGAsearch.c:132-239); a mesh that spans
hosts needs a distributed runtime bring-up.  This is the one place that
touches `jax.distributed` — everything downstream (process_group_slice,
make_array_from_process_local_data in dist/shard.py) only reads
`jax.process_index()`/`jax.process_count()`.

One process per host: each process drives all of its host's GPUs (a JAX
process reserves most of every card it opens, so two processes must not
share a card; pass `local_device_ids` to split a host's cards between
processes instead).

    from oswald_tpu.dist import bootstrap
    bootstrap()                      # cluster auto-discovery (SLURM, ...)
    bootstrap("host0:8476", 2, rank) # explicit (tests, bare metal)

then build the mesh/engine exactly as in the single-process case — the
engine code is process-count-agnostic SPMD.
"""

import jax

_bootstrapped = False


def is_bootstrapped() -> bool:
    return _bootstrapped


def bootstrap(coordinator_address: str | None = None,
              num_processes: int | None = None,
              process_id: int | None = None,
              local_device_ids=None) -> tuple[int, int]:
    """Initialize the distributed runtime; returns (process_id, count).

    All-None arguments: `jax.distributed.initialize` discovers the
    coordinator and process layout from the cluster environment (SLURM,
    Open MPI, ...); on single-process runs with no cluster environment
    this call is a no-op (initialize would fail, and a lone process needs
    no runtime).  Explicit arguments are for bare-metal
    clusters and multi-process tests.  Idempotent: a second call returns
    the existing layout.
    """
    global _bootstrapped
    if _bootstrapped:
        return jax.process_index(), jax.process_count()
    explicit = coordinator_address is not None or \
        num_processes is not None or process_id is not None
    if not explicit:
        # IMPORTANT: probe NOTHING on jax before initialize() — even
        # jax.default_backend() initializes the XLA backend, after which
        # jax.distributed.initialize() refuses to run.  Let initialize()
        # itself do the cluster auto-discovery; outside a cluster
        # environment it raises and we stay single-process.
        try:
            jax.distributed.initialize()
        except Exception:
            return jax.process_index(), jax.process_count()
    else:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id,
                                   local_device_ids=local_device_ids)
    _bootstrapped = True
    return jax.process_index(), jax.process_count()


def shutdown() -> None:
    """Tear down the distributed runtime (test hygiene; optional in apps)."""
    global _bootstrapped
    if _bootstrapped:
        jax.distributed.shutdown()
        _bootstrapped = False
