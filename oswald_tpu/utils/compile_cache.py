"""Persistent compiled-program cache: the reference ships its compiled
kernel and loads it at startup — `PRECOMPILED_BINARY`
(/root/reference/host/src/utils.h:17) via `createProgramFromBinary`
(/root/reference/common/src/AOCL_Utils.cpp:365, utils.c:144-150) — so a
deployment never pays FPGA synthesis.  The equivalent here is JAX's
persistent compilation cache: every executable the engine compiles
(per-bin scans with their Triton kernels, packed-batch rungs, top-k) is
written to a directory keyed by (HLO, compile options, device kind), and
any later process — a serve restart, the next bench run — loads it
instead of recompiling.

Where the cache lives, first rule that applies:
  1. JAX_COMPILATION_CACHE_DIR, when set: JAX reads it itself and this
     module configures no other directory (--compile-cache and
     --no-compile-cache are ignored);
  2. the directory given (--compile-cache DIR); --no-compile-cache
     disables the cache;
  3. a fixed path inside the checkout, `<repo>/.jax_cache` (JAX's cache
     key includes the directory, so a fixed path is what lets a later
     process hit).

Enabled by default by every entry point (CLI search/serve/tune, bench.py).
"""

import os
import sys

_ENV = "JAX_COMPILATION_CACHE_DIR"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_enabled_dir: str | None = None


def default_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else `<repo>/.jax_cache`."""
    return os.environ.get(_ENV) or os.path.join(_REPO, ".jax_cache")


def enable_compile_cache(cache_dir: str | None = None,
                         quiet: bool = False) -> str | None:
    """Turn on JAX's persistent compilation cache (see the module
    docstring for where it lives).  Idempotent; safe to call before or
    after jax initialises (config updates apply to subsequent compiles).
    Returns the directory in use, or None when it cannot be created."""
    global _enabled_dir
    env = os.environ.get(_ENV)
    if env:
        cache_dir = env                   # JAX's own setting; set no other
    elif cache_dir is None:
        cache_dir = default_cache_dir()
    if _enabled_dir == cache_dir:
        return _enabled_dir
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError as e:
        if not quiet:
            print(f"oswald-tpu: compile cache disabled ({e})",
                  file=sys.stderr)
        return None
    import jax
    if not env:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache EVERY program: a search compiles many small-to-medium
    # programs, and the default 1 s floor would skip most of them
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _enabled_dir = cache_dir
    if not quiet:
        print(f"oswald-tpu: compile cache at {cache_dir}", file=sys.stderr)
    return cache_dir


def pack_cache(tar_path: str, cache_dir: str | None = None) -> dict:
    """Archive a warmed compile cache into one gzip tarball — the analog
    of SHIPPING the reference's precompiled `sw.aocx`: a fresh deployment
    unpacks the artifact and skips the cold warmup ladder.  JAX's
    cache-key fingerprint includes the configured cache directory, so
    unpack into the SAME path on the target machine: the same
    JAX_COMPILATION_CACHE_DIR, or a checkout at the same location (the
    default `<repo>/.jax_cache`); anywhere else every program recompiles.
    Entries are also specific to the device kind and the JAX version.
    Returns {"entries", "bytes", "tar"}."""
    import tarfile
    d = cache_dir or _enabled_dir or default_cache_dir()
    if not os.path.isdir(d):
        raise FileNotFoundError(
            f"compile cache directory {d} does not exist — run a search/"
            "serve/bench once (with the cache enabled) to populate it")
    n = size = 0
    with tarfile.open(tar_path, "w:gz") as tf:
        for root, _, files in os.walk(d):
            for f in sorted(files):
                p = os.path.join(root, f)
                tf.add(p, arcname=os.path.relpath(p, d))
                size += os.path.getsize(p)
                n += 1
    return {"entries": n, "bytes": size, "tar": tar_path}


def unpack_cache(tar_path: str, cache_dir: str | None = None,
                 overwrite: bool = False) -> dict:
    """Pre-seed a compile cache from a `pack_cache` tarball.  Existing
    entries are kept (overwrite=False) — cache files are content-keyed,
    so a collision means the entry is already present.  Returns
    {"extracted", "skipped", "dir"}."""
    import tarfile
    d = cache_dir or _enabled_dir or default_cache_dir()
    os.makedirs(d, exist_ok=True)
    extracted = skipped = 0
    with tarfile.open(tar_path, "r:*") as tf:
        for m in tf.getmembers():
            if not m.isfile():
                continue
            # refuse path escapes (the tarball may come from elsewhere)
            dest = os.path.realpath(os.path.join(d, m.name))
            if not dest.startswith(os.path.realpath(d) + os.sep):
                raise ValueError(f"unsafe path in cache tar: {m.name!r}")
            if os.path.exists(dest) and not overwrite:
                skipped += 1
                continue
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            src = tf.extractfile(m)
            with open(dest, "wb") as out:
                out.write(src.read())
            extracted += 1
    return {"extracted": extracted, "skipped": skipped, "dir": d}


def cache_stats(cache_dir: str | None = None) -> dict:
    """Entry count and total bytes of a cache directory (for `info` and
    deployment priming checks)."""
    d = cache_dir or _enabled_dir or default_cache_dir()
    n = size = 0
    if os.path.isdir(d):
        for root, _, files in os.walk(d):
            for f in files:
                try:
                    size += os.path.getsize(os.path.join(root, f))
                    n += 1
                except OSError:
                    pass
    return {"dir": d, "entries": n, "bytes": size}
