"""The Triton-route sw_chunk, the platform seam, the compile-cache rules and
the planner's device-memory rule.

On the CPU the kernel runs in Pallas interpret mode; each parity case scans
one small bin through the engine's stream scan and compares sampled lanes
with the anti-diagonal oracle exactly (utils.parity.kernel_parity).  The
compiled kernel's parity runs only on a GPU (`-m gpu`).
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from oswald_tpu.core import sw_score_numpy
from oswald_tpu.kernels import sw_chunk, build_profile, kernel_interpret
from oswald_tpu.submat import get_submat
from oswald_tpu.utils.parity import kernel_parity, KERNEL_CASES


def _case(L, qlens, m_pad, acc="float32", matrix="blosum62", gaps=(10, 2),
          noadj=True, G=1):
    return dict(L=L, G=G, qlens=tuple(qlens), m_pad=m_pad, acc=acc,
                matrix=matrix, gaps=gaps, noadj=noadj)


# each id names what the case adds: accumulator, E-update, the chunk tail
# (L % 128 of 32/64/96, or none), the dummy-row-block skip (qlen short of
# m_pad), packed segments with a seg_map, a negative-min matrix
PARITY_CASES = {
    "int32-noadj-full": _case(128, (64,), 64, acc="int32"),
    "float32-classical-tail32": _case(160, (64,), 64, noadj=False),
    "int32-classical-tail64": _case(192, (48,), 64, acc="int32",
                                    noadj=False),
    "float32-tail96-skip": _case(96, (37,), 64),
    "segmap-packed-3": _case(224, (12, 9, 20), 64, G=2),
    "pam30-7-1-skip": _case(160, (50,), 64, matrix="pam30", gaps=(7, 1)),
}


@pytest.mark.parametrize("case", list(PARITY_CASES.values()),
                         ids=list(PARITY_CASES))
def test_sw_chunk_interpret_parity(case):
    out = kernel_parity([case], n_sample=48, interpret=True)
    assert out == {"kernel_parity": "ok", "checks": len(case["qlens"])}, out


def test_sw_chunk_matches_scalar_oracle(rng):
    """One chunk, a handful of lanes, against the scalar-loop oracle (the
    auditable ground truth, independent of the anti-diagonal scan)."""
    from oswald_tpu.alphabet import DUMMY
    sm = get_submat("blosum62")
    G, W, m = 1, 128, 16
    seq = rng.integers(0, 23, (G, W, 8, 128)).astype(np.int8)
    seq[:, 100:, 0, :4] = DUMMY                   # four shorter subjects
    q = rng.integers(0, 23, m).astype(np.int32)
    acc = jnp.int32
    colH = jnp.zeros((G, m, 8, 128), acc)
    sc, _, _ = sw_chunk(jnp.asarray(q), jnp.asarray([10, 2], jnp.int32),
                        build_profile(jnp.asarray(seq), sm), colH,
                        jnp.zeros((G, m // 8, 8, 128), acc), colH,
                        jnp.zeros((G, 8, 128), acc), u_rows=8,
                        acc_dtype=acc, interpret=True)
    for lane in range(6):
        b = seq[0, :, 0, lane]
        b = b[b != DUMMY]
        assert int(sc[0, 0, lane]) == sw_score_numpy(q, b, sm, 10, 2)


@pytest.mark.parametrize("group_block,sublane_block", [(1, 1), (2, 2)])
def test_launch_geometry_changes_no_score(rng, monkeypatch, group_block,
                                          sublane_block):
    """The compiled route's launch geometry (one sublane per program,
    group_block groups per thread), run here in interpret mode, scores
    exactly like the interpret default (a whole group per program)."""
    import oswald_tpu.kernels.sw_lanes as sw
    sm = get_submat("pam30")
    G, m = 2, 32
    seq = rng.integers(0, 24, (G, 64, 8, 128)).astype(np.int8)
    prof = build_profile(jnp.asarray(seq), sm)
    q = jnp.asarray(rng.integers(0, 23, m), jnp.int32)
    acc = jnp.float32
    colH = jnp.asarray(rng.integers(0, 30, (G, m, 8, 128)), acc)
    colE = jnp.asarray(rng.integers(0, 20, (G, m, 8, 128)), acc)
    colHd = jnp.asarray(rng.integers(0, 30, (G, m // 8, 8, 128)), acc)
    s_in = jnp.asarray(rng.integers(0, 40, (G, 8, 128)), acc)
    args = (q, jnp.asarray([7, 1], jnp.int32), prof, colH, colHd, colE, s_in)
    kw = dict(u_rows=8, acc_dtype=acc, interpret=True, noadj=True,
              n_blocks=jnp.asarray(3, jnp.int32))
    want = sw_chunk(*args, **kw)
    # the sublane block is a module constant read at trace time: call the
    # unjitted function so the patched value is traced
    monkeypatch.setattr(sw, "INTERPRET_SUBLANE_BLOCK", sublane_block)
    got = sw.sw_chunk.__wrapped__(*args, group_block=group_block, **kw)
    rows = 3 * 8                        # colH/colE past n_blocks: undefined
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(g)[:, :rows],
                                      np.asarray(w)[:, :rows])


def test_sw_chunk_rejects_bad_geometry():
    acc = jnp.float32
    G, m = 3, 16
    args = (jnp.zeros(m, jnp.int32), jnp.zeros(2, jnp.int32),
            jnp.zeros((G, 24, 1024, 128), jnp.int8),
            jnp.zeros((G, m, 8, 128), acc), jnp.zeros((G, 2, 8, 128), acc),
            jnp.zeros((G, m, 8, 128), acc), jnp.zeros((G, 8, 128), acc))
    with pytest.raises(ValueError, match="group_block"):
        sw_chunk(*args, group_block=3, interpret=True)
    with pytest.raises(ValueError, match="col_unroll"):
        sw_chunk(*args, col_unroll=3, interpret=True)


def test_build_profile_is_the_table_lookup(rng):
    sm = get_submat("blosum62")
    db = rng.integers(0, 24, (2, 32, 8, 128)).astype(np.int8)
    prof = np.asarray(build_profile(jnp.asarray(db), sm))
    assert prof.shape == (2, 24, 32 * 8, 128) and prof.dtype == np.int8
    flat = db.reshape(2, 32 * 8, 128)
    want = np.asarray(sm, np.int8)[:, flat].transpose(1, 0, 2, 3)
    np.testing.assert_array_equal(prof, want)


# --- the platform seam ----------------------------------------------------

def test_seam_cpu_interprets():
    assert kernel_interpret("cpu") is True
    assert kernel_interpret() is True          # the tests' own platform


def test_seam_gpu_compiles(monkeypatch):
    """The seam only answers; it changes no JAX setting."""
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    assert kernel_interpret("gpu") is False
    assert updates == []


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_seam_other_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no Smith-Waterman kernel"):
        kernel_interpret(platform)


def test_engine_takes_the_seam(monkeypatch):
    """SearchConfig resolves the kernel mode from the first device's
    platform once; an explicit interpret=True stays allowed."""
    from oswald_tpu.engine import SearchConfig
    import oswald_tpu.kernels.sw_lanes as sw
    fake = [types.SimpleNamespace(platform="gpu")]
    monkeypatch.setattr(sw.jax, "devices", lambda *a: fake)
    assert SearchConfig().resolved_interpret() is False
    assert SearchConfig(interpret=True).resolved_interpret() is True
    fake[0].platform = "rocm"
    with pytest.raises(RuntimeError):
        SearchConfig().resolved_interpret()


# --- compile-cache directory rules ----------------------------------------

@pytest.fixture
def cache_mod(monkeypatch):
    import oswald_tpu.utils.compile_cache as cc
    updates = {}
    monkeypatch.setattr(cc, "_enabled_dir", None)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    cc.updates = updates
    return cc


def test_cache_env_dir_wins(cache_mod, monkeypatch, tmp_path):
    env = tmp_path / "env"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(env))
    assert cache_mod.enable_compile_cache(str(tmp_path / "flag")) == str(env)
    assert "jax_compilation_cache_dir" not in cache_mod.updates
    assert not (tmp_path / "flag").exists()
    assert cache_mod.default_cache_dir() == str(env)


def test_cache_default_is_inside_checkout(cache_mod, monkeypatch):
    import os
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert cache_mod.default_cache_dir() == want
    assert cache_mod.enable_compile_cache() == want
    assert cache_mod.updates["jax_compilation_cache_dir"] == want


def test_cache_flag_dir_without_env(cache_mod, monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = str(tmp_path / "flag")
    assert cache_mod.enable_compile_cache(d) == d
    assert cache_mod.updates["jax_compilation_cache_dir"] == d


@pytest.mark.parametrize("env_set", [False, True])
def test_no_compile_cache_flag_only_without_env(cache_mod, monkeypatch,
                                                tmp_path, env_set):
    from oswald_tpu.cli.main import _enable_cache
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    args = types.SimpleNamespace(no_compile_cache=True, compile_cache=None)
    assert _enable_cache(args) == (str(tmp_path) if env_set else None)


# --- the planner's device memory ------------------------------------------

def _dev(platform, stats):
    return types.SimpleNamespace(platform=platform, device_kind="test",
                                 memory_stats=lambda: stats)


def test_planner_gpu_reads_bytes_limit():
    from oswald_tpu.engine.planner import device_hbm_bytes
    assert device_hbm_bytes(_dev("gpu", {"bytes_limit": 60 << 30})) == \
        60 << 30


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_planner_gpu_without_limit_raises(stats):
    from oswald_tpu.engine.planner import device_hbm_bytes
    with pytest.raises(RuntimeError, match="no device memory limit"):
        device_hbm_bytes(_dev("gpu", stats))


def test_planner_cpu_default():
    from oswald_tpu.engine.planner import device_hbm_bytes, \
        CPU_DEFAULT_BYTES
    assert device_hbm_bytes(_dev("cpu", None)) == CPU_DEFAULT_BYTES


# --- the compiled kernel, on a GPU only -----------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=[f"L{c['L']}-m{c['m_pad']}-{len(c['qlens'])}q"
                              for c in KERNEL_CASES])
def test_sw_chunk_compiled_parity(gpu, case):
    out = kernel_parity([case], interpret=False)
    assert out["kernel_parity"] == "ok", out
