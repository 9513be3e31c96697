"""Sharded rollout == single-device rollout, bit for bit, plus runner
contract checks (build-once caching, step/sample/sync).

Runs on the conftest-provided virtual 8-device CPU mesh — the same named-axis
sharding code path that compiles for any pod-slice shape (parallel/mesh.py).
Mirrors the reference's runner integration tests (pytest/test_vec_env.py
sequential-vs-async equivalence; include/runner.h:93-100 contract).
"""
import jax
import numpy as np
import pytest

from eldorado_tpu import vec
from eldorado_tpu.core import engine as E
from eldorado_tpu.parallel import mesh as M
from eldorado_tpu.parallel import runner as R

N = 16
STEPS = 30


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return M.make_mesh(8)


def _states():
    states = vec.vec_reset(5, N, 4, 2, 0, 100000)
    rngs = vec.sampler_init(11, N)
    return states, rngs


def test_sharded_rollout_matches_single_device(mesh8):
    states, rngs = _states()
    ss, rs, _stats = R.sharded_rollout(
        mesh8, M.shard_envs(states, mesh8),
        jax.device_put(rngs, M.env_sharding(mesh8)), STEPS)
    su, ru, _traj = vec.rollout(states, rngs, STEPS, auto_reset="step")
    assert np.array_equal(np.asarray(rs), np.asarray(ru))
    for name in E.EnvState._fields:
        assert np.array_equal(np.asarray(getattr(ss, name)),
                              np.asarray(getattr(su, name))), name


def test_sharded_stats_feed(mesh8):
    states, rngs = _states()
    # short max_steps forces episode ends -> nonzero psum'd stats
    # (max_steps counts *turns* — next_agent calls — not env steps, so a
    # cap of 8 turns ends within ~40-60 random steps)
    states = vec.vec_reset(5, N, 4, 2, 0, 8)
    _, _, stats = R.sharded_rollout(
        mesh8, M.shard_envs(states, mesh8),
        jax.device_put(rngs, M.env_sharding(mesh8)), 100)
    assert int(stats["episodes"]) > 0
    assert int(stats["steps"]) == 100


def test_sharded_kernel_rollout_matches_single_device():
    """Per-shard kernel scans + queued resets == the single-device kernel
    chunked path, bit for bit. N=32 over a 4-device mesh with block=8
    makes every local queue (Q = n_local = 8) big enough to hold all
    local finishers, so both paths reset the same env set at the same
    chunk boundary."""
    mesh4 = M.make_mesh(4)
    N2 = 32
    states = vec.vec_reset(5, N2, 4, 2, 0, 10)   # short games: resets fire
    rngs = vec.sampler_init(11, N2)
    ss, rs, eps = R.sharded_kernel_rollout(
        mesh4, states, rngs, 60, chunk=10, block=8)
    su, ru, eps_u = vec.rollout_chunked(
        states, rngs, 60, chunk=10, backend="kernel", block=8)
    assert eps_u > 0, "workload must exercise the reset queue"
    assert eps == eps_u
    assert np.array_equal(np.asarray(rs), np.asarray(ru))
    for name in E.EnvState._fields:
        assert np.array_equal(np.asarray(getattr(ss, name)),
                              np.asarray(getattr(su, name))), name


def test_sharded_exact_matches_single_device():
    """exact mode (frozen finishers, dead-step accounting) over the mesh
    == the single-device exact path, bit for bit, including the
    dead-step count."""
    mesh4 = M.make_mesh(4)
    N2 = 32
    states = vec.vec_reset(5, N2, 4, 2, 0, 10)
    rngs = vec.sampler_init(11, N2)
    ss, rs, eps, dead = R.sharded_kernel_rollout(
        mesh4, states, rngs, 60, chunk=10, block=8,
        exact=True)
    su, ru, eps_u, dead_u = vec.rollout_chunked(
        states, rngs, 60, chunk=10, backend="kernel", block=8, exact=True)
    assert eps == eps_u > 0
    assert dead == dead_u > 0
    assert np.array_equal(np.asarray(rs), np.asarray(ru))
    for name in E.EnvState._fields:
        assert np.array_equal(np.asarray(getattr(ss, name)),
                              np.asarray(getattr(su, name))), name


def test_runner_rollout_chunked():
    mesh4 = M.make_mesh(4)
    runner = R.ShardedRunner(mesh4, 32)
    runner.reset(seed=3, n_pieces=2, max_steps=10)
    stats = runner.rollout_chunked(80, chunk=10, block=8)
    assert stats["steps"] == 80
    assert stats["episodes"] > 0
    runner.sync()


def test_runner_contract_and_no_retrace(mesh8):
    runner = R.ShardedRunner(mesh8, N)
    runner.reset(seed=3, n_pieces=2, max_steps=100000)

    # sample/step/sync surface (runner.h:93-100)
    a0 = np.asarray(runner.sample())
    assert a0.shape == (N, 5)
    runner.step()
    runner.sync()
    runner.step_sync()

    before = R._trace_count[0]
    for _ in range(3):
        runner.sample()
        runner.step_sync()
    assert R._trace_count[0] == before, "repeat step/sample retraced"

    # STEPS reuses the program test_sharded_rollout_matches_single_device
    # already built — the fused scan is the suite's biggest compile and
    # building a second length here adds nothing to the contract check
    stats = runner.rollout(STEPS)
    before = R._trace_count[0]
    runner.rollout(STEPS)
    assert R._trace_count[0] == before, "repeat rollout retraced"
    assert int(stats["steps"]) == STEPS


def test_runner_matches_vec_env(mesh8):
    """sample()+step() through the runner == VecEnv.sample()+step()."""
    runner = R.ShardedRunner(mesh8, N)
    runner.reset(seed=9, n_pieces=2)

    env = vec.VecEnv(N)
    env.reset(seed=9, n_pieces=2)

    for _ in range(20):
        a1 = np.asarray(runner.sample())
        a2 = np.asarray(env.sample())
        assert np.array_equal(a1, a2)
        runner.step_sync()
        env.step(a2)
    for name in E.EnvState._fields:
        assert np.array_equal(np.asarray(getattr(runner.states, name)),
                              np.asarray(getattr(env.states, name))), name


def test_sharded_stream_feed_matches_single_device():
    """The multi-chip learner feed: per-shard on-device record folds ==
    the single-device stream_rollout fold, bit for bit — stats AND an
    int32 sum-checksum over every record word (order-independent, so
    shard structure cannot hide a record difference). Full 40-word
    records with mid-run queued auto-resets."""
    import jax.numpy as jnp

    from eldorado_tpu import stream as S

    mesh4 = M.make_mesh(4)
    N2 = 32
    states = vec.vec_reset(5, N2, 4, 2, 0, 10)   # short games: resets fire
    rngs = vec.sampler_init(11, N2)

    def fold(carry, traj):
        stats = S.device_stats_fn(carry[0], traj)
        chk = carry[1] + jnp.sum(traj.astype(jnp.int32))
        return (stats, chk)

    init = (S.device_stats_init(), jnp.int32(0))
    ss, rs, eps, carry = R.sharded_stream_rollout(
        mesh4, states, rngs, 60, chunk=10, block=8,
        record="full", device_fn=fold, device_carry=init)
    su, ru, eps_u, sink = S.stream_rollout(
        states, rngs, 60, 10, block=8,
        deliver="device", record="full", device_fn=fold,
        device_carry=init)
    assert eps == eps_u > 0
    assert np.array_equal(np.asarray(rs), np.asarray(ru))
    for name in E.EnvState._fields:
        assert np.array_equal(np.asarray(getattr(ss, name)),
                              np.asarray(getattr(su, name))), name
    # combine per-shard rows with order-independent reductions
    (steps_r, eps_r, ret_r, hist_r), chk_r = carry
    (steps_1, eps_1, ret_1, hist_1), chk_1 = sink
    assert int(np.sum(steps_r)) == int(steps_1)
    assert int(np.sum(eps_r)) == int(eps_1)
    assert float(np.sum(ret_r)) == float(ret_1)   # exact: small-int f32
    assert np.array_equal(np.sum(np.asarray(hist_r), axis=0),
                          np.asarray(hist_1))
    assert int(np.sum(np.asarray(chk_r, dtype=np.int64)) & 0xFFFFFFFF) \
        == int(np.int64(chk_1) & 0xFFFFFFFF)


def test_runner_stream_rollout():
    from eldorado_tpu import stream as S

    mesh4 = M.make_mesh(4)
    runner = R.ShardedRunner(mesh4, 32)
    runner.reset(seed=3, n_pieces=2, max_steps=10)
    out = runner.stream_rollout(80, chunk=10, block=8)
    assert out["steps"] == 80 and out["episodes"] > 0
    steps_rows = np.asarray(out["carry"][0])
    assert int(steps_rows.sum()) == 80 * 32
    runner.sync()


def test_sharded_mixed_params_matches_single_device():
    """Heterogeneous per-env reset parameters survive the sharded path:
    the per-shard kernel scans + queued resets on a mixed
    (difficulty, n_pieces) batch are bit-identical to the single-device
    kernel path, and every env keeps its own parameters through mid-run
    auto-resets."""
    mesh4 = M.make_mesh(4)
    N2 = 32
    seeds = np.arange(N2, dtype=np.uint32) + 5
    diffs = np.array([0, 1, 2, 0] * 8, np.int32)
    pieces = np.array([1, 2, 3, 2] * 8, np.int32)
    states = vec.vec_reset_varied(seeds, 4, pieces, diffs, 10)
    rngs = vec.sampler_init(11, N2)
    ss, rs, eps = R.sharded_kernel_rollout(
        mesh4, states, rngs, 60, chunk=10, block=8)
    su, ru, eps_u = vec.rollout_chunked(
        states, rngs, 60, chunk=10, backend="kernel", block=8)
    assert eps == eps_u > 0
    for name in E.EnvState._fields:
        assert np.array_equal(np.asarray(getattr(ss, name)),
                              np.asarray(getattr(su, name))), name
    assert np.array_equal(np.asarray(ss.difficulty), diffs)
    assert np.array_equal(np.asarray(ss.n_pieces), pieces)
