"""Coverage for the user-facing layer above the engine: VecEnv, chunked
rollouts, the city_of_gold compat mirror, the native packer/ring, and the
renderer.  Mirrors the reference's mode-sweep fuzz tests
(pytest/test_vec_env.py:74-171) plus byte-exact packer checks.

Shapes intentionally match tests/test_parallel.py (N=16, n_pieces=2,
difficulty 0) so the jitted reset/step programs are traced once per run.
"""
import threading

import numpy as np
import pytest

from eldorado_tpu import vec
from eldorado_tpu import compat as cog
from eldorado_tpu.compat import vec as cvec
from eldorado_tpu.core.ref_engine import RefEnv, RefSampler

N = 16


# --------------------------------------------------------------- vec.VecEnv
def test_vecenv_sample_step_loop():
    env = vec.VecEnv(N)
    obs = env.reset(seed=21, n_pieces=2)
    assert obs["map"].shape == (N, 48, 48, 7)
    assert obs["action_masks"].shape == (N, 4, 92)
    for _ in range(25):
        actions = env.sample()
        done = env.step(actions)
    assert np.asarray(done).shape == (N,)
    assert np.asarray(env.agent_selection).shape == (N,)
    assert np.asarray(env.rewards).shape == (N, 4)
    infos = env.infos
    assert np.asarray(infos["returns"]).shape == (N, 4)
    # dead-stat quirks stay dead (SURVEY quirk 3)
    assert not np.asarray(infos["n_machete_uses"]).any()


def test_rollout_chunked_accounting():
    states = vec.vec_reset(5, N, 4, 2, 0, 40)
    rngs = vec.sampler_init(11, N)
    s1, r1, eps1 = vec.rollout_chunked(states, rngs, 200, chunk=50)
    assert eps1 > 0, "max_steps=40 must truncate episodes within 200 steps"
    # deterministic: same inputs, same episode count and final state
    s2, r2, eps2 = vec.rollout_chunked(states, rngs, 200, chunk=50)
    assert eps1 == eps2
    assert np.array_equal(np.asarray(s1.rng), np.asarray(s2.rng))
    assert np.array_equal(np.asarray(r1), np.asarray(r2))
    # resets kept the maps valid
    vec.check_map_generation(s1)


@pytest.mark.slow
def test_mode_sweep_fuzz_10k():
    """Reference-scale fuzz (pytest/test_vec_env.py:161-171: 10k masked-
    random steps x 16 envs): no crashes, valid maps throughout, episodes
    keep completing and resetting."""
    # max_steps=500 turns (~2.5-3k env-steps/episode) so the 10k-step run
    # exercises many auto-resets; an untruncated game at 16 envs would
    # rarely finish inside the run (mean episode ~45k env-steps)
    states = vec.vec_reset(3, 16, 4, 3, 1, 500)
    rngs = vec.sampler_init(7, 16)
    s, r, eps = vec.rollout_chunked(states, rngs, 10_000, 500)
    vec.check_map_generation(s)
    assert eps > 0


def test_kernel_chunked_reset_modes_match_xla():
    """The kernel backend's on-device queued resets ('sync') must be
    bit-identical to the xla chunked path INCLUDING mid-run auto-resets;
    'async' (deferred host-CPU procgen) must stay a valid, episode-
    counting rollout (its resets land one boundary later by design)."""
    from eldorado_tpu.core import engine as E
    states = vec.vec_reset(5, 8, 4, 1, 0, 30)
    rngs = vec.sampler_init(11, 8)
    sx, rx, ex = vec.rollout_chunked(states, rngs, 200, 50, backend="xla")
    sk, rk, ek = vec.rollout_chunked(states, rngs, 200, 50,
                                     backend="kernel", block=8, reset_mode="sync")
    assert ex == ek and ex > 0
    for name in E.EnvState._fields:
        assert np.array_equal(np.asarray(getattr(sk, name)),
                              np.asarray(getattr(sx, name))), name
    assert np.array_equal(np.asarray(rk), np.asarray(rx))

    sa, ra, ea = vec.rollout_chunked(states, rngs, 200, 50,
                                     backend="kernel", block=8, reset_mode="async")
    assert ea > 0
    vec.check_map_generation(sa)


def test_async_reset_value_identical():
    """The deferred (host-CPU) reset of a queued finisher must produce
    EXACTLY the values the on-device sync reset produces for the same
    queue — the 'value-identical' claim in vec._rollout_chunked_q: a
    queued env stays done (frozen carry columns ride in the queue), so
    where procgen runs and when it lands cannot change its result."""
    import jax
    from eldorado_tpu.core import engine as E
    states = vec.vec_reset(5, 8, 4, 1, 0, 20)
    rngs = vec.sampler_init(11, 8)
    progs = vec._kernel_programs(states, "storage", block=8)
    bctx, bdyn, brngs = progs.block_in(states, rngs)
    qstate = progs.qstate_init()
    any_new = False
    for _ in range(30):
        bdyn, brngs, qstate, any_new, resetq = progs.run_q(
            bctx, bdyn, brngs, qstate, 10)
        if bool(any_new):
            break
    assert bool(any_new), "max_steps=20 must finish an episode in 300 steps"

    cpu = jax.devices("cpu")[0]
    buf_dev = progs.reset_q(resetq)
    buf_cpu = progs.reset_q(jax.device_put(resetq, cpu))
    assert np.array_equal(np.asarray(buf_dev), np.asarray(buf_cpu)), \
        "host-CPU procgen result differs from the on-device reset"

    # applying either buffer yields the identical full state
    outs = []
    for buf in (buf_dev, jax.device_put(buf_cpu, states.rng.devices().pop())):
        d, c, st, q = progs.apply_q(
            jax.tree_util.tree_map(lambda x: x + 0, bdyn),
            jax.tree_util.tree_map(lambda x: x + 0, bctx),
            states,
            jax.tree_util.tree_map(lambda x: x + 0, qstate), buf)
        s_env, _ = progs.unblock(st, d, brngs)
        outs.append((s_env, c, q))
    for name in E.EnvState._fields:
        assert np.array_equal(np.asarray(getattr(outs[0][0], name)),
                              np.asarray(getattr(outs[1][0], name))), name
    for a, b in zip(jax.tree_util.tree_leaves(outs[0][1:]),
                    jax.tree_util.tree_leaves(outs[1][1:])):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------ compat single
def _drive_pair(n_steps=60):
    env = cog.cog_env(seed=77, n_players=3, n_pieces=2,
                      difficulty=cog.Difficulty.EASY, max_steps=100000)
    env.reset()
    sam = cog.action_sampler(13)

    ref = RefEnv(seed=77, n_players=3, n_pieces=2, difficulty=0,
                 max_steps=100000)
    ref.reset()
    rsam = RefSampler(13)
    for _ in range(n_steps):
        a = sam.sample(env.selected_action_mask)
        env.step(a)
        ra = rsam.sample(ref.sel_mask)
        ref.step(ra)
        if ref.done:
            ref.reset()
        if env.get_done():
            env.reset()
    return env, ref


def test_cog_env_matches_ref_engine():
    env, ref = _drive_pair()
    assert env.agent_selection == ref.agent
    assert env.get_agent_selection() == ref.agent
    obs = env.observations
    assert np.array_equal(obs["shared"]["map"], ref.map.obs)
    assert np.array_equal(obs["shared"]["shop"], ref.shop_stock)
    for p in range(4):
        assert np.array_equal(
            obs["player_data"][p]["obs"]["hand"], ref.piles[p, 1])
    assert np.array_equal(env.rewards, ref.rewards)


def test_cog_env_init_buffers_sync():
    """init() wires caller-owned buffers (single_env.cpp:19-21)."""
    obs = np.zeros((), cog.obs_dtype)
    info = np.zeros((), cog.info_dtype)
    rewards = np.zeros(4, np.float32)
    mask = np.zeros((), cog.action_mask_dtype)
    env = cog.cog_env(seed=5, n_players=2, n_pieces=2,
                      difficulty=cog.Difficulty.EASY)
    env.init(obs, info, rewards, mask)
    env.reset()
    assert obs["shared"]["map"].any(), "reset must sync the map buffer"
    assert mask["move"].shape == (7,)
    sam = cog.action_sampler(3)
    before = obs["shared"]["map"].copy()
    for _ in range(10):
        env.step(sam.sample(env.selected_action_mask))
    assert np.array_equal(obs["shared"]["map"], before), \
        "map never changes after reset (SURVEY quirk 2)"
    assert mask[()] == env.selected_action_mask[()]


def test_cog_env_getters():
    env = cog.cog_env(seed=4, n_players=2, n_pieces=2,
                      difficulty=cog.Difficulty.EASY, max_steps=500)
    env.reset()
    assert env.get_seed() == 4
    assert env.get_n_players() == 2
    assert env.get_n_pieces() == 2
    assert env.get_difficulty() == cog.Difficulty.EASY
    assert env.get_max_steps() == 500
    assert env.get_render() is False
    assert env.get_done() is False
    assert env.get_map() is not None


# --------------------------------------------------------------- compat.vec
def test_compat_vec_surfaces():
    venv = cvec.get_vec_env(N)
    venv.reset(seed=21, n_pieces=2)
    sampler = cvec.get_vec_sampler(N)
    sampler.seed(9)
    for _ in range(15):
        actions = sampler.sample(venv.get_selected_action_masks())
        venv.step(actions)
    obs = venv.get_observations()
    assert obs.dtype == cog.obs_dtype and obs.shape == (N,)
    infos = venv.get_infos()
    assert infos.dtype == cog.info_dtype
    assert venv.get_num_envs() == N
    assert venv.get_agent_selections().shape == (N,)
    assert venv.get_rewards().shape == (N, 4)

    runner = cvec.get_runner(N, 2)
    runner.reset(seed=21, n_pieces=2)
    runner.sample()
    runner.step_sync()
    runner.sync()


def test_pack_obs_matches_numpy_fallback(monkeypatch):
    from eldorado_tpu import native
    if not native.available():
        pytest.skip("native toolchain unavailable")
    venv = cvec.get_vec_env(N)
    venv.reset(seed=21, n_pieces=2)
    for _ in range(5):
        venv.step(cvec.get_vec_sampler(N).sample(
            venv.get_selected_action_masks()))
    packed = venv.get_observations()
    monkeypatch.setattr(native, "available", lambda: False)
    fallback = venv.get_observations()
    assert packed.dtype == fallback.dtype == cog.obs_dtype
    assert np.array_equal(packed.view(np.uint8), fallback.view(np.uint8)), \
        "native pack_obs differs from the numpy fallback layout"


# ------------------------------------------------------------------- native
def test_trajectory_ring_producer_consumer():
    from eldorado_tpu import native
    if not native.available():
        pytest.skip("native toolchain unavailable")
    chunk = 1024
    ring = native.TrajectoryRing(chunk_bytes=chunk, capacity=8)
    n_chunks = 64
    src = [np.random.default_rng(i).integers(
        0, 255, chunk, dtype=np.uint8) for i in range(n_chunks)]
    got = []

    def producer():
        for c in src:
            while not ring.push(c):
                pass

    def consumer():
        while len(got) < n_chunks:
            out = ring.pop()
            if out is not None:
                got.append(out)

    t1 = threading.Thread(target=producer)
    t2 = threading.Thread(target=consumer)
    t1.start(); t2.start()
    t1.join(timeout=30); t2.join(timeout=30)
    assert len(got) == n_chunks
    for a, b in zip(src, got):
        assert np.array_equal(a, b), "SPSC ring reordered or corrupted data"


# ------------------------------------------------------------------- render
def test_render_snapshot():
    from eldorado_tpu.render import render_env
    env = RefEnv(seed=3, n_players=2, n_pieces=2, difficulty=0,
                 max_steps=100000)
    env.reset()
    out = render_env(env, color=False)
    assert isinstance(out, str) and len(out) > 100
    for token in ("shop", "player", "phase"):
        assert token in out.lower(), f"renderer output missing {token!r}"


def test_render_via_cog_env(capsys):
    env = cog.cog_env(seed=3, n_players=2, n_pieces=2,
                      difficulty=cog.Difficulty.EASY, render=True)
    env.reset()
    env.render()
    assert len(capsys.readouterr().out) > 100
    env2 = cog.cog_env(seed=3, render=False)
    env2.render()
    assert "without specifying" in capsys.readouterr().out


def test_vec_reset_varied_mixed_difficulty_batch():
    """Per-env reset parameters in ONE lockstep batch (the BASELINE
    mixed-difficulties config): each env's state and trajectory is
    bit-identical to a uniform batch run with its own parameters, and
    queued auto-resets regenerate each env with its stored params."""
    import jax
    import numpy as np

    from eldorado_tpu import vec
    from eldorado_tpu.core import engine as E

    n = 8
    seeds = np.arange(n, dtype=np.uint32) + 7
    diffs = np.array([0, 1, 2, 0] * 2, np.int32)
    pieces = np.array([1, 2, 3, 2] * 2, np.int32)
    mixed = vec.vec_reset_varied(seeds, 4, pieces, diffs, 15)

    for d, pc in {(0, 1), (1, 2), (2, 3), (0, 2)}:
        rows = np.where((diffs == d) & (pieces == pc))[0]
        uni = vec.vec_reset(int(seeds[rows[0]]), 1, 4, int(pc), int(d), 15)
        for name in E.EnvState._fields:
            a = np.asarray(getattr(mixed, name))[rows[0]]
            b = np.asarray(getattr(uni, name))[0]
            assert np.array_equal(a, b), (name, d, pc)

    # rollout with mid-run auto-resets keeps per-env params
    rngs = vec.sampler_init(3, n)
    s, r, eps = vec.rollout_chunked(mixed, rngs, 120, 30, backend="kernel",
                                    block=8)
    assert eps > 0
    assert np.array_equal(np.asarray(s.difficulty), diffs)
    assert np.array_equal(np.asarray(s.n_pieces), pieces)
