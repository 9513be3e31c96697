"""Exact same-step auto-reset mode (vec.rollout_chunked(exact=True)).

The reference's vec envs reset INSIDE step_single, so an env is never done
at sample time and every env's trajectory is one continuous stream
(reference: include/vec_environment.h:53-61). The kernel path defers the
reset to a chunk boundary; ``exact`` mode makes the deferral unobservable
per env by freezing finished envs completely — dead steps consume no
sampler draws and no engine state. These tests prove the per-env step
sequences with dead steps excluded are bit-identical to the in-scan
same-step-reset rollout (rollout(auto_reset="step"), itself golden-tested),
i.e. the exact-mode throughput metric counts reference-semantics steps.
"""
import jax
import numpy as np

from eldorado_tpu import vec
from eldorado_tpu.core import engine as E

N = 8
CHUNK = 10
CHUNKS = 12


def _exact_traj(states, rngs):
    """Drive the gate_dead kernel programs chunk by chunk, resetting
    finished envs at boundaries, recording the per-step traj."""
    progs = vec._kernel_programs(states, "storage", 8, gate_dead=True)
    s, r = states, rngs
    cols = [[], [], [], []]
    for _ in range(CHUNKS):
        bctx, bdyn, brngs = progs.block_in(s, r)
        bdyn, brngs, _, _, traj = progs.run(bctx, bdyn, brngs, CHUNK, True)
        s, r = progs.unblock(s, bdyn, brngs)
        for c, t in zip(cols, progs.unblock_traj(traj)):
            c.append(np.asarray(t))
        if np.asarray(s.done).any():
            s, _ = vec.reset_done_bucketed(s)
    return [np.concatenate(c) for c in cols]   # actions, done, rew, agent


def test_exact_per_env_sequences_match_step_reset():
    states = vec.vec_reset(5, N, 4, 1, 0, 20)   # short games: resets fire
    rngs = vec.sampler_init(11, N)
    T = CHUNK * CHUNKS

    a_ref, d_ref, r_ref, g_ref = [
        np.asarray(x) for x in
        vec.rollout(states, rngs, T, auto_reset="step")[2][:4]]
    acts, dones, rews, agents = _exact_traj(states, rngs)

    # a step is dead when the env was done at entry; chunk-boundary steps
    # are always live here (every finisher is reset at the boundary)
    entry_dead = np.concatenate(
        [np.zeros((1, N), bool), np.asarray(dones[:-1], bool)])
    entry_dead[::CHUNK] = False
    total_dead = int(entry_dead.sum())
    assert total_dead > 0, "workload must exercise deferred resets"
    for e in range(N):
        live = ~entry_dead[:, e]
        k = int(live.sum())
        assert np.array_equal(acts[live, e], a_ref[:k, e]), f"env {e} acts"
        assert np.array_equal(dones[live, e] != 0, d_ref[:k, e]), \
            f"env {e} dones"
        assert np.array_equal(rews[live, e], r_ref[:k, e]), f"env {e} rew"
        assert np.array_equal(agents[live, e], g_ref[:k, e]), f"env {e} agt"


def test_exact_rollout_chunked_counts():
    """rollout_chunked(exact=True) returns a dead-step count consistent
    with an independent replay, and still reproduces the sync-mode
    episode accounting."""
    states = vec.vec_reset(5, N, 4, 1, 0, 20)
    rngs = vec.sampler_init(11, N)
    s1, r1, eps, dead = vec.rollout_chunked(
        states, rngs, CHUNK * CHUNKS, CHUNK, backend="kernel", block=8, exact=True)
    assert eps > 0
    assert 0 < dead < N * CHUNK * CHUNKS
    _, dones, _, _ = _exact_traj(states, rngs)
    entry_dead = np.concatenate(
        [np.zeros((1, N), bool), np.asarray(dones[:-1], bool)])
    entry_dead[::CHUNK] = False
    assert dead == int(entry_dead.sum())
