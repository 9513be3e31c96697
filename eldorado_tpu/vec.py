"""Vectorised environments: vmapped lockstep batch with auto-reset.

The device-resident replacement for the reference's compile-time
instantiated ``vec_cog_env<N>`` + pinned-thread ``ThreadedRunner<N>``
(reference: include/vec_environment.h, include/runner.h): the env batch is
a leading axis of the `EnvState` pytree living in device memory, the
"thread pool" is `jax.vmap`, and work distribution is XLA — there is no
N <= 256 cap.

Auto-reset follows vec_cog_env::step_single (include/vec_environment.h:53-61):
a done env resets immediately with the same parameters (its engine stream is
*not* reseeded), so post-done observations belong to the new episode while
rewards/infos hold the finished episode's values.

Two auto-reset strategies, picked by a scalar batch-level branch:
`jax.lax.cond(jnp.any(done), ...)` keeps the expensive in-jit map generation
off the hot path on steps where no env finished — on benchmark-style
workloads (reference asv: 10k steps, max_steps=100000, masked-random play)
resets never fire after the initial one, so the steady-state step is pure
game logic.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .core import engine as E
from .ops import rng as R

__all__ = ["VecEnv", "vec_reset", "vec_reset_varied", "vec_step",
           "vec_sample", "rollout", "rollout_chunked", "kernel_rollout",
           "sampler_init", "reset_done", "reset_done_bucketed",
           "check_map_generation"]


def _batch_select(pred, a, b):
    """Per-env select over batched pytrees; pred: (N,) bool."""
    def pick(x, y):
        p = jnp.reshape(pred, pred.shape + (1,) * (x.ndim - 1))
        return jnp.where(p, x, y)
    return jax.tree_util.tree_map(pick, a, b)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _vec_reset(seed, n_envs, n_players=4, n_pieces=3, difficulty=0,
               max_steps=100000):
    seeds = jnp.asarray(seed, jnp.uint32) + jnp.arange(n_envs, dtype=jnp.uint32)
    make = jax.vmap(
        lambda s: E.make_state(s, n_players, n_pieces, difficulty, max_steps))
    return jax.vmap(E.reset_env)(make(seeds))


def check_map_generation(states):
    """Raise if any env's last map generation failed (the jit-side analogue
    of the reference throwing generate_map_failure out of reset,
    src/map.cpp:736-740). Blocks on the two scalar flags."""
    import numpy as np
    from .errors import GenerateMapFailure, MapCapacityError
    if bool(np.asarray(states.map_overflow).any()):
        raise MapCapacityError(
            "map generation overflowed a fixed capacity (MAX_PLACED); "
            "raise MAX_PLACED in core/mapgen.py for these reset parameters")
    if not bool(np.asarray(states.map_ok).all()):
        raise GenerateMapFailure(
            "map generation failed more than MAX_FAILURES times "
            "(reference: generate_map_failure)")
    return states


def vec_reset(seed, n_envs, n_players=4, n_pieces=3, difficulty=0,
              max_steps=100000, check_maps=True):
    """vec_cog_env::reset(seed, ...): env i is seeded with seed + i
    (include/vec_environment.h:38-44). Unless ``check_maps=False``, raises
    `errors.GenerateMapFailure`/`errors.MapCapacityError` when any env's
    procgen failed, mirroring the reference throw."""
    states = _vec_reset(seed, n_envs, n_players, n_pieces, difficulty,
                        max_steps)
    return check_map_generation(states) if check_maps else states


@jax.jit
def _vec_reset_varied(seeds, n_players, n_pieces, difficulty, max_steps):
    return jax.vmap(E.reset_env)(jax.vmap(E.make_state)(
        seeds, n_players, n_pieces, difficulty, max_steps))


def vec_reset_varied(seeds, n_players=4, n_pieces=3, difficulty=0,
                     max_steps=100000, check_maps=True):
    """Heterogeneous lockstep batch: PER-ENV reset parameters. Every
    argument may be a scalar or an (n_envs,)-shaped array; env i resets
    with its own (seed, n_players, n_pieces, difficulty, max_steps).
    The reference's vec env is parameter-uniform (vec_cog_env::reset,
    include/vec_environment.h:38-44); here the reset params are ordinary
    per-env state fields — queued auto-resets already regenerate each
    env with its own stored params — so mixed-difficulty batches (the
    BASELINE 1024-env mixed-difficulties config) are one call, and each
    env's trajectory is bit-identical to a uniform batch run with its
    parameters (tests/test_api_surfaces.py)."""
    import numpy as np
    seeds = jnp.asarray(seeds, jnp.uint32)
    n = seeds.shape[0]

    def bcast(v):
        return jnp.broadcast_to(jnp.asarray(v, jnp.int32), (n,))

    states = _vec_reset_varied(seeds, bcast(n_players), bcast(n_pieces),
                               bcast(difficulty), bcast(max_steps))
    return check_map_generation(states) if check_maps else states


_vstep = jax.vmap(E.step_env)
_vreset = jax.vmap(E.reset_env)


@jax.jit
def vec_step(states, actions):
    """Step every env; auto-reset finished envs (same params, same engine
    stream). The reset branch is gated on a scalar `any(done)` so its map
    generation costs nothing on steps where no episode ends."""
    states = _vstep(states, actions)
    done = states.done

    def do_reset(s):
        return _batch_select(done, _vreset(s), s)

    states = jax.lax.cond(jnp.any(done), do_reset, lambda s: s, states)
    return states, done


@jax.jit
def vec_sample(rngs, masks):
    """Batched masked-uniform sampler; sampler i has its own engine
    (include/vec_sampler.h:7-28 seeds sampler i with seed + i). The third
    output flags the (once-per-1e16-draws) double-rejection deviation from
    the exact libstdc++ stream."""
    actions, rngs, tainted = jax.vmap(E.sample_action)(rngs, masks)
    return actions, rngs, tainted


def sampler_init(seed, n_envs):
    return jax.vmap(R.seed)(
        jnp.asarray(seed, jnp.uint32) + jnp.arange(n_envs, dtype=jnp.uint32))


# Keeping step-static fields (incl. the 16KB/env map observation) out of
# the lax.scan carry guarantees XLA cannot insert per-iteration copies of
# them (observed as O(N) per-step cost at large batches).
_split_state = E.split_state
_merge_state = E.merge_state


def _active_mask(states, mask_src: str):
    if mask_src == "storage":
        return E.unpack_mask(jnp.take_along_axis(
            states.storage_masks, states.agent[:, None, None],
            axis=1)[:, 0])
    return E.unpack_mask(states.sel_mask)


@jax.jit
def reset_done(states):
    """Auto-reset every done env (same params, same engine stream —
    include/vec_environment.h:53-61)."""
    return _batch_select(states.done, _vreset(states), states)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def rollout(states, sampler_rngs, n_steps: int, mask_src: str = "storage",
            auto_reset: str = "none"):
    """Self-play rollout: n_steps of sample+step under one lax.scan — the
    jitted equivalent of the reference's runner.sample(); runner.step_sync()
    driver loop (pytest/test_vec_env.py:97-112). Returns final carry plus
    per-step (actions, dones, rewards, agents, sel_mask_words, resources,
    phases) — the same learner surface the packed streaming path emits
    (eldorado_tpu.stream), post-step convention.

    auto_reset:
      * "step": reset done envs inside the scan via a batch-gated
        lax.cond — exact vec_cog_env semantics, but the reset branch
        (map generation for the whole batch) sits inside every
        iteration, so use it only for small parity batches.
      * "none" (default): done envs dead-step (cog_env::step's done
        early-out, src/environment.cpp:92-95); the caller resets between
        dispatches (see rollout_chunked).
    """
    def sample_and_step(s, rngs):
        # one player projection shared by sampler + step (fused_sample_step)
        ball = jax.vmap(E.ball_words)(s)
        return jax.vmap(
            lambda a, b, c: E.fused_sample_step(a, b, c, mask_src))(
                s, rngs, ball)

    if auto_reset == "step":
        # exact vec semantics: reset may regenerate maps mid-scan, so the
        # full state is the carry
        def body(carry, _):
            s, rngs = carry
            s, rngs, actions = sample_and_step(s, rngs)
            done = s.done
            s = jax.lax.cond(jnp.any(done),
                             lambda x: _batch_select(done, _vreset(x), x),
                             lambda x: x, s)
            return (s, rngs), (actions, done, s.rewards, s.agent,
                               s.sel_mask, s.resources, s.phase)

        (states, sampler_rngs), traj = jax.lax.scan(
            body, (states, sampler_rngs), None, length=n_steps)
        return states, sampler_rngs, traj

    static, dyn0 = _split_state(states)

    def body(carry, _):
        dyn, rngs = carry
        s, rngs, actions = sample_and_step(_merge_state(static, dyn), rngs)
        _, dyn = _split_state(s)
        return (dyn, rngs), (actions, s.done, s.rewards, s.agent,
                             s.sel_mask, s.resources, s.phase)

    (dyn, sampler_rngs), traj = jax.lax.scan(
        body, (dyn0, sampler_rngs), None, length=n_steps)
    return _merge_state(static, dyn), sampler_rngs, traj


_RESET_BUCKETS = (8, 32, 128, 512, 2048)


@functools.partial(jax.jit, static_argnums=(2,))
def _reset_bucket(states, idxs, bucket: int):
    """Reset the envs at ``idxs`` (padded with repeats to a static bucket
    size): gather -> vmapped reset -> write back. Map generation then costs
    O(bucket), not O(n_envs) — resetting a handful of finished envs out of
    4096 via a full-batch select pays ~500x more than it needs to."""
    sub = jax.tree_util.tree_map(lambda x: x[idxs], states)
    sub = _vreset(sub)
    return jax.tree_util.tree_map(
        lambda x, y: x.at[idxs].set(y), states, sub)


def reset_done_bucketed(states, done=None, check_maps=True):
    """Host-driven sparse auto-reset: resets exactly the done envs using the
    smallest padded bucket. Returns (states, n_episodes)."""
    import numpy as np
    if done is None:
        done = np.asarray(states.done)
    idxs = np.nonzero(done)[0]
    if len(idxs) == 0:
        return states, 0
    bucket = next((b for b in _RESET_BUCKETS if b >= len(idxs)),
                  None)
    if bucket is None:
        states = reset_done(states)
    else:
        pad = np.full(bucket, idxs[0], idxs.dtype)
        pad[: len(idxs)] = idxs
        states = _reset_bucket(states, jnp.asarray(pad), bucket)
    if check_maps:
        check_map_generation(states)
    return states, int(len(idxs))


_KERNEL_CACHE = {}


def _blocked_layout(n, block):
    """(t_in, t_out) between env-major (n, f...) leaves and the blocked
    carry layout (n // block, f..., block); scalar leaves ride as
    (nb, 1, block). Env e sits in block e // block, lane e % block."""
    nb = n // block

    def t_in(x):
        if x.ndim == 1:
            return x.reshape(nb, 1, block)
        return jnp.moveaxis(x.reshape((nb, block) + x.shape[1:]), 1, -1)

    def t_out(o, fshape):
        if len(fshape) == 0:
            return o.reshape(n)
        return jnp.moveaxis(o, -1, 1).reshape((n,) + tuple(fshape))

    return t_in, t_out


def _queue_cap(n):
    """Reset-queue capacity per chunk boundary. Finishers beyond it
    dead-step to the next boundary, which departs from the xla path's
    trajectories (non-exact dead steps draw from the sampler) and leaves
    a growing backlog: 4096 envs x 1500-step chunks of the bench workload
    finish ~141 episodes per boundary, so 4096 envs get 256 slots and
    larger batches proportionally more."""
    return min(n, 1024, max(256, n // 16))


def _dyn_state(dyn, n_players, max_steps=0):
    """One env's EnvState from its dynamic leaves. The step and the reset
    body never read the map or the other reset parameters, so those
    static leaves are placeholders."""
    z = jnp.zeros((), jnp.int32)
    static = (jnp.zeros((1,), jnp.int32), jnp.zeros((2,), jnp.int32),
              jnp.ones((), bool), jnp.zeros((), bool),
              n_players, z, z, max_steps)
    return _merge_state(static, tuple(dyn))


def _blocked_step(feat, mask_src, gate_dead, t_in, t_out):
    """The rollout's step on the blocked carry: engine.fused_sample_step
    vmapped over env-major views of the blocked leaves (bools held as
    i32 in the carry). ``(bdyn, brngs, bball, bnp, bms) -> (bdyn',
    brngs', bact)``, every operand (nb, f..., block)."""
    is_bool = [d == jnp.bool_ for _, _, d in feat]

    def one(dyn, srng, ball, n_players, max_steps):
        dyn = [x != 0 if b else x for x, b in zip(dyn, is_bool)]
        s = _dyn_state(dyn, n_players, max_steps)
        s, srng, act = E.fused_sample_step(s, srng, ball, mask_src,
                                           gate_dead)
        _, dyn = _split_state(s)
        return (tuple(x.astype(jnp.int32) if b else x
                      for x, b in zip(dyn, is_bool)),
                srng, act.astype(jnp.int32))

    def step(bdyn, brngs, bball, bnp, bms):
        dyn = tuple(t_out(x, f) for x, (_, f, _) in zip(bdyn, feat))
        dyn, srng, act = jax.vmap(one)(
            dyn, t_out(brngs, ()), tuple(t_out(w, ()) for w in bball),
            t_out(bnp, ()), t_out(bms, ()))
        return tuple(t_in(x) for x in dyn), t_in(srng), t_in(act)

    return step


def _reset_one(dyn, player_xy, ball, n_players):
    """engine.reset_body on one env's dynamic leaves (the reset queue's
    post-mapgen half)."""
    s = E.reset_body(_dyn_state(dyn, n_players), player_xy, ball)
    return _split_state(s)[1]


class _KernelPrograms:
    """Compiled programs for blocked rollouts, built once per
    (n, mask_src, block, gate_dead, map-shape) and cached.

    The scan carry lives in a blocked env-minor layout (``_blocked_layout``);
    these pieces let callers keep it there ACROSS dispatches
    (rollout_chunked), paying the block/unblock transposes only around
    host-driven resets:

    * ``block_in(states, rngs) -> (bctx, bdyn, brngs)`` — block the
      dynamic state and precompute the per-cell packed ball tables
      (engine.pack_ball_word_table) + blocked step-static inputs.
    * ``run(bctx, bdyn, brngs, n_steps, want_traj)`` — the scan. Returns
      ``(bdyn, brngs, any_done, traj)``; ``any_done`` is a device scalar
      for cheap host polling; ``traj`` is blocked per-step
      (actions, done, rewards, agent) or None.
    * ``unblock(states, bdyn, brngs) -> (states', rngs)`` — back to the
      env-major EnvState (static leaves from ``states``).
    * ``unblock_traj(traj)`` — per-step outputs to env-major.
    """

    def __init__(self, states, mask_src, block, gate_dead=False):
        n = int(states.rng.shape[0])
        assert n % block == 0, (n, block)
        t_in, t_out = _blocked_layout(n, block)
        feat = [(name, x.shape[1:], x.dtype)
                for name, x in zip(E.DYN_FIELDS, _split_state(states)[1])]
        step = _blocked_step(feat, mask_src, gate_dead, t_in, t_out)
        i_xy = E.DYN_FIELDS.index("player_xy")
        i_done = E.DYN_FIELDS.index("done")
        i_rew = E.DYN_FIELDS.index("rewards")
        i_agent = E.DYN_FIELDS.index("agent")
        i_sel = E.DYN_FIELDS.index("sel_mask")
        i_res = E.DYN_FIELDS.index("resources")
        i_phase = E.DYN_FIELDS.index("phase")
        i_piles = E.DYN_FIELDS.index("piles")
        i_shop = E.DYN_FIELDS.index("shop_stock")
        i_storage = E.DYN_FIELDS.index("storage_masks")
        GRID2 = E.GRIDSIZE * E.GRIDSIZE

        def _block_in(states, rngs):
            _, dyn = _split_state(states)
            tabs = jax.vmap(E.pack_ball_word_table)(states.map_ids)
            bparams = jnp.stack(
                [states.n_players, states.n_pieces, states.difficulty,
                 states.max_steps], axis=-1)           # (n, 4) reset params
            # tile-packed (n, 72, 128) cell rows: the scan body reads the
            # whole step's map dependence as ONE contiguous 128-word row
            # gather at the agent's cell (see pack_ball_word_table)
            bctx = (tabs,
                    t_in(states.min_xy), t_in(states.n_players),
                    t_in(states.max_steps), bparams)
            bdyn = tuple(
                t_in(x.astype(jnp.int32) if x.dtype == jnp.bool_ else x)
                for x in dyn)
            return bctx, bdyn, t_in(rngs)

        block_in = jax.jit(_block_in)

        def _scan(bctx, bdyn, brngs, n_steps, want_traj):
            # The per-step map read is ONE contiguous 128-word row gather
            # at the agent's cell (engine.pack_ball_word_table's
            # tile-packed layout) followed by a one-hot select of the
            # cell's 4 words. The next agent's one-hop word comes from
            # the in-state w3_cache (engine.ball_words).
            tab, bmin, bnp, bms, _ = bctx
            NROW = E.GRIDSIZE * E.GRIDSIZE // 32       # 72 rows/env
            tab2 = tab.reshape(n * NROW, 128)
            nb = n // block
            ebase = t_in(jnp.arange(n, dtype=jnp.int32)
                         * NROW)[:, 0]

            def body(carry, _):
                bdyn, brngs, dead = carry
                # a step is dead when the env is done at ENTRY
                # (cog_env::step's early-out, src/environment.cpp:92-95);
                # the count feeds the exact-mode live-steps metric
                dead = dead + jnp.sum(bdyn[i_done])
                bxy = bdyn[i_xy]                       # (nb, 4, 2, block)
                a = bdyn[i_agent]                      # (nb, 1, block)

                def cell_of(idx):
                    # idx (nb,1,block) player id -> flat grid cell of that
                    # player (always an in-grid hex: agents are active)
                    xy = sum(jnp.where(idx == j, bxy[:, j], 0)
                             for j in range(4))        # (nb, 2, block)
                    c = ((xy - bmin) >> 1) + 1
                    return jnp.clip(c[:, 0] * E.GRIDSIZE + c[:, 1],
                                    0, GRID2 - 1)[:, None, :]

                cell = cell_of(a)                      # (nb, 1, block)
                rows = ((cell[:, 0] >> 5) + ebase).reshape(n)
                g128 = tab2.at[rows].get(
                    mode="promise_in_bounds")          # (n, 128)
                g = E.select_ball_words(
                    g128, (cell.reshape(n) & 31) * 4)  # (n, 4)
                g = jnp.moveaxis(g.reshape(nb, block, 4), -1, 1)
                bball = (g[:, 0:1], g[:, 1:2], g[:, 2:3], g[:, 3:4])
                bdyn, brngs, bact = step(bdyn, brngs, bball, bnp, bms)
                if want_traj in ("packed", "full"):
                    # the per-step learner feed: 5 packed words/env
                    # (stream.pack_step_blocked layout); "full" extends
                    # to the whole observation surface (40 words: actor
                    # piles, shop, written storage rows — stream module
                    # docstring)
                    from .stream import (pack_step_blocked,
                                         pack_step_full_blocked)
                    out = pack_step_blocked(
                        bact, bdyn[i_done], bdyn[i_rew], bdyn[i_agent],
                        bdyn[i_sel], bdyn[i_res], bdyn[i_phase])
                    if want_traj == "full":
                        out = pack_step_full_blocked(
                            out, bdyn[i_piles], bdyn[i_shop],
                            bdyn[i_storage], bdyn[i_res], a,
                            bdyn[i_agent])
                elif want_traj:
                    out = (bact, bdyn[i_done], bdyn[i_rew],
                           bdyn[i_agent])
                else:
                    out = None
                return (bdyn, brngs, dead), out

            (bdyn, brngs, dead), traj = jax.lax.scan(
                body, (bdyn, brngs, jnp.int32(0)), None, length=n_steps)
            return bdyn, brngs, dead, traj

        @functools.partial(jax.jit, static_argnums=(3, 4),
                           donate_argnums=(1, 2))
        def run(bctx, bdyn, brngs, n_steps, want_traj):
            bdyn, brngs, dead, traj = _scan(bctx, bdyn, brngs, n_steps,
                                            want_traj)
            any_done = jnp.max(bdyn[i_done]) > 0
            return bdyn, brngs, any_done, dead, traj

        def _unblock(states, bdyn, brngs):
            static, _ = _split_state(states)
            new_dyn = []
            for o, (_, fshape, fdtype) in zip(bdyn, feat):
                o = t_out(o, fshape)
                if fdtype == jnp.bool_:
                    o = o != 0
                new_dyn.append(o)
            return _merge_state(static, tuple(new_dyn)), t_out(brngs, ())

        unblock = jax.jit(_unblock)

        @jax.jit
        def unblock_traj(traj):
            # (T, nb, f..., block) -> (T, n, f...): vmap the unblocker
            bact, bdone, brew, bagent = traj
            return (jax.vmap(lambda x: t_out(x, (5,)))(bact),
                    jax.vmap(lambda x: t_out(x, ()))(bdone) != 0,
                    jax.vmap(lambda x: t_out(x, (4,)))(brew),
                    jax.vmap(lambda x: t_out(x, ()))(bagent))

        @jax.jit
        def unblock_packed(traj):
            # (T, nb, W, block) packed records -> (T, n, W) env-major
            # (W = 5 compact / 40 full)
            W = int(traj.shape[2])
            return jax.vmap(lambda x: t_out(x, (W,)))(traj)

        # ---- reset-queue programs ------------------------------------
        # A full env-major round-trip per reset event would pay layout
        # transposes of the whole batch plus per-leaf host transfers.
        # Instead run_q compacts up to Q newly-done envs ON DEVICE into
        # one packed i32 "reset queue" buffer (their frozen carry columns
        # + reset params); reset_q regenerates them and apply_q scatters
        # the results back, on the device (sync) or via the host CPU
        # backend (async), and episode/procgen-failure accounting rides
        # in a device-side counter vector read once at rollout end. An
        # in-flight mask keeps a queued env from being re-queued at the
        # next boundary (it stays `done`, dead-stepping, until applied).
        import numpy as np
        feat_sizes = [max(1, int(np.prod(f))) for _, f, _ in feat]
        MAPW = E.GRIDSIZE * E.GRIDSIZE    # flat i32 cell-type-id plane
        i32 = jnp.int32
        Q = _queue_cap(n)

        def qstate_init():
            return (jnp.zeros((n // block, 1, block), i32),   # in-flight
                    jnp.zeros((4,), i32))   # episodes, fail, overflow, -

        def _col_idx(bi, lane, F):
            return ((bi[:, None] * F + jnp.arange(F)[None, :]) * block
                    + lane[:, None])

        def _run_q(bctx, bdyn, brngs, qstate, n_steps, want_traj=False):
            """Scan + device-side reset-queue build: returns (bdyn, brngs,
            qstate', any_new, resetq[, traj]) where resetq packs
            [count, idxs(Q), params(Q,4), frozen dyn columns] as i32.
            counters[3] accumulates dead steps (exact-mode metric).
            ``want_traj="packed"`` additionally returns the per-step
            learner-feed records, blocked (n_steps, nb, 5, block)."""
            bdyn, brngs, dead, traj = _scan(bctx, bdyn, brngs, n_steps,
                                            want_traj)
            inflight, counters = qstate
            newly = (bdyn[i_done] != 0) & (inflight == 0)
            nf = newly.reshape(n)            # env id = b*block + lane
            key = jnp.where(nf, jnp.arange(n, dtype=i32), n)
            idxs = jax.lax.sort(key)[:Q]
            valid = idxs < n
            count = jnp.sum(valid.astype(i32))
            safe = jnp.where(valid, idxs, jnp.minimum(idxs[0], n - 1))
            bi, lane = safe // block, safe % block
            # invalid (padding) slots carry idx = n: every downstream
            # scatter drops them (mode="drop"), so a COMPLETELY empty
            # queue applies as a no-op — required by the sharded runner,
            # where a global any_new gate can fire the apply program on
            # shards whose local queue is empty (parallel/runner.py)
            parts = [count[None], jnp.where(valid, idxs, n),
                     bctx[4][safe].reshape(-1)]
            for x, F in zip(bdyn, feat_sizes):
                g = x.reshape(-1)[_col_idx(bi, lane, F)]
                if g.dtype == jnp.float32:
                    g = jax.lax.bitcast_convert_type(g, i32)
                parts.append(g.reshape(-1))
            resetq = jnp.concatenate(parts)
            # mark ONLY the <=Q selected envs in-flight (scatter-max: the
            # count==0 dummy slot must not clear anything); finishers
            # beyond the queue stay done & un-flagged and are re-selected
            # at the next boundary
            inflight = inflight.reshape(-1).at[
                _col_idx(bi, lane, 1)].max(
                    valid.astype(i32)[:, None]).reshape(inflight.shape)
            counters = (counters
                        + jnp.where(jnp.arange(4) == 0, count, 0)
                        + jnp.where(jnp.arange(4) == 3, dead, 0))
            if want_traj:
                return (bdyn, brngs, (inflight, counters), count > 0,
                        resetq, traj)
            return (bdyn, brngs, (inflight, counters), count > 0, resetq)

        run_q = functools.partial(jax.jit, static_argnums=(4, 5),
                                  donate_argnums=(1, 2, 3))(_run_q)

        def _reset_q(rq):
            """Procgen for one reset queue -> one result buffer
            [idxs(Q), ok, overflow, min_xy(Q,2), map words (Q,MAPW),
            dyn words] (padding slots are duplicate resets of the same
            frozen env state — identical values, idempotent scatter)."""
            off = 1
            idxs = rq[off:off + Q]
            off += Q
            params = rq[off:off + 4 * Q].reshape(Q, 4)
            off += 4 * Q
            dyn = []
            for F, (_, fshape, fdtype) in zip(feat_sizes, feat):
                seg = rq[off:off + Q * F]
                off += Q * F
                if fdtype == jnp.float32:
                    seg = jax.lax.bitcast_convert_type(seg, jnp.float32)
                seg = seg.reshape((Q,) + fshape)
                if fdtype == jnp.bool_:
                    seg = seg != 0
                dyn.append(seg)
            n_players_q = params[:, 0]
            rng_q = dyn[E.DYN_FIELDS.index("rng")]
            gen, pxy, ball = jax.vmap(E.reset_map_prelude)(
                rng_q, params[:, 1], params[:, 2], n_players_q)
            dyn2 = jax.vmap(_reset_one)(tuple(dyn), pxy, ball, n_players_q)
            # padding slots (idx == n) regenerate garbage frozen columns;
            # their results are dropped by apply_q and must not poison
            # the ok/overflow reductions
            valid = idxs < n
            parts = [idxs,
                     jnp.all(gen.ok | ~valid).astype(i32)[None],
                     jnp.any(gen.overflow & valid).astype(i32)[None],
                     gen.min_xy.reshape(-1),
                     gen.ids.reshape(-1)]   # (Q*2304,) i32, layout-free
            for x in dyn2:
                if x.dtype == jnp.bool_:
                    x = x.astype(i32)
                elif x.dtype == jnp.float32:
                    x = jax.lax.bitcast_convert_type(x, i32)
                parts.append(x.reshape(-1))
            return jnp.concatenate(parts)

        # NOTE: ``states`` is caller-visible — never donated (the
        # env-major row updates copy the static leaves, ~70 MB at 4096
        # envs)
        def _apply_q(bdyn, bctx, states, qstate, buf):
            """Scatter one result buffer into the blocked carry, the ball
            table, the in-flight mask, and the env-major static state.
            Padding slots carry idx == n; every scatter uses mode="drop",
            so they (and a fully-empty queue) apply as a no-op."""
            tab, bmin, bnp, bms, bparams = bctx
            inflight, counters = qstate
            idxs = buf[:Q]
            ok, over = buf[Q], buf[Q + 1]
            off = Q + 2
            minxy = buf[off:off + 2 * Q].reshape(Q, 2)
            off += 2 * Q
            map_rows = buf[off:off + Q * MAPW].reshape(Q, MAPW)
            off += Q * MAPW
            bi, lane = idxs // block, idxs % block
            new_bdyn = []
            for x, F in zip(bdyn, feat_sizes):
                seg = buf[off:off + Q * F].reshape(Q, F)
                off += Q * F
                if x.dtype == jnp.float32:
                    seg = jax.lax.bitcast_convert_type(seg, jnp.float32)
                flat = x.reshape(-1).at[_col_idx(bi, lane, F)].set(
                    seg.astype(x.dtype), mode="drop")
                new_bdyn.append(flat.reshape(x.shape))
            trows = jax.vmap(E.pack_ball_word_table)(map_rows)  # (Q,72,128)
            tab = tab.at[idxs].set(trows, mode="drop")
            bmin = bmin.reshape(-1).at[_col_idx(bi, lane, 2)].set(
                minxy, mode="drop").reshape(bmin.shape)
            inflight = inflight.reshape(-1).at[
                _col_idx(bi, lane, 1)].set(0, mode="drop").reshape(
                    inflight.shape)
            counters = jnp.stack(
                [counters[0], counters[1] | (1 - ok),
                 counters[2] | over, counters[3]])
            states = states._replace(
                map_ids=states.map_ids.at[idxs].set(map_rows, mode="drop"),
                min_xy=states.min_xy.at[idxs].set(minxy, mode="drop"),
                map_ok=states.map_ok.at[idxs].set(ok != 0, mode="drop"),
                map_overflow=states.map_overflow.at[idxs].set(
                    over != 0, mode="drop"))
            return (tuple(new_bdyn), (tab, bmin, bnp, bms, bparams),
                    states, (inflight, counters))

        apply_q = functools.partial(jax.jit, donate_argnums=(0, 1, 3))(
            _apply_q)

        def _run_auto(bctx, bdyn, brngs, qstate, states, chunk):
            """One chunk, fully on device: the blocked step scan plus a
            lax.cond-gated reset_q+apply_q (taken only when an episode
            finished this chunk). The chunked rollout dispatches this
            n_chunks times WITHOUT any host synchronisation — no
            per-chunk `bool(any_new)` round trip and no separate
            reset/apply dispatches; dispatches pipeline asynchronously,
            and failure flags / episode / dead counters ride the qstate
            counters, read once at rollout end."""
            bdyn, brngs, qstate, has_new, resetq = _run_q(
                bctx, bdyn, brngs, qstate, chunk)

            def fire(args):
                bdyn, bctx, states, qs, rq = args
                return _apply_q(bdyn, bctx, states, qs, _reset_q(rq))

            def skip(args):
                return args[:4]

            bdyn, bctx, states, qstate = jax.lax.cond(
                has_new, fire, skip,
                (bdyn, bctx, states, qstate, resetq))
            return bctx, bdyn, brngs, qstate, states

        run_auto = functools.partial(jax.jit, static_argnums=(5,),
                                     donate_argnums=(0, 1, 2, 3))(
                                         _run_auto)

        def _run_auto_traj(bctx, bdyn, brngs, qstate, states, chunk,
                           want_traj):
            """run_auto that ALSO returns the chunk's packed per-step
            records: the fully-fused streaming chunk for on-device feed
            consumers (stream_rollout deliver=\"device\") — no host sync
            anywhere in the loop."""
            bdyn, brngs, qstate, has_new, resetq, traj = _run_q(
                bctx, bdyn, brngs, qstate, chunk, want_traj)

            def fire(args):
                bdyn, bctx, states, qs, rq = args
                return _apply_q(bdyn, bctx, states, qs, _reset_q(rq))

            def skip(args):
                return args[:4]

            bdyn, bctx, states, qstate = jax.lax.cond(
                has_new, fire, skip,
                (bdyn, bctx, states, qstate, resetq))
            return bctx, bdyn, brngs, qstate, states, traj

        run_auto_traj = functools.partial(
            jax.jit, static_argnums=(5, 6),
            donate_argnums=(0, 1, 2, 3))(_run_auto_traj)

        self.block = block
        self.n = n
        self.q_cap = Q
        self.block_in = block_in
        self.run = run
        self.unblock = unblock
        self.unblock_traj = unblock_traj
        self.unblock_packed = unblock_packed
        self.qstate_init = qstate_init
        self.run_q = run_q
        self.run_auto = run_auto
        self.run_auto_traj = run_auto_traj
        # runs where its input lives: the async path hands it a queue
        # placed on the host CPU device
        self.reset_q = jax.jit(_reset_q)
        self.apply_q = apply_q
        self.feat = feat
        # raw (unjitted) bodies, for composition inside shard_map
        # (parallel/runner.py builds per-shard programs from these)
        self.block_in_raw = _block_in
        self.scan_raw = _scan
        self.run_q_raw = _run_q
        self.reset_q_raw = _reset_q
        self.apply_q_raw = _apply_q
        self.unblock_raw = _unblock


def _kernel_programs(states, mask_src: str = "storage", block: int = 256,
                     gate_dead: bool = False) -> _KernelPrograms:
    n = int(states.rng.shape[0])
    key = (n, mask_src, min(block, n), gate_dead,
           tuple(states.map_ids.shape))
    if key not in _KERNEL_CACHE:
        _KERNEL_CACHE[key] = _KernelPrograms(states, mask_src,
                                             min(block, n), gate_dead)
    return _KERNEL_CACHE[key]


def kernel_rollout(states, sampler_rngs, n_steps: int,
                   mask_src: str = "storage", block: int = 256):
    """Rollout on the blocked carry (the programs behind
    ``rollout_chunked(backend="kernel")``): one vmapped
    engine.fused_sample_step plus one ball-row gather per step, under a
    lax.scan whose carry stays in the blocked env-minor layout. Same
    dead-step semantics as rollout(auto_reset='none')."""
    progs = _kernel_programs(states, mask_src, block)
    bctx, bdyn, brngs = progs.block_in(states, sampler_rngs)
    bdyn, brngs, _, _, traj = progs.run(bctx, bdyn, brngs, n_steps, True)
    out_states, rngs = progs.unblock(states, bdyn, brngs)
    return out_states, rngs, progs.unblock_traj(traj)


def rollout_chunked(states, sampler_rngs, n_steps: int, chunk: int = 100,
                    mask_src: str = "storage", backend: str = "xla",
                    block: int = 256, reset_mode: str = "sync",
                    exact: bool = False):
    """High-throughput driver: dispatch `chunk`-step scans and auto-reset
    finished envs between dispatches. Done envs dead-step until their
    chunk boundary.

    backend: "xla" scans the vmapped env-major step and resets through
    the host: a host-side `any(done)` check per chunk, then only the done
    envs are regenerated (bucketed). "kernel" scans the same step on a
    blocked carry (``block`` envs per block) that stays blocked across
    chunks, with resets queued on the device — same trajectory either
    way (tests/test_step_kernel.py, tests/test_api_surfaces.py).

    reset_mode (kernel backend only):
      * "sync" (default): done envs are regenerated ON DEVICE at the
        chunk boundary where the episode ended, via a compacted reset
        queue of up to ``_queue_cap(n)`` envs per boundary (same
        observable behaviour as the xla path while the finishers fit;
        extra finishers dead-step to the next boundary). No layout
        round-trip, no host transfers.
      * "async": the reset queue is shipped to the HOST CPU backend and
        its procgen overlaps the next chunk's device scan; results are
        scattered in at the following boundary (done envs dead-step one
        extra chunk; their frozen state makes the deferred reset
        value-identical).

    exact (kernel backend only): freeze finished envs completely — dead
    steps consume NO sampler draws, so every env's step sequence with
    dead steps excluded is bit-exact against the reference's continuous
    same-step auto-reset trajectories (vec_cog_env::step_single,
    include/vec_environment.h:53-61; tested in tests/test_exact_reset.py).
    Returns (states, srngs, episodes, dead_steps): the honest exact-mode
    throughput metric is (n_envs * n_steps - dead_steps) / wall."""
    import numpy as np
    episodes = 0
    n_chunks = max(1, n_steps // chunk)
    if backend == "kernel":
        return _rollout_chunked_q(states, sampler_rngs, n_chunks, chunk,
                                  mask_src, block, reset_mode, exact)
    assert not exact, "exact mode rides the kernel backend"
    for _ in range(n_chunks):
        states, sampler_rngs, _ = rollout(states, sampler_rngs, chunk,
                                          mask_src, "none")
        done = np.asarray(states.done)
        if done.any():
            states, n = reset_done_bucketed(states, done)
            episodes += n
    return states, sampler_rngs, episodes


def _rollout_chunked_q(states, sampler_rngs, n_chunks, chunk,
                       mask_src, block, reset_mode, exact=False):
    """rollout_chunked's kernel backend with compacted reset queues: see
    rollout_chunked. The host blocks on exactly ONE scalar per chunk
    (`any_new`); episode / procgen-failure accounting rides in
    device-side counters read once at the end.

    reset_mode="sync": run_q -> reset_q -> apply_q all on device at
    the same boundary. reset_mode="async": the queue round-trips through
    the host CPU backend, overlapped with the next chunk's scan, and is
    applied one boundary later."""
    import numpy as np
    from .errors import GenerateMapFailure, MapCapacityError
    progs = _kernel_programs(states, mask_src, block, gate_dead=exact)
    deferred = reset_mode == "async"
    if deferred:
        cpu = jax.devices("cpu")[0]
        dev = states.rng.devices().pop()
    bctx, bdyn, brngs = progs.block_in(states, sampler_rngs)
    qstate = progs.qstate_init()
    pending = None

    if not deferred:
        # sync mode: per chunk, ONE fused device program (step scan +
        # cond-gated reset apply); dispatches pipeline with no host
        # round trips anywhere in the loop (see _run_auto)
        for _ in range(n_chunks):
            bctx, bdyn, brngs, qstate, states = progs.run_auto(
                bctx, bdyn, brngs, qstate, states, chunk)
    else:
        for _ in range(n_chunks):
            bdyn, brngs, qstate, any_new, resetq = progs.run_q(
                bctx, bdyn, brngs, qstate, chunk)
            if pending is not None:
                bdyn, bctx, states, qstate = progs.apply_q(
                    bdyn, bctx, states, qstate, pending)
                pending = None
            if bool(any_new):
                buf = progs.reset_q(jax.device_put(resetq, cpu))
                pending = jax.device_put(buf, dev)
        if pending is not None:
            bdyn, bctx, states, qstate = progs.apply_q(
                bdyn, bctx, states, qstate, pending)
    counters = np.asarray(qstate[1])
    episodes = int(counters[0])
    states, sampler_rngs = progs.unblock(states, bdyn, brngs)
    if counters[2]:
        raise MapCapacityError(
            "queued reset: map generation overflowed a fixed capacity")
    if counters[1]:
        raise GenerateMapFailure(
            "queued reset: map generation failed > MAX_FAILURES times")
    # envs that finished in the last chunk (or beyond the Q-slot queue)
    # get the synchronous sweep, preserving the auto-reset contract
    if np.asarray(states.done).any():
        states, k = reset_done_bucketed(states)
        episodes += k
    if exact:
        return states, sampler_rngs, episodes, int(counters[3])
    return states, sampler_rngs, episodes


class VecEnv:
    """Thin stateful wrapper mirroring the reference Python API shape
    (src/pybind/vectorized.cpp): get_vec_env(N)-style usage with
    zero-copy-equivalent device arrays instead of numpy views."""

    def __init__(self, n_envs: int, mask_src: str = "storage"):
        self.n_envs = n_envs
        self.mask_src = mask_src
        self.states = None
        self.sampler_rngs = None

    def reset(self, seed=0, n_players=4, n_pieces=3, difficulty=0,
              max_steps=100000, sampler_seed=42):
        self.states = vec_reset(seed, self.n_envs, n_players, n_pieces,
                                difficulty, max_steps)
        self.sampler_rngs = sampler_init(sampler_seed, self.n_envs)
        return self.observations

    def step(self, actions):
        self.states, done = vec_step(self.states, actions)
        return done

    def sample(self):
        actions, self.sampler_rngs, tainted = vec_sample(
            self.sampler_rngs, _active_mask(self.states, self.mask_src))
        self.states = self.states._replace(
            rng_tainted=self.states.rng_tainted | tainted)
        return actions

    # -- reference observation surface ------------------------------------
    @property
    def observations(self):
        s = self.states
        return {
            "map": jax.vmap(E.expand_obs)(s.map_ids), "phase": s.phase,
            "current_resources": s.resources, "shop": s.shop_stock,
            "piles": s.piles,
            "action_masks": E.unpack_mask(s.storage_masks),
        }

    @property
    def selected_action_masks(self):
        return E.unpack_mask(self.states.sel_mask)

    @property
    def agent_selection(self):
        return self.states.agent

    @property
    def dones(self):
        return self.states.done

    @property
    def rewards(self):
        return self.states.rewards

    @property
    def infos(self):
        s = self.states
        return {
            "total_length": s.info_total, "steps_taken": s.info_steps,
            "returns": s.info_returns, "travelled_hexes": s.info_travelled,
            "cards_added": s.info_added, "cards_removed": s.info_removed,
            "n_machete_uses": jnp.zeros_like(s.info_travelled),
            "n_paddle_uses": jnp.zeros_like(s.info_travelled),
            "n_coin_uses": jnp.zeros_like(s.info_travelled),
            "n_card_uses": s.info_card_uses,
        }
