"""Sharded rollout runner: the multi-chip replacement for ThreadedRunner.

The reference's ThreadedRunner<N> statically partitions envs across pinned
threads and fans out STEP/SAMPLE commands over SPSC queues (reference:
include/runner.h:13-134). Here the partition is a sharded batch axis over a
`Mesh`, the command fan-out is SPMD program dispatch, and the spin-wait sync
is replaced by XLA's dataflow: one jitted program runs the whole slice in
lockstep, with `psum` reductions over the mesh axes standing in for the
shared-memory result buffers (the "learner feed").

Every program is built exactly once per (mesh, n_steps, mask_src) — repeat
`step()`/`sample()` calls dispatch the cached executable with no retrace
(`_trace_count` observably stops increasing; asserted in
tests/test_parallel.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core import engine as E
from ..vec import _batch_select
from .mesh import ENV_AXES, env_sharding, replicated, shard_envs

_vstep = jax.vmap(E.step_env)
_vreset = jax.vmap(E.reset_env)

# incremented once per program trace; a cache-hit dispatch leaves it alone
_trace_count = [0]


def _masks(s, mask_src):
    if mask_src == "storage":
        return E.unpack_mask(jnp.take_along_axis(
            s.storage_masks, s.agent[:, None, None], axis=1)[:, 0])
    return E.unpack_mask(s.sel_mask)


def _local_rollout_body(s, rngs, mask_src):
    actions, rngs, tainted = jax.vmap(E.sample_action)(
        rngs, _masks(s, mask_src))
    s = _vstep(s, actions)
    s = s._replace(rng_tainted=s.rng_tainted | tainted)
    done = s.done
    s = jax.lax.cond(jnp.any(done),
                     lambda x: _batch_select(done, _vreset(x), x),
                     lambda x: x, s)
    return s, rngs, actions, done


@functools.lru_cache(maxsize=None)
def _build_rollout(mesh: Mesh, n_steps: int, mask_src: str):
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(ENV_AXES), P(ENV_AXES)),
        out_specs=(P(ENV_AXES), P(ENV_AXES), P()),
        check_vma=False)
    def run(states, rngs):
        _trace_count[0] += 1

        def body(carry, _):
            s, r, eps, ret = carry
            s, r, _, done = _local_rollout_body(s, r, mask_src)
            eps = eps + jnp.sum(done, dtype=jnp.int32)
            ret = ret + jnp.sum(jnp.where(done[:, None], s.rewards, 0.0))
            return (s, r, eps, ret), ()

        (states, rngs, eps, ret), _ = jax.lax.scan(
            body, (states, rngs, jnp.int32(0), jnp.float32(0.0)), None,
            length=n_steps)
        # collectives ride the mesh axes
        eps = jax.lax.psum(eps, ENV_AXES)
        ret = jax.lax.psum(ret, ENV_AXES)
        stats = {"episodes": eps, "return_sum": ret,
                 "steps": jnp.int32(n_steps)}
        return states, rngs, stats

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _build_sample(mesh: Mesh, mask_src: str):
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(ENV_AXES), P(ENV_AXES)),
        out_specs=(P(ENV_AXES), P(ENV_AXES), P(ENV_AXES)),
        check_vma=False)
    def run(states, rngs):
        _trace_count[0] += 1
        actions, rngs, tainted = jax.vmap(E.sample_action)(
            rngs, _masks(states, mask_src))
        return actions, rngs, tainted

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _build_step(mesh: Mesh):
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(ENV_AXES), P(ENV_AXES)),
        out_specs=P(ENV_AXES),
        check_vma=False)
    def run(states, actions):
        _trace_count[0] += 1
        s = _vstep(states, actions)
        done = s.done
        return jax.lax.cond(jnp.any(done),
                            lambda x: _batch_select(done, _vreset(x), x),
                            lambda x: x, s)

    return jax.jit(run)


# ------------------------------------------------------------------ kernel
# Kernel-backend sharded rollouts: the blocked step scan + on-device
# queued auto-resets (vec._KernelPrograms) run PER SHARD inside
# shard_map, so the single-device path carries onto meshes. This is the
# multi-chip analogue of the reference's per-worker env loop (reference:
# include/runner.h:36-62 statically partitions envs across threads; here
# the partition is the mesh and each shard runs the blocked scan over
# its slice). The host blocks on ONE replicated scalar per
# chunk (`any_new`, psum'd over the mesh); reset procgen runs only on
# shards whose local queue is non-empty (a per-device lax.cond — SPMD
# control flow diverges freely here because the branches contain no
# collectives).


class _ShardedKernelPrograms:
    """shard_map-wrapped versions of one local-shape _KernelPrograms."""

    def __init__(self, mesh: Mesh, n: int, mask_src: str, block: int,
                 gate_dead: bool = False):
        from .. import vec as V
        n_dev = int(mesh.devices.size)
        assert n % n_dev == 0, (n, n_dev)
        n_local = n // n_dev
        block = min(block, n_local)
        assert n_local % block == 0, (n_local, block)
        template = jax.vmap(lambda s: E.make_state(s))(
            jnp.arange(n_local, dtype=jnp.uint32))
        progs = V._kernel_programs(template, mask_src, block, gate_dead)
        self.local = progs
        self.mesh = mesh
        self.n = n
        self.block = block
        self.n_dev = n_dev

        ax = P(ENV_AXES)
        shmap = functools.partial(jax.shard_map, mesh=mesh,
                                  check_vma=False)
        from jax.sharding import NamedSharding
        shard0 = NamedSharding(mesh, ax)

        # ---- block_in / unblock -------------------------------------
        # Pure per-env layout transforms: global blocking (env e ->
        # block e//block, lane e%block, blocks contiguous per device)
        # produces byte-identical per-device buffers to per-shard
        # blocking, so these run as plain jit with first-axis sharding
        # constraints, which keeps the transposes out of shard_map. The
        # scan itself (run_q) stays shard_map — its per-shard compaction
        # is genuine local-view work.
        def _sharded0(tree):
            return jax.tree_util.tree_map(
                lambda x: jax.lax.with_sharding_constraint(x, shard0),
                tree)

        feat = progs.feat
        t_in_g, t_out_g = V._blocked_layout(n, block)

        @jax.jit
        def block_in(states, rngs):
            _trace_count[0] += 1
            _, dyn = E.split_state(states)
            tabs = jax.vmap(E.pack_ball_word_table)(states.map_ids)
            bparams = jnp.stack(
                [states.n_players, states.n_pieces, states.difficulty,
                 states.max_steps], axis=-1)
            bctx = (tabs, t_in_g(states.min_xy), t_in_g(states.n_players),
                    t_in_g(states.max_steps), bparams)
            bdyn = tuple(
                t_in_g(x.astype(jnp.int32) if x.dtype == jnp.bool_ else x)
                for x in dyn)
            return _sharded0((bctx, bdyn, t_in_g(rngs)))

        @jax.jit
        def unblock(states, bdyn, brngs):
            _trace_count[0] += 1
            static, _ = E.split_state(states)
            new_dyn = []
            for o, (_, fshape, fdtype) in zip(bdyn, feat):
                o = t_out_g(o, fshape)
                if fdtype == jnp.bool_:
                    o = o != 0
                new_dyn.append(o)
            return _sharded0((E.merge_state(static, tuple(new_dyn)),
                              t_out_g(brngs, ())))

        # ---- chunk scan + queue build --------------------------------
        @functools.partial(jax.jit, static_argnums=(4,),
                           donate_argnums=(1, 2, 3))
        def run_q(bctx, bdyn, brngs, qstate, n_steps):
            @functools.partial(
                shmap, in_specs=(ax, ax, ax, (ax, ax)),
                out_specs=(ax, ax, (ax, ax), P(), ax))
            def run(bctx, bdyn, brngs, qstate):
                _trace_count[0] += 1
                inflight, counters1 = qstate
                bdyn, brngs, (inflight, counters), has_new, resetq = \
                    progs.run_q_raw(bctx, bdyn, brngs,
                                    (inflight, counters1[0]), n_steps)
                any_new = jax.lax.psum(
                    has_new.astype(jnp.int32), ENV_AXES) > 0
                return (bdyn, brngs, (inflight, counters[None]),
                        any_new, resetq[None])
            return run(bctx, bdyn, brngs, qstate)

        # ---- per-shard reset + apply ---------------------------------
        @functools.partial(jax.jit, donate_argnums=(0, 1, 3))
        @functools.partial(
            shmap, in_specs=(ax, ax, ax, (ax, ax), ax),
            out_specs=(ax, ax, ax, (ax, ax)))
        def reset_apply(bdyn, bctx, states, qstate, resetq):
            _trace_count[0] += 1
            inflight, counters1 = qstate
            buf = resetq[0]
            qs = (inflight, counters1[0])

            def fire(args):
                bdyn, bctx, states, qs = args
                return progs.apply_q_raw(bdyn, bctx, states, qs,
                                         progs.reset_q_raw(buf))

            bdyn, bctx, states, qs = jax.lax.cond(
                buf[0] > 0, fire, lambda a: a, (bdyn, bctx, states, qs))
            return bdyn, bctx, states, (qs[0], qs[1][None])

        # ---- fused chunk: scan + per-shard cond-gated reset apply ----
        # No host synchronisation anywhere (the unsharded _run_auto
        # design): dispatches pipeline, SPMD control flow diverges
        # freely per shard (the reset branches contain no collectives),
        # counters are read once at rollout end.
        @functools.partial(jax.jit, static_argnums=(5,),
                           donate_argnums=(0, 1, 2, 3))
        def run_auto(bctx, bdyn, brngs, qstate, states, chunk):
            @functools.partial(
                shmap, in_specs=(ax, ax, ax, (ax, ax), ax),
                out_specs=(ax, ax, ax, (ax, ax), ax))
            def go(bctx, bdyn, brngs, qstate, states):
                _trace_count[0] += 1
                inflight, counters1 = qstate
                bdyn, brngs, qs, has_new, resetq = progs.run_q_raw(
                    bctx, bdyn, brngs, (inflight, counters1[0]), chunk)

                def fire(args):
                    bdyn, bctx, states, qs = args
                    return progs.apply_q_raw(
                        bdyn, bctx, states, qs, progs.reset_q_raw(resetq))

                bdyn, bctx2, states, qs = jax.lax.cond(
                    has_new, fire, lambda a: a,
                    (bdyn, bctx, states, qs))
                return bctx2, bdyn, brngs, (qs[0], qs[1][None]), states
            return go(bctx, bdyn, brngs, qstate, states)

        # ---- fused streaming chunk: scan + records + per-shard fold --
        # The learner feed on the multi-chip path: each shard emits its
        # blocked per-step records (stream.pack_step_blocked /
        # pack_step_full_blocked layouts) and folds them into a
        # PER-SHARD consumer carry INSIDE shard_map — the trajectory
        # never leaves its device, exactly like the single-chip
        # deliver="device" path. Carry leaves ride a leading (n_dev,)
        # row axis (the counters pattern); combine rows on the host
        # (sums/xors are order-independent, so results are bit-identical
        # to the unsharded fold — asserted in tests/test_parallel.py).
        @functools.partial(jax.jit, static_argnums=(6, 7, 8),
                           donate_argnums=(0, 1, 2, 3, 5))
        def run_auto_stream(bctx, bdyn, brngs, qstate, states, carry,
                            chunk, want_traj, fold):
            @functools.partial(
                shmap, in_specs=(ax, ax, ax, (ax, ax), ax, ax),
                out_specs=(ax, ax, ax, (ax, ax), ax, ax))
            def go(bctx, bdyn, brngs, qstate, states, carry):
                _trace_count[0] += 1
                inflight, counters1 = qstate
                bdyn, brngs, qs, has_new, resetq, traj = progs.run_q_raw(
                    bctx, bdyn, brngs, (inflight, counters1[0]), chunk,
                    want_traj)

                def fire(args):
                    bdyn, bctx, states, qs = args
                    return progs.apply_q_raw(
                        bdyn, bctx, states, qs, progs.reset_q_raw(resetq))

                bdyn, bctx2, states, qs = jax.lax.cond(
                    has_new, fire, lambda a: a,
                    (bdyn, bctx, states, qs))
                local = jax.tree_util.tree_map(lambda x: x[0], carry)
                local = fold(local, traj)
                carry = jax.tree_util.tree_map(lambda x: x[None], local)
                return (bctx2, bdyn, brngs, (qs[0], qs[1][None]), states,
                        carry)
            return go(bctx, bdyn, brngs, qstate, states, carry)

        self.block_in = block_in
        self.unblock = unblock
        self.run_q = run_q
        self.run_auto = run_auto
        self.run_auto_stream = run_auto_stream
        self.reset_apply = reset_apply

    def qstate_init(self):
        """Global queue state: in-flight mask in the blocked layout,
        per-shard counter rows (episodes, fail, overflow, -)."""
        sh = env_sharding(self.mesh)
        inflight = jax.device_put(
            jnp.zeros((self.n // self.block, 1, self.block), jnp.int32), sh)
        counters = jax.device_put(
            jnp.zeros((self.n_dev, 4), jnp.int32), sh)
        return (inflight, counters)


@functools.lru_cache(maxsize=None)
def _sharded_kernel_programs(mesh: Mesh, n: int, mask_src: str, block: int,
                             gate_dead: bool = False
                             ) -> _ShardedKernelPrograms:
    return _ShardedKernelPrograms(mesh, n, mask_src, block, gate_dead)


def sharded_kernel_rollout(mesh: Mesh, states, sampler_rngs, n_steps: int,
                           chunk: int = 1500, mask_src: str = "storage",
                           block: int = 1024, exact: bool = False):
    """vec.rollout_chunked(backend="kernel", reset_mode="sync") over a
    device mesh: per-shard blocked scans with on-device queued
    auto-resets at chunk boundaries. Returns (states, sampler_rngs,
    episodes). Same observable semantics as the single-device kernel
    path (bit-identical when per-boundary finishers fit the queues —
    asserted in tests/test_parallel.py).

    ``exact=True`` freezes finished envs completely (no sampler draws on
    dead steps), making per-env trajectories bit-exact vs the
    reference's continuous same-step auto-reset streams, and returns
    (states, sampler_rngs, episodes, dead_steps) — the multi-chip form
    of vec.rollout_chunked(exact=True)."""
    import numpy as np
    from ..errors import GenerateMapFailure, MapCapacityError
    from ..vec import reset_done_bucketed

    n = int(states.rng.shape[0])
    progs = _sharded_kernel_programs(mesh, n, mask_src, block, exact)
    sh = env_sharding(mesh)
    states = shard_envs(states, mesh)
    sampler_rngs = jax.device_put(sampler_rngs, sh)

    bctx, bdyn, brngs = progs.block_in(states, sampler_rngs)
    qstate = progs.qstate_init()
    n_chunks = max(1, n_steps // chunk)
    # fused per-chunk program (scan + per-shard cond-gated resets):
    # dispatches pipeline with no host round trips in the loop
    for _ in range(n_chunks):
        bctx, bdyn, brngs, qstate, states = progs.run_auto(
            bctx, bdyn, brngs, qstate, states, chunk)
    counters = np.asarray(qstate[1]).sum(axis=0)
    states, sampler_rngs = progs.unblock(states, bdyn, brngs)
    episodes = int(counters[0])
    if counters[2]:
        raise MapCapacityError(
            "sharded queued reset: map generation overflowed a capacity")
    if counters[1]:
        raise GenerateMapFailure(
            "sharded queued reset: map generation failed > MAX_FAILURES")
    if np.asarray(states.done).any():
        states, k = reset_done_bucketed(states)
        episodes += k
        states = shard_envs(states, mesh)
    if exact:
        return states, sampler_rngs, episodes, int(counters[3])
    return states, sampler_rngs, episodes


def sharded_stream_rollout(mesh: Mesh, states, sampler_rngs, n_steps: int,
                           chunk: int = 300, mask_src: str = "storage",
                           block: int = 1024, record: str = "full",
                           device_fn=None, device_carry=None,
                           exact: bool = False):
    """The learner feed on the multi-chip path: per-shard blocked scans
    emit packed per-step records (compact 5-word or full 40-word —
    eldorado_tpu.stream layouts) and fold them into a per-shard consumer
    carry ON DEVICE inside shard_map, with cond-gated queued auto-resets
    at chunk boundaries and no host sync in the loop. This serves what
    the reference runner's shared observation views serve — training
    data for all N envs regardless of worker count (reference:
    include/runner.h:93-100, include/pybind/vectorized.h:60-150) — as
    device-resident consumption rather than host pointers.

    ``device_fn(carry, traj_blocked)`` (default stream.device_stats_fn)
    folds one LOCAL shard's (chunk, nb_local, W, block) records;
    ``device_carry`` is the single-shard initial carry (default
    stream.device_stats_init()), replicated into per-shard rows. Returns
    (states, sampler_rngs, episodes, carry_rows[, dead]) where
    carry_rows leaves have a leading (n_devices,) axis — combine with an
    order-independent reduction (sum/xor) for results bit-identical to
    the single-device stream_rollout fold (tests/test_parallel.py)."""
    import numpy as np
    from ..errors import GenerateMapFailure, MapCapacityError
    from ..vec import reset_done_bucketed
    from .. import stream as S

    n = int(states.rng.shape[0])
    progs = _sharded_kernel_programs(mesh, n, mask_src, block, exact)
    want = "packed" if record == "compact" else "full"
    if device_fn is None:
        device_fn = S.device_stats_fn
        device_carry = S.device_stats_init()
    sh = env_sharding(mesh)
    states = shard_envs(states, mesh)
    sampler_rngs = jax.device_put(sampler_rngs, sh)
    n_dev = int(mesh.devices.size)
    carry = jax.device_put(
        jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(jnp.asarray(x)[None],
                                       (n_dev,) + jnp.shape(x)),
            device_carry), sh)

    bctx, bdyn, brngs = progs.block_in(states, sampler_rngs)
    qstate = progs.qstate_init()
    n_chunks = max(1, n_steps // chunk)
    for _ in range(n_chunks):
        bctx, bdyn, brngs, qstate, states, carry = progs.run_auto_stream(
            bctx, bdyn, brngs, qstate, states, carry, chunk, want,
            device_fn)
    counters = np.asarray(qstate[1]).sum(axis=0)
    states, sampler_rngs = progs.unblock(states, bdyn, brngs)
    episodes = int(counters[0])
    if counters[2]:
        raise MapCapacityError(
            "sharded stream: map generation overflowed a capacity")
    if counters[1]:
        raise GenerateMapFailure(
            "sharded stream: map generation failed > MAX_FAILURES")
    if np.asarray(states.done).any():
        states, k = reset_done_bucketed(states)
        episodes += k
        states = shard_envs(states, mesh)
    if exact:
        return states, sampler_rngs, episodes, carry, int(counters[3])
    return states, sampler_rngs, episodes, carry


def sharded_rollout(mesh: Mesh, states, sampler_rngs, n_steps: int,
                    mask_src: str = "storage"):
    """n_steps of lockstep sample+step+auto-reset over the sharded env batch,
    plus a psum-reduced stats feed (episodes finished, summed returns) — the
    pattern a sharded learner consumes instead of the reference's
    shared-memory observation views.

    Returns (states, sampler_rngs, stats) with stats replicated on every
    device: {"episodes": i32, "return_sum": f32, "steps": i32}.
    """
    return _build_rollout(mesh, n_steps, mask_src)(states, sampler_rngs)


class ShardedRunner:
    """Stateful facade mirroring the reference runner's contract
    (reference: include/runner.h:93-100, pybind/vectorized.h:154-160):
    `sample()` fills the persistent actions buffer from the current masks,
    `step()` applies it asynchronously (XLA async dispatch replaces the SPSC
    queues), `sync()` blocks, `step_sync()` = step + sync. `rollout(n)` is
    the high-throughput fused driver with the psum stats feed."""

    def __init__(self, mesh: Mesh, n_envs: int, mask_src: str = "storage"):
        from ..vec import sampler_init, vec_reset
        self.mesh = mesh
        self.n_envs = n_envs
        self.mask_src = mask_src
        self._vec_reset = vec_reset
        self._sampler_init = sampler_init
        self.states = None
        self.sampler_rngs = None
        self.actions = None
        self._pending = None

    def reset(self, seed=0, n_players=4, n_pieces=3, difficulty=0,
              max_steps=100000, sampler_seed=42):
        if jax.process_count() > 1:
            # pod path: each host builds only its own rows
            # (parallel/bootstrap.py), no global materialisation anywhere
            from .bootstrap import vec_reset_distributed
            self.states, self.sampler_rngs = vec_reset_distributed(
                self.mesh, seed, self.n_envs, n_players, n_pieces,
                difficulty, max_steps, sampler_seed)
        else:
            self.states = shard_envs(
                self._vec_reset(seed, self.n_envs, n_players, n_pieces,
                                difficulty, max_steps), self.mesh)
            rngs = self._sampler_init(sampler_seed, self.n_envs)
            self.sampler_rngs = jax.device_put(rngs,
                                               env_sharding(self.mesh))
        # null actions until the first sample() — matches the reference's
        # zero-initialised persistent actions array (vec_sampler.h:7-28)
        self.actions = jax.device_put(
            jnp.zeros((self.n_envs, 5), jnp.uint8),
            env_sharding(self.mesh))

    def attach(self, states, sampler_rngs):
        """Adopt externally-constructed sharded (states, sampler_rngs) —
        e.g. from bootstrap.vec_reset_distributed on a pod."""
        self.states = states
        self.sampler_rngs = sampler_rngs
        self.actions = jax.device_put(
            jnp.zeros((self.n_envs, 5), jnp.uint8),
            env_sharding(self.mesh))

    def sample(self):
        """Fill the persistent actions buffer (reference runner.h:87-94
        SAMPLE broadcast)."""
        self.actions, self.sampler_rngs, tainted = _build_sample(
            self.mesh, self.mask_src)(self.states, self.sampler_rngs)
        self.states = self.states._replace(
            rng_tainted=self.states.rng_tainted | tainted)
        return self.actions

    def step(self):
        """One lockstep env step applying the current actions buffer;
        returns immediately (async dispatch)."""
        self.states = _build_step(self.mesh)(self.states, self.actions)
        self._pending = self.states
        return self.states.done

    def step_sync(self):
        done = self.step()
        self.sync()
        return done

    def rollout(self, n_steps: int):
        """Fused sample+step scan; returns the replicated stats feed."""
        self.states, self.sampler_rngs, stats = sharded_rollout(
            self.mesh, self.states, self.sampler_rngs, n_steps,
            self.mask_src)
        self._pending = self.states
        return stats

    def rollout_chunked(self, n_steps: int, chunk: int = 1500,
                        block: int = 1024):
        """Kernel-backed high-throughput driver: per-shard blocked step
        scans + queued on-device auto-resets (sharded_kernel_rollout).
        Returns {"episodes", "steps"}."""
        self.states, self.sampler_rngs, episodes = sharded_kernel_rollout(
            self.mesh, self.states, self.sampler_rngs, n_steps, chunk,
            self.mask_src, block)
        self._pending = self.states
        return {"episodes": episodes, "steps": n_steps}

    def stream_rollout(self, n_steps: int, chunk: int = 300,
                       block: int = 1024, record: str = "full",
                       device_fn=None, device_carry=None):
        """The multi-chip learner feed (sharded_stream_rollout): per-shard
        packed records folded on device. Returns {"episodes", "steps",
        "carry"} with carry rows per device."""
        (self.states, self.sampler_rngs, episodes,
         carry) = sharded_stream_rollout(
            self.mesh, self.states, self.sampler_rngs, n_steps, chunk,
            self.mask_src, block, record, device_fn, device_carry)
        self._pending = self.states
        return {"episodes": episodes, "steps": n_steps, "carry": carry}

    def sync(self):
        if self._pending is not None:
            jax.block_until_ready(self._pending.rng)
            self._pending = None
        return self.states
