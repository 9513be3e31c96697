#!/usr/bin/env python3
"""Chip smoke test: drive the rollout engine's main path once on a GPU.

    python chip_smoke.py          # one card: every phase below, in order
    python chip_smoke.py --four   # four cards: the sharded runners only

One process. The deployment is bench.py's: 4096 lockstep envs, 4 players,
3 pieces, EASY, max_steps=100000, masked-random self-play from fixed
seeds, with episodes ending (and resetting on the device) mid-run.

Phases, each an importable function (tests/test_chip_smoke.py runs them on
the CPU at a few envs):

1. ``device_check``: the first JAX device must be a GPU; prints the card's
   name and power limit (nvidia-smi) and its ``device_kind``.
2. ``parity``: the C++ oracle's golden trajectories and maps
   (tests/golden) replayed through the jitted engine on the card, and the
   XLA wrong-code canary; bit-exact.
3. ``main_path``: ``rollout_chunked(backend="kernel")`` (blocked carry,
   on-device queued resets) against ``backend="xla"`` (host-bucketed
   resets) at the same seeds: every EnvState leaf and the episode count
   equal.
4. ``exact_mode``: ``exact=True``, its dead fraction, and the
   continuous-stream property on a 64-env slice.
5. ``learner_feeds``: compact and full records delivered on the device,
   and through the host ring plain and compressed, with one record
   checksum across all three compact deliveries; ObsReconstructor
   field-exact on a small slice.
6. ``async_resets``: ``reset_mode="async"`` with map generation checked.

``--four`` runs only ``sharded_path``: the sharded kernel and stream
runners on a 4-device mesh at 4 x 4096 envs against the unsharded path at
16384 envs, and ShardedRunner.rollout against vec.rollout.

Each phase prints its wall time (compilation included), env-steps/s and
peak device memory, for information. The last line of standard output is
``{"ok": true, "device": {...}}``; a failed phase raises, so the process
exits non-zero without printing it.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(ROOT, ".jax_cache"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# effective even when jax was imported before the variable was set
jax.config.update("jax_compilation_cache_dir",
                  os.environ["JAX_COMPILATION_CACHE_DIR"])

GOLDEN = os.path.join(ROOT, "tests", "golden")
N_ENVS = 4096
CHUNK = 1500
BLOCK = 1024

# (golden file, storage-mask sampling, max_steps, step limit); the maps
# of reset steps are compared for every case
TRAJ_CASES = (
    ("traj_2p_easy", False, 100000, 1500),
    ("traj_trunc", False, 100, None),
    ("traj_win_4p", False, 100000, 1500),
    ("traj_2p_easy_storage", True, 100000, 1500),
    ("traj_trunc_storage", True, 100, None),
    ("traj_win_storage", True, 100000, 2500),
)
MAPGEN_CASES = (
    ("mapgen_easy", 3, 0), ("mapgen_medium", 3, 1), ("mapgen_hard", 3, 2),
    ("mapgen_1p", 1, 0), ("mapgen_2p", 3, 0), ("mapgen_8p_medium", 8, 1),
    ("mapgen_10p_hard", 10, 2), ("mapgen_throw_easy4", 4, 0),
)
TRAJ_FIELDS = ("actions", "done", "agent", "phase", "rewards", "resources",
               "shop", "piles", "sel_mask", "storage_masks", "info_total",
               "info_steps", "info_returns", "info_travelled", "info_added",
               "info_removed", "info_card_uses")


class SmokeFailure(AssertionError):
    pass


def _check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _report(phase, t0, env_steps=None, **extra):
    dt = time.perf_counter() - t0
    parts = [f"{phase}: {dt:.1f} s"]
    if env_steps:
        parts.append(f"{env_steps / dt:,.0f} env-steps/s incl. compile")
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        parts.append(f"peak {stats['peak_bytes_in_use'] / 2**30:.2f} GiB")
    parts += [f"{k}={v}" for k, v in extra.items()]
    print(", ".join(parts), flush=True)


def _batch(n, max_steps=100000, seed=12345, pieces=3, sampler_seed=42):
    from eldorado_tpu import vec
    return (vec.vec_reset(seed, n, 4, pieces, 0, max_steps),
            vec.sampler_init(sampler_seed, n))


def _same_states(a, b, what):
    from eldorado_tpu.core import engine as E
    for name in E.EnvState._fields:
        _check(np.array_equal(np.asarray(getattr(a, name)),
                              np.asarray(getattr(b, name))),
               f"{what}: EnvState.{name} differs")


# ------------------------------------------------------------------ phases
def device_check():
    """Fail unless JAX's first device is a GPU; print the card."""
    dev = jax.devices()[0]
    _check(dev.platform == "gpu",
           f"no GPU: JAX's first device is {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"device_kind: {dev.device_kind}, devices: {len(jax.devices())}",
          flush=True)
    return dev


def _replay_program(T):
    """All golden trajectory cases as one vmapped scan: sample -> step ->
    auto-reset, recording every compared field per step."""
    from eldorado_tpu import vec
    from eldorado_tpu.core import engine as E
    from eldorado_tpu.ops.rng import seed as rseed

    vstep = jax.vmap(E.step_env)
    vreset = jax.vmap(E.reset_env)

    @jax.jit
    def run(es, ss, n_players, n_pieces, diff, max_steps, storage):
        s0 = vreset(jax.vmap(E.make_state)(es, n_players, n_pieces, diff,
                                           max_steps))

        def body(carry, _):
            s, rng = carry
            row = jnp.take_along_axis(s.storage_masks,
                                      s.agent[:, None, None], axis=1)[:, 0]
            src = E.unpack_mask(jnp.where(storage[:, None], row, s.sel_mask))
            act, rng, tainted = jax.vmap(E.sample_action)(rng, src)
            s = vstep(s, act)
            s = s._replace(rng_tainted=s.rng_tainted | tainted)
            done = s.done
            s = jax.lax.cond(jnp.any(done),
                             lambda x: vec._batch_select(done, vreset(x), x),
                             lambda x: x, s)
            rec = dict(
                actions=act.astype(jnp.uint8), done=done, agent=s.agent,
                phase=s.phase, rewards=s.rewards, resources=s.resources,
                shop=s.shop_stock, piles=s.piles, sel_mask=s.sel_mask,
                storage_masks=s.storage_masks, info_total=s.info_total,
                info_steps=s.info_steps, info_returns=s.info_returns,
                info_travelled=s.info_travelled, info_added=s.info_added,
                info_removed=s.info_removed,
                info_card_uses=s.info_card_uses,
                rng_tainted=s.rng_tainted, map_ids=s.map_ids)
            return (s, rng), rec

        _, traj = jax.lax.scan(body, (s0, jax.vmap(rseed)(ss)), None,
                               length=T)
        return s0, traj

    return run


def parity(limit=None, golden=GOLDEN):
    """Golden replay + mapgen + XLA canary, bit-exact. ``limit`` caps the
    replayed steps per trajectory (small runs)."""
    from eldorado_tpu.core import cells as C
    from eldorado_tpu.core import engine as E
    from eldorado_tpu.core.mapgen import generate_map
    from eldorado_tpu.ops.rng import seed as rseed

    t0 = time.perf_counter()
    # -- maps: every golden seed set in one vmapped program
    files = [np.load(f"{golden}/{name}.npz") for name, _, _ in MAPGEN_CASES]
    seeds = np.concatenate([d["seeds"] for d in files]).astype(np.uint32)
    pieces = np.concatenate([np.full(len(d["seeds"]), p, np.int32)
                             for d, (_, p, _) in zip(files, MAPGEN_CASES)])
    diffs = np.concatenate([np.full(len(d["seeds"]), f, np.int32)
                            for d, (_, _, f) in zip(files, MAPGEN_CASES)])
    gen = jax.jit(jax.vmap(lambda s, p, f: generate_map(rseed(s), p, f)))(
        seeds, pieces, diffs)
    ok, ids = np.asarray(gen.ok), np.asarray(gen.ids)
    off = 0
    for d, (name, _, _) in zip(files, MAPGEN_CASES):
        k = len(d["seeds"])
        _check(np.array_equal(ok[off:off + k].astype(np.uint8), d["ok"]),
               f"{name}: ok flags")
        good = d["ok"] > 0
        obs = C.expand_obs_np(ids[off:off + k])
        _check(np.array_equal(obs[good], d["obs"][good]), f"{name}: maps")
        off += k

    # -- trajectories: all cases in one vmapped scan
    cases = []
    for name, storage, max_steps, lim in TRAJ_CASES:
        d = np.load(f"{golden}/{name}.npz")
        hdr = [int(v) for v in d["header"]]
        T = hdr[5] if lim is None else min(hdr[5], lim)
        if limit is not None:
            T = min(T, limit)
        cases.append((name, d, hdr, storage, max_steps, T))
    T = max(c[5] for c in cases)
    hdr = np.asarray([c[2] for c in cases])      # es, ss, players, pieces, diff
    s0, traj = _replay_program(T)(
        hdr[:, 0].astype(np.uint32), hdr[:, 1].astype(np.uint32),
        *(hdr[:, i].astype(np.int32) for i in (2, 3, 4)),
        np.asarray([c[4] for c in cases], np.int32),
        np.asarray([c[3] for c in cases]))
    traj = jax.device_get(traj)
    s0 = jax.device_get(s0)

    def unpack(words):
        return np.asarray(E.unpack_mask(words)).astype(np.uint8)

    for i, (name, d, _, _, _, Tc) in enumerate(cases):
        _check(np.array_equal(C.expand_obs_np(s0.map_ids[i])[0],
                              d["map0"]),
               f"{name}: initial map")
        _check(np.array_equal(unpack(s0.sel_mask[i]), d["sel0"]),
               f"{name}: initial sel mask")
        _check(np.array_equal(unpack(s0.storage_masks[i]), d["storage0"]),
               f"{name}: initial storage masks")
        _check(np.array_equal(s0.piles[i], d["piles0"]),
               f"{name}: initial piles")
        for key in TRAJ_FIELDS:
            got = traj[key][:Tc, i]
            if key in ("sel_mask", "storage_masks"):
                got = unpack(got)
            want = d[key][:Tc]
            got = got.astype(np.uint8) if got.dtype == bool else got
            bad = ~np.all(got.reshape(Tc, -1)
                          == want.reshape(Tc, -1).astype(got.dtype), axis=1)
            _check(not bad.any(), f"{name}: field {key} first diverges at "
                   f"step {np.nonzero(bad)[0][:1]}")
        _check(not traj["rng_tainted"][:Tc, i].any(),
               f"{name}: fast RNG path deviated from the exact stream")
        for k, t in enumerate(d["reset_steps"]):
            if t < Tc:
                _check(np.array_equal(
                    C.expand_obs_np(traj["map_ids"][t, i])[0],
                    d["reset_maps"][k]), f"{name}: reset map at step {t}")
    w3_canary()
    _report("parity", t0, steps_per_case=T)


def w3_canary(n=4096):
    """The XLA wrong-code canary of tests/test_ball_words.py: an i32 or
    fold must agree between jit and eager (and numpy)."""
    rng = np.random.default_rng(0)
    pids = jnp.asarray(rng.integers(0, 32, (n, 19)), np.int32)
    pend = jnp.asarray(rng.integers(0, 2, (n,)), np.int32)

    def fold(pids, pend):
        w3 = jnp.zeros_like(pids[..., 0])
        for i in range(6):
            w3 = w3 | (pids[..., 1 + i] << (5 * i))
        return w3 | (pend << 30)

    want = np.asarray(pend) << 30
    for i in range(6):
        want = want | (np.asarray(pids)[:, 1 + i] << (5 * i))
    _check((np.asarray(jax.vmap(fold)(pids, pend)) == want).all(),
           "w3 fold: eager differs from numpy")
    _check((np.asarray(jax.jit(jax.vmap(fold))(pids, pend)) == want).all(),
           "w3 fold: jit differs from numpy")


def main_path(n=N_ENVS, chunk=CHUNK, chunks=3, block=BLOCK,
              max_steps=100000):
    """Blocked rollout with on-device queued resets == host-bucketed XLA
    rollout, bit for bit, with episodes ending mid-run."""
    from eldorado_tpu import vec
    states, rngs = _batch(n, max_steps)
    t0 = time.perf_counter()
    sk, rk, ek = vec.rollout_chunked(states, rngs, chunk * chunks, chunk,
                                     backend="kernel", block=block)
    jax.block_until_ready(sk.rng)
    _report("main_path kernel", t0, n * chunk * chunks, episodes=ek)
    t0 = time.perf_counter()
    sx, rx, ex = vec.rollout_chunked(states, rngs, chunk * chunks, chunk,
                                     backend="xla")
    jax.block_until_ready(sx.rng)
    _report("main_path xla", t0, n * chunk * chunks, episodes=ex)
    _check(ek > 0, "no episode ended mid-run")
    _check(ek == ex, f"episodes: kernel {ek} != xla {ex}")
    _same_states(sk, sx, "kernel vs xla")
    _check(np.array_equal(np.asarray(rk), np.asarray(rx)),
           "kernel vs xla: sampler streams differ")


def exact_stream_check(n=64, chunk=10, chunks=12, block=BLOCK):
    """tests/test_exact_reset.py's property: per env, the exact-mode step
    sequence with dead steps excluded equals the in-scan same-step-reset
    rollout."""
    from eldorado_tpu import vec
    states, rngs = _batch(n, max_steps=20, seed=5, pieces=1,
                          sampler_seed=11)
    progs = vec._kernel_programs(states, "storage", min(block, n),
                                 gate_dead=True)
    s, r = states, rngs
    cols = [[], [], [], []]
    for _ in range(chunks):
        bctx, bdyn, brngs = progs.block_in(s, r)
        bdyn, brngs, _, _, traj = progs.run(bctx, bdyn, brngs, chunk, True)
        s, r = progs.unblock(s, bdyn, brngs)
        for c, t in zip(cols, progs.unblock_traj(traj)):
            c.append(np.asarray(t))
        if np.asarray(s.done).any():
            s, _ = vec.reset_done_bucketed(s)
    acts, dones, rews, agents = (np.concatenate(c) for c in cols)
    ref = [np.asarray(x) for x in
           vec.rollout(states, rngs, chunk * chunks, auto_reset="step")[2][:4]]
    entry_dead = np.concatenate([np.zeros((1, n), bool), dones[:-1] != 0])
    entry_dead[::chunk] = False
    _check(entry_dead.any(), "exact slice: no deferred reset exercised")
    for e in range(n):
        live = ~entry_dead[:, e]
        k = int(live.sum())
        for name, got, want in (("actions", acts, ref[0]),
                                ("done", dones != 0, ref[1]),
                                ("rewards", rews, ref[2]),
                                ("agent", agents, ref[3])):
            _check(np.array_equal(got[live, e], want[:k, e]),
                   f"exact slice: env {e} {name}")


def exact_mode(n=N_ENVS, chunk=CHUNK, chunks=3, block=BLOCK, slice_n=64):
    """Exact reference auto-reset: dead fraction at full width, and the
    continuous-stream property on a slice."""
    from eldorado_tpu import vec
    states, rngs = _batch(n)
    t0 = time.perf_counter()
    s, _, eps, dead = vec.rollout_chunked(
        states, rngs, chunk * chunks, chunk, backend="kernel", block=block,
        exact=True)
    jax.block_until_ready(s.rng)
    total = n * chunk * chunks
    _check(0 <= dead < total, f"exact: dead steps {dead} of {total}")
    _report("exact_mode", t0, total - dead, episodes=eps,
            dead_fraction=f"{dead / total:.5f}")
    exact_stream_check(slice_n, block=block)


def _xor_fold():
    """Device fold over compact blocked records (T, nb, 5, block): the
    demo stats (stream.device_stats_fn) plus the xor checksum that
    stream.RingConsumer computes over the same records in env-major
    int64 pairs (low word: even flat index, high word: odd)."""
    from eldorado_tpu import stream as S

    def fold(carry, traj):
        stats, lo, hi = carry
        nb, block = traj.shape[1], traj.shape[3]
        env = (jnp.arange(nb)[:, None, None] * block
               + jnp.arange(block)[None, None, :])
        odd = ((env + jnp.arange(5)[None, :, None]) & 1)[None] == 1
        xr = lambda x: jax.lax.reduce(  # noqa: E731
            x, jnp.int32(0), jax.lax.bitwise_xor, tuple(range(x.ndim)))
        return (S.device_stats_fn(stats, traj),
                lo ^ xr(jnp.where(odd, 0, traj)),
                hi ^ xr(jnp.where(odd, traj, 0)))

    return fold, (S.device_stats_init(), jnp.int32(0), jnp.int32(0))


def _checksum(lo, hi):
    v = (int(np.uint32(np.int32(hi))) << 32) | int(np.uint32(np.int32(lo)))
    return int(np.int64(np.uint64(v)))


def learner_feeds(n=N_ENVS, chunk=CHUNK, chunks=3, block=BLOCK,
                  full_chunk=300, spp=100, recon_n=8):
    """Compact/full device feeds, plain/compressed ring feeds, one
    checksum across the compact deliveries, ObsReconstructor exact."""
    from eldorado_tpu import stream as S
    _check(n % 2 == 0, "checksum pairing needs an even env count")
    states, rngs = _batch(n)
    want = n * chunk * chunks
    t0 = time.perf_counter()
    fold, init = _xor_fold()
    _, _, eps, (stats, lo, hi) = S.stream_rollout(
        states, rngs, chunk * chunks, chunk, block=block, deliver="device",
        device_fn=fold, device_carry=init)
    _check(int(stats[0]) == want, f"device feed: {int(stats[0])} records")
    ref = _checksum(lo, hi)
    _report("feed device compact", t0, want, episodes=eps)

    t0 = time.perf_counter()
    _, _, _, fstats = S.stream_rollout(
        states, rngs, full_chunk * chunks, full_chunk, block=block,
        deliver="device", record="full")
    fwant = n * full_chunk * chunks
    _check(int(fstats[0]) == fwant, f"full feed: {int(fstats[0])} records")
    _report("feed device full", t0, fwant)

    for compress in (False, True):
        t0 = time.perf_counter()
        _, _, e2, cons = S.stream_rollout(
            states, rngs, chunk * chunks, chunk, block=block,
            deliver="ring", steps_per_push=spp, compress=compress)
        tag = "ring compressed" if compress else "ring"
        _check(cons.records == want, f"{tag}: {cons.records} records")
        _check(int(cons.checksum) == ref, f"{tag}: checksum differs from "
               "the device feed")
        _check(e2 == eps, f"{tag}: episodes {e2} != {eps}")
        extra = {}
        if compress:
            extra["bytes_per_record"] = f"{cons.wire_bytes / want:.2f}"
        _report(f"feed {tag}", t0, want, **extra)
    obs_reconstruction(recon_n)


def obs_reconstruction(n=8, chunk=40, n_chunks=6):
    """tests/test_stream_full.py's check: the record="full" ring feed plus
    reset keyframes mirror ObsData field-exactly against an XLA replay."""
    from eldorado_tpu import stream as S
    from eldorado_tpu import vec
    from eldorado_tpu.core import engine as E
    states, rngs = _batch(n, max_steps=60, seed=5, pieces=1,
                          sampler_seed=11)
    recon = S.ObsReconstructor(states)
    blocks = []
    _, _, episodes, cons = S.stream_rollout(
        states, rngs, chunk * n_chunks, chunk, block=n, deliver="ring",
        steps_per_push=chunk, record="full",
        consume=lambda r: blocks.append(r.copy()))
    _check(episodes > 0, "reconstruction: no mid-run reset")
    recon.feat, recon.q_cap = cons.feat, cons.q_cap
    kf = dict(cons.keyframes)
    vstep = jax.jit(jax.vmap(E.step_env))
    truth = states
    fields = (("piles", "piles"), ("shop", "shop_stock"),
              ("storage", "storage_masks"), ("sel", "sel_mask"),
              ("agent", "agent"), ("phase", "phase"),
              ("resources", "resources"), ("done", "done"),
              ("map_ids", "map_ids"), ("min_xy", "min_xy"))

    def cmp(where):
        tr = jax.device_get(truth)
        for mine, theirs in fields:
            _check(np.array_equal(getattr(recon, mine),
                                  np.asarray(getattr(tr, theirs))),
                   f"reconstruction: {mine} at {where}")

    for ci in range(n_chunks):
        rec = blocks[ci]
        acts = S.unpack_full(rec)["actions"]
        for t in range(chunk):
            truth = vstep(truth, acts[t].astype(np.int32))
            recon.apply_step(rec[t])
            cmp((ci, t))
        if ci in kf:
            recon.apply_reset(kf[ci])
            truth = vec.reset_done(truth)
            cmp((ci, "reset"))


def async_resets(n=N_ENVS, chunk=CHUNK, chunks=2, block=BLOCK,
                 max_steps=100000):
    """reset_mode="async": the reset queue regenerates on the host CPU
    backend; map generation must report no failure."""
    from eldorado_tpu import vec
    states, rngs = _batch(n, max_steps)
    t0 = time.perf_counter()
    s, _, eps = vec.rollout_chunked(states, rngs, chunk * chunks, chunk,
                                    backend="kernel", block=block,
                                    reset_mode="async")
    vec.check_map_generation(s)
    _check(eps > 0, "async: no episode ended")
    _report("async_resets", t0, n * chunk * chunks, episodes=eps)


def sharded_path(n_per=N_ENVS, chunk=CHUNK, chunks=3, block=BLOCK,
                 n_dev=4, runner_steps=200, max_steps=100000):
    """Sharded kernel and stream runners on an n_dev mesh == the unsharded
    path on one device; ShardedRunner.rollout == vec.rollout."""
    from eldorado_tpu import stream as S
    from eldorado_tpu import vec
    from eldorado_tpu.parallel import runner as R
    from eldorado_tpu.parallel.mesh import make_mesh
    _check(len(jax.devices()) >= n_dev, f"needs {n_dev} devices")
    mesh = make_mesh(n_dev)
    n = n_dev * n_per
    states, rngs = _batch(n, max_steps)
    t0 = time.perf_counter()
    ss, rs, es = R.sharded_kernel_rollout(mesh, states, rngs, chunk * chunks,
                                          chunk, block=block)
    jax.block_until_ready(ss.rng)
    _report("sharded kernel", t0, n * chunk * chunks, episodes=es)
    t0 = time.perf_counter()
    su, ru, eu = vec.rollout_chunked(states, rngs, chunk * chunks, chunk,
                                     backend="kernel", block=block)
    jax.block_until_ready(su.rng)
    _report("unsharded kernel", t0, n * chunk * chunks, episodes=eu)
    _check(es > 0 and es == eu, f"episodes: sharded {es} != {eu}")
    _same_states(ss, su, "sharded vs unsharded")
    _check(np.array_equal(np.asarray(rs), np.asarray(ru)),
           "sharded vs unsharded: sampler streams differ")

    t0 = time.perf_counter()
    fs, _, fe, rows = R.sharded_stream_rollout(
        mesh, states, rngs, chunk * chunks, chunk, block=block,
        record="compact")
    _report("sharded stream", t0, n * chunk * chunks, episodes=fe)
    gs, _, ge, carry = S.stream_rollout(states, rngs, chunk * chunks, chunk,
                                        block=block, deliver="device")
    _check(fe == ge, f"stream episodes: sharded {fe} != {ge}")
    _same_states(fs, gs, "sharded vs unsharded stream")
    rows = jax.device_get(rows)
    carry = jax.device_get(carry)
    for i, (r, c) in enumerate(zip(rows, carry)):
        _check(np.array_equal(np.asarray(r).sum(axis=0), np.asarray(c)),
               f"stream fold leaf {i}: sharded rows != unsharded carry")

    t0 = time.perf_counter()
    runner = R.ShardedRunner(mesh, n)
    runner.reset(seed=12345, max_steps=max_steps)
    runner.rollout(runner_steps)
    ref_s, ref_r, _ = vec.rollout(vec.vec_reset(12345, n, 4, 3, 0, max_steps),
                                  vec.sampler_init(42, n), runner_steps,
                                  auto_reset="step")
    _same_states(runner.sync(), ref_s, "ShardedRunner.rollout vs vec.rollout")
    _check(np.array_equal(np.asarray(runner.sampler_rngs), np.asarray(ref_r)),
           "ShardedRunner.rollout: sampler streams differ")
    _report("sharded runner", t0, n * runner_steps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path, on four devices")
    args = ap.parse_args(argv)
    dev = device_check()
    if args.four:
        sharded_path()
    else:
        parity()
        main_path()
        exact_mode()
        learner_feeds()
        async_resets()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
