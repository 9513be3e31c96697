#!/usr/bin/env python3
"""Headline benchmark: lockstep env throughput (sample + step) on one GPU.

Mirrors the reference's asv ``TimeEnvs.time_run`` workload (reference:
benchmarks/benchmarks.py:5-51): masked-random self-play at max_steps=100000.
Finished episodes auto-reset at scan-chunk boundaries; the per-step work is
the full sample+step+mask pipeline either as

  * ``--backend kernel`` (default): the blocked rollout scan with resets
    queued on the device (vec.rollout_chunked(backend="kernel")), or
  * ``--backend xla``: the env-major scan with host-bucketed resets.

Every field is measured on the GPU; without one, or when a phase fails,
the run exits non-zero. Prints ONE JSON line:
  {"metric": ..., "value": steps/s, "unit": "env-steps/s", "platform": ...,
   "device_kind": ..., "device_count": ..., "card": "<name>, <limit>", ...}
``--sweep`` / ``--all-modes`` print extra per-config lines to stderr first.

Reset semantics: finished envs regenerate at chunk boundaries (the
reference auto-resets within step_single; a finished env here dead-steps
to its boundary first). ``exact_*`` fields freeze finished envs so that
only live steps count; the default chunk trades reset latency for
throughput and reports the episode count so the workload is auditable.
"""
import argparse
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   ".jax_cache"))

import jax  # noqa: E402

# effective even when jax was imported before the variable was set
jax.config.update("jax_compilation_cache_dir",
                  os.environ["JAX_COMPILATION_CACHE_DIR"])


def device_fields():
    """Which device ran the numbers: JAX's view plus the card's name and
    power limit (nvidia-smi; "not measured" where there is none)."""
    dev = jax.devices()[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        card = "not measured"
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": card}


def _prewarm_resets(states, n_envs):
    """Compile the bucketed-reset programs the kernel path's final sweep
    can use (the reset-queue capacity scales with the batch) so a
    multi-second compile never lands inside the timed region."""
    import jax.numpy as jnp
    from eldorado_tpu.vec import _RESET_BUCKETS, _queue_cap, _reset_bucket
    q = _queue_cap(n_envs)
    warm_buckets = {min(128, n_envs)}
    for b in _RESET_BUCKETS:
        if b >= q:
            warm_buckets.add(min(b, n_envs))
            break
    for b in sorted(warm_buckets):
        warm = _reset_bucket(states, jnp.zeros(b, jnp.int32), b)
        jax.block_until_ready(warm.rng)


def run_config(envs, chunk, chunks, players, pieces, difficulty, backend,
               block, reset_mode="sync"):
    """Returns (steps_per_sec, episodes)."""
    from eldorado_tpu.vec import rollout_chunked, sampler_init, vec_reset

    states = vec_reset(12345, envs, players, pieces, difficulty, 100000)
    jax.block_until_ready(states.map_ids)
    rngs = sampler_init(42, envs)

    s, r, _ = rollout_chunked(states, rngs, chunk, chunk, backend=backend,
                              block=block, reset_mode=reset_mode)
    jax.block_until_ready(s.rng)
    _prewarm_resets(states, envs)

    t0 = time.time()
    states, rngs, episodes = rollout_chunked(
        states, rngs, chunk * chunks, chunk, backend=backend, block=block,
        reset_mode=reset_mode)
    jax.block_until_ready(states.rng)
    dt = time.time() - t0
    return envs * chunk * chunks / dt, episodes


def run_exact(envs, chunk, chunks, players, pieces, difficulty, block):
    """Exact same-step auto-reset semantics (vec_cog_env::step_single):
    finished envs are frozen (no sampler draws) until their reset lands,
    so per-env trajectories are bit-exact vs the reference's continuous
    streams and dead steps are EXCLUDED from the metric
    (tests/test_exact_reset.py). Returns (live_steps_per_sec, episodes,
    dead_fraction)."""
    from eldorado_tpu.vec import rollout_chunked, sampler_init, vec_reset

    states = vec_reset(12345, envs, players, pieces, difficulty, 100000)
    jax.block_until_ready(states.map_ids)
    rngs = sampler_init(42, envs)
    s, r, _, _ = rollout_chunked(states, rngs, chunk, chunk,
                                 backend="kernel", block=block, exact=True)
    jax.block_until_ready(s.rng)
    _prewarm_resets(states, envs)

    total = envs * chunk * chunks
    t0 = time.time()
    states, rngs, episodes, dead = rollout_chunked(
        states, rngs, chunk * chunks, chunk, backend="kernel", block=block,
        exact=True)
    jax.block_until_ready(states.rng)
    dt = time.time() - t0
    return (total - dead) / dt, episodes, dead / total


def run_reset_free(envs, players, pieces, difficulty, block):
    """Steady-state step rate with NO reset machinery in the loop: the
    blocked step scan alone (progs.run), timed by step-count differencing
    of two warmed run lengths. This is the denominator of the
    with-resets/reset-free ratio."""
    from eldorado_tpu.vec import _kernel_programs, sampler_init, vec_reset

    states = vec_reset(123, envs, players, pieces, difficulty, 100000)
    progs = _kernel_programs(states, "storage", min(block, envs))

    def timed(steps, seed):
        rngs = sampler_init(seed, envs)
        bctx, bdyn, brngs = progs.block_in(states, rngs)
        jax.block_until_ready(brngs)
        t0 = time.perf_counter()
        out = progs.run(bctx, bdyn, brngs, steps, False)
        jax.block_until_ready(out[:2])
        return time.perf_counter() - t0

    s1, s2 = 200, 800
    timed(s1, 1)
    timed(s2, 2)                            # warm both program lengths
    t1 = min(timed(s1, s) for s in (11, 12, 13))
    t2 = min(timed(s2, s) for s in (14, 15, 16))
    return envs * (s2 - s1) / (t2 - t1)


def run_mesh(n_devices, envs, chunk, chunks, players, pieces, difficulty,
             block):
    """sharded_kernel_rollout over an n_devices mesh: per-shard blocked
    scans + queued on-device auto-resets. Returns (steps_per_sec,
    episodes). The shard_map overhead is isolated by comparing the
    1-device mesh against the unsharded path on the same workload
    (--mesh 1)."""
    from eldorado_tpu.parallel.mesh import make_mesh
    from eldorado_tpu.parallel.runner import sharded_kernel_rollout
    from eldorado_tpu.vec import sampler_init, vec_reset

    mesh = make_mesh(n_devices)
    states = vec_reset(12345, envs, players, pieces, difficulty, 100000)
    jax.block_until_ready(states.map_ids)
    rngs = sampler_init(42, envs)
    block = min(block, envs // n_devices)
    s, r, _ = sharded_kernel_rollout(mesh, states, rngs, chunk, chunk,
                                     block=block)
    jax.block_until_ready(s.rng)
    _prewarm_resets(states, envs)
    t0 = time.time()
    s, r, episodes = sharded_kernel_rollout(
        mesh, states, rngs, chunk * chunks, chunk, block=block)
    jax.block_until_ready(s.rng)
    dt = time.time() - t0
    return envs * chunk * chunks / dt, episodes


def run_streams(envs, chunk, players, pieces, difficulty, block):
    """The per-step learner feed (eldorado_tpu.stream): packed records per
    env per step off the blocked scan, consumed ON DEVICE (co-located JAX
    learner pattern; compact and full records) and through the host
    TrajectoryRing (plain and delta-compressed)."""
    from eldorado_tpu import stream as S
    from eldorado_tpu.vec import sampler_init, vec_reset
    st = vec_reset(12345, envs, players, pieces, difficulty, 100000)
    rg = sampler_init(42, envs)
    out = {}
    S.stream_rollout(st, rg, chunk, chunk, block=block, deliver="device")
    t0 = time.time()
    _, _, _, carry = S.stream_rollout(st, rg, chunk * 3, chunk, block=block,
                                      deliver="device")
    steps = int(carry[0])
    out["stream_device_env_steps_per_sec"] = round(steps / (time.time() - t0),
                                                   1)
    if steps != envs * chunk * 3:
        raise RuntimeError(f"device feed delivered {steps} records")
    # the FULL observation feed (40-word records: actor piles, shop,
    # storage rows — stream.RECORD_WORDS_FULL), consumed on device; the
    # chunk shrinks to keep the (chunk, nb, 40, block) trajectory buffer
    # ~200 MB at 4096 envs
    fchunk = min(chunk, 300)
    S.stream_rollout(st, rg, fchunk, fchunk, block=block, deliver="device",
                     record="full")
    t0 = time.time()
    _, _, _, fcarry = S.stream_rollout(st, rg, fchunk * 5, fchunk,
                                       block=block, deliver="device",
                                       record="full")
    fsteps = int(fcarry[0])
    out["stream_full_device_env_steps_per_sec"] = round(
        fsteps / (time.time() - t0), 1)
    if fsteps != envs * fchunk * 5:
        raise RuntimeError(f"full device feed delivered {fsteps} records")
    for compress in (False, True):
        S.stream_rollout(st, rg, chunk, chunk, block=block, deliver="ring",
                         compress=compress)
        t0 = time.time()
        _, _, _, cons = S.stream_rollout(st, rg, chunk, chunk, block=block,
                                         deliver="ring", compress=compress)
        rate = round(cons.records / (time.time() - t0), 1)
        if cons.records != envs * chunk:
            raise RuntimeError(f"ring delivered {cons.records} records")
        if compress:
            out["stream_ring_compressed_env_steps_per_sec"] = rate
            out["stream_ring_bytes_per_record"] = round(
                cons.wire_bytes / cons.records, 2)
            if int(cons.checksum) != ring_checksum:
                raise RuntimeError("compressed ring checksum differs")
        else:
            out["stream_ring_env_steps_per_sec"] = rate
            ring_checksum = int(cons.checksum)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--mesh", type=int, default=0,
                    help="N>0: run the kernel-sharded rollout over an "
                         "N-device mesh and "
                         "report per-device throughput; --mesh 1 vs the "
                         "default path isolates the shard_map overhead on "
                         "identical work")
    ap.add_argument("--chunk", type=int, default=1500)
    # 14 chunks amortise the per-call fixed work (block_in/unblock/final
    # sweep) over 21k steps; production rollouts run far longer still
    ap.add_argument("--chunks", type=int, default=14)
    ap.add_argument("--reset-mode", choices=["sync", "async"],
                    default="sync",
                    help="sync: on-device queued resets at each boundary; "
                         "async: host-CPU procgen overlapped with the next "
                         "chunk (see vec.rollout_chunked)")
    ap.add_argument("--players", type=int, default=4)
    ap.add_argument("--pieces", type=int, default=3)
    ap.add_argument("--difficulty", type=int, default=0)
    ap.add_argument("--backend", choices=["kernel", "xla"], default="kernel")
    ap.add_argument("--block", type=int, default=1024,
                    help="envs per block of the blocked carry")
    ap.add_argument("--sweep", action="store_true",
                    help="also time an env-count sweep (stderr)")
    ap.add_argument("--all-modes", action="store_true",
                    help="also time the other backend (stderr)")
    ap.add_argument("--no-exact", action="store_true",
                    help="skip the exact same-step auto-reset measurement")
    ap.add_argument("--no-stream", action="store_true",
                    help="skip the per-step learner-feed measurements")
    args = ap.parse_args()
    block = min(args.block, args.envs)
    if jax.devices()[0].platform != "gpu":
        print(f"bench.py measures a GPU; JAX's first device is "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        return 1

    if args.sweep:
        for n in (256, 1024, 4096, 16384):
            sps, eps = run_config(n, args.chunk, args.chunks, args.players,
                                  args.pieces, args.difficulty, args.backend,
                                  min(args.block, n), args.reset_mode)
            print(f"sweep {args.backend}@{n}: {sps:,.0f} steps/s "
                  f"({eps} episodes)", file=sys.stderr)
    if args.all_modes:
        other = "xla" if args.backend == "kernel" else "kernel"
        sps, eps = run_config(args.envs, args.chunk, args.chunks,
                              args.players, args.pieces, args.difficulty,
                              other, block, args.reset_mode)
        print(f"mode {other}@{args.envs}: {sps:,.0f} steps/s "
              f"({eps} episodes)", file=sys.stderr)

    if args.mesh > 0:
        sps, episodes = run_mesh(
            args.mesh, args.envs, args.chunk, args.chunks, args.players,
            args.pieces, args.difficulty, block)
        print(json.dumps({
            "metric": f"env_steps_per_sec@{args.envs}envs_mesh{args.mesh}",
            "value": round(sps, 1),
            "unit": "env-steps/s",
            **device_fields(),
            "backend": "kernel-sharded",
            "mesh": args.mesh,
            "per_device_steps_per_sec": round(sps / args.mesh, 1),
            "chunk": args.chunk,
            "episodes_reset_mid_run": episodes,
        }))
        return 0

    sps, episodes = run_config(
        args.envs, args.chunk, args.chunks, args.players, args.pieces,
        args.difficulty, args.backend, block, args.reset_mode)
    line = {
        "metric": f"env_steps_per_sec@{args.envs}envs",
        "value": round(sps, 1),
        "unit": "env-steps/s",
        **device_fields(),
        "backend": args.backend,
        "reset_mode": args.reset_mode,
        "chunk": args.chunk,
        "block": block,
        "episodes_reset_mid_run": episodes,
    }
    if args.backend == "kernel" and not args.no_exact:
        # the reference-semantics workload: same-step auto-reset per env
        # (frozen finishers, dead steps excluded from the count)
        esps, eeps, edead = run_exact(
            args.envs, args.chunk, args.chunks, args.players, args.pieces,
            args.difficulty, block)
        line["exact_env_steps_per_sec"] = round(esps, 1)
        line["exact_episodes"] = eeps
        line["exact_dead_fraction"] = round(edead, 5)
    if args.backend == "kernel" and args.envs == 4096:
        # large-batch scaling point: 16384 envs on the same workload
        sps16, eps16 = run_config(
            16384, args.chunk, 5, args.players, args.pieces,
            args.difficulty, "kernel", min(args.block, 16384),
            args.reset_mode)
        line["sixteenk_env_steps_per_sec"] = round(sps16, 1)
        line["sixteenk_per_env_vs_4096"] = round(sps16 / sps, 4)
        line["sixteenk_episodes"] = eps16
    if args.backend == "kernel":
        rf = run_reset_free(args.envs, args.players, args.pieces,
                            args.difficulty, block)
        line["reset_free_env_steps_per_sec"] = round(rf, 1)
        line["with_resets_vs_reset_free"] = round(sps / rf, 4)
    if args.backend == "kernel" and not args.no_stream:
        line.update(run_streams(args.envs, args.chunk, args.players,
                                args.pieces, args.difficulty, block))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
