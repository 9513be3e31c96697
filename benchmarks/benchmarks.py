#!/usr/bin/env python3
"""Benchmark suite mirroring the reference's asv parameter grid.

Reference (benchmarks/benchmarks.py:5-69): TimeEnvs.time_run (10k
sample+step iterations) over n_envs x threads x {sequential, async, sync},
plus time_sample, time_reset, peakmem_runner. The equivalents here:

  time_run     sample+step lockstep rollouts (the thread axis becomes the
               execution backend: xla | kernel)
  time_sample  sampler-only scan
  time_reset   vmapped full resets (map procgen on device)
  mem_state    bytes of device state per env (the peakmem analogue)

Usage: python benchmarks/benchmarks.py [--envs 1,8,64,512,4096]
                                       [--iters 1000] [--json out.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "..", ".jax_cache"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def bench_run(n_envs, iters, backend):
    from eldorado_tpu.vec import kernel_rollout, rollout, sampler_init, vec_reset
    states = vec_reset(12345, n_envs, 4, 3, 0, 100000)
    rngs = sampler_init(42, n_envs)
    run = kernel_rollout if backend == "kernel" else (
        lambda s, r, k: rollout(s, r, k, "storage", "none"))
    chunk = min(iters, 250)
    states, rngs, _ = run(states, rngs, chunk)           # compile+warm
    jax.block_until_ready(states.rng)
    done = 0
    t0 = time.time()
    while done < iters:
        states, rngs, _ = run(states, rngs, chunk)
        done += chunk
    jax.block_until_ready(states.rng)
    return n_envs * done / (time.time() - t0)


def bench_sample(n_envs, iters):
    from eldorado_tpu.core import engine as E
    from eldorado_tpu.vec import sampler_init, vec_reset

    states = vec_reset(12345, n_envs, 4, 3, 0, 100000)
    masks = jnp.take_along_axis(states.storage_masks,
                                states.agent[:, None, None], axis=1)[:, 0]

    @jax.jit
    def run(rngs):
        def body(r, _):
            a, r, t = jax.vmap(E.sample_action)(r, masks)
            return r, a
        r, acts = jax.lax.scan(body, rngs, None, length=250)
        return r, acts

    rngs = sampler_init(42, n_envs)
    rngs, _ = run(rngs)
    jax.block_until_ready(rngs)
    done = 0
    t0 = time.time()
    while done < iters:
        rngs, _ = run(rngs)
        done += 250
    jax.block_until_ready(rngs)
    return n_envs * done / (time.time() - t0)


def bench_reset(n_envs, n_resets):
    from eldorado_tpu.vec import vec_reset
    states = vec_reset(1, n_envs, 4, 3, 0, 100000)   # compile
    jax.block_until_ready(states.map_obs)
    t0 = time.time()
    for k in range(max(1, n_resets // n_envs)):
        states = vec_reset(1000 + k, n_envs, 4, 3, 0, 100000)
    jax.block_until_ready(states.map_obs)
    return n_envs * max(1, n_resets // n_envs) / (time.time() - t0)


def state_bytes_per_env():
    from eldorado_tpu.core import engine as E
    s = E.make_state()
    return sum(int(jnp.asarray(v).size) * jnp.asarray(v).dtype.itemsize
               for v in s)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", default="8,64,512,4096")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--backends", default="xla,kernel")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    sizes = [int(x) for x in args.envs.split(",")]
    out = {"device": str(jax.devices()[0]),
           "mem_state_bytes_per_env": state_bytes_per_env(), "time_run": {},
           "time_sample": {}, "time_reset": {}}
    for n in sizes:
        for backend in args.backends.split(","):
            sps = bench_run(n, args.iters, backend)
            out["time_run"][f"{n},{backend}"] = sps
            print(f"time_run n={n} backend={backend}: "
                  f"{sps / 1e6:.3f}M env-steps/s", flush=True)
        out["time_sample"][str(n)] = bench_sample(n, args.iters)
        print(f"time_sample n={n}: {out['time_sample'][str(n)]/1e6:.3f}M/s",
              flush=True)
    out["time_reset"]["64"] = bench_reset(64, 256)
    print(f"time_reset: {out['time_reset']['64']:.1f} resets/s", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
