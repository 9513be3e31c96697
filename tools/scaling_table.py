#!/usr/bin/env python3
"""Virtual-mesh scaling table: sharded rollout throughput at 1/2/4/8
devices (CPU, xla_force_host_platform_device_count), fixed envs/device.

A scaling proxy that needs no accelerator: it checks that the sharded
program's per-device work and collective overhead stay flat as the mesh
grows. These are CPU timings, not device measurements. Each device count
runs in a subprocess (JAX fixes the device count at init).

Usage: python tools/scaling_table.py [--envs-per-dev 64] [--steps 200]
"""
import argparse
import json
import os
import subprocess
import sys

WORKER = r"""
import json, os, sys, time
import jax
import numpy as np
sys.path.insert(0, REPO_PATH)
from eldorado_tpu import vec
from eldorado_tpu.parallel import mesh as M
from eldorado_tpu.parallel import runner as R

nd = int(sys.argv[1]); envs = int(sys.argv[2]); steps = int(sys.argv[3])
mesh = M.make_mesh(nd)
states = vec.vec_reset(5, envs, 4, 3, 0, 100000)
rngs = vec.sampler_init(11, envs)
ss = M.shard_envs(states, mesh)
rs = jax.device_put(rngs, M.env_sharding(mesh))
backend = sys.argv[4] if len(sys.argv) > 4 else "xla"
if backend == "kernel":
    # per-shard blocked scans + queued resets
    block = min(8, envs // nd)
    def go():
        return R.sharded_kernel_rollout(mesh, states, rngs, steps,
                                        chunk=steps, block=block)
else:
    def go():
        return R.sharded_rollout(mesh, ss, rs, steps)
out = go()   # compile+warm
jax.block_until_ready(out[0].rng)
t0 = time.perf_counter()
out = go()
jax.block_until_ready(out[0].rng)
dt = time.perf_counter() - t0
print(json.dumps({"devices": nd, "envs": envs, "backend": backend,
                  "steps_per_sec": envs * steps / dt}))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs-per-dev", type=int, default=64)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--backend", choices=["xla", "kernel"], default="xla")
    args = ap.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rows = []
    for nd in (1, 2, 4, 8):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + f" --xla_force_host_platform_device_count={nd}"
                            ).strip()
        env.setdefault("JAX_COMPILATION_CACHE_DIR",
                       os.path.join(repo, ".jax_cache"))
        out = subprocess.run(
            [sys.executable, "-c", WORKER.replace("REPO_PATH", repr(repo)),
             str(nd), str(nd * args.envs_per_dev), str(args.steps),
             args.backend],
            env=env, capture_output=True, text=True, timeout=1200)
        line = out.stdout.strip().splitlines()[-1] if out.stdout else ""
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            print(f"devices={nd} FAILED:\n{out.stderr[-2000:]}",
                  file=sys.stderr)
            continue
        print(rows[-1], flush=True)
    if rows:
        base = rows[0]["steps_per_sec"] / rows[0]["devices"]
        print("\n| devices | envs | env-steps/s | per-device vs 1-dev |")
        print("|---|---|---|---|")
        for r in rows:
            eff = r["steps_per_sec"] / r["devices"] / base
            print(f"| {r['devices']} | {r['envs']} "
                  f"| {r['steps_per_sec']:,.0f} | {eff:.2f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
