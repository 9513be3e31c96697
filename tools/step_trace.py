#!/usr/bin/env python3
"""Per-step cost of the blocked rollout scan on the device, from a trace.

    python tools/step_trace.py [--envs 4096] [--blocks 1024,4096]
                               [--out chiprun_out/step_trace]

For each block width: the time per scan step of ``progs.run`` (the
``rollout_chunked(backend="kernel")`` step scan with no reset machinery),
by differencing a short and a long warmed run; then a ``jax.profiler``
trace of two annotated runs of K1 and K2 steps, reduced to

* kernels per scan iteration: (kernels in run K2 - kernels in run K1) /
  (K2 - K1), counting the device's kernel events (memory copies apart);
* the device idle share over each run's host window: 1 - (union of the
  device's event intervals) / (window length).

Also the env-major XLA rollout (``vec.rollout``) per step, and one reset
event: ``reset_q`` (map generation + reset body for a full queue) and
``apply_q``, each timed alone. Prints one JSON line per measurement;
``--out`` keeps the raw traces and a per-line event summary.
"""
import argparse
import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(ROOT, ".jax_cache"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_compilation_cache_dir",
                  os.environ["JAX_COMPILATION_CACHE_DIR"])

_NON_KERNEL = ("Memcpy", "Memset", "memcpy", "memset")


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "not a GPU"


def reduce_trace(path, windows, summary=None):
    """Kernel count and device idle share inside each named host window.

    ``path`` is an ``.xplane.pb``; ``windows`` the TraceAnnotation names.
    Device events are those on ``/device:*`` planes; lines whose events
    are XLA module/op summaries are skipped, so each kernel counts once.
    Returns {name: {"kernels", "copies", "window_ns", "busy_ns",
    "idle_share"}}."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    host = {}
    dev_events = []
    lines_seen = []
    for plane in pd.planes:
        if plane.name.startswith("/host"):
            for line in plane.lines:
                for e in line.events:
                    if e.name in windows:
                        host[e.name] = (e.start_ns, e.end_ns)
        elif plane.name.startswith("/device"):
            for line in plane.lines:
                evs = list(line.events)
                lines_seen.append((plane.name, line.name, len(evs)))
                if line.name.startswith("XLA") or line.name in (
                        "Steps", "Launch Stats", "Source code"):
                    continue
                dev_events += [(e.start_ns, e.end_ns, e.name) for e in evs]
    if summary is not None:
        with open(summary, "w") as f:
            for row in lines_seen:
                f.write("%s\t%s\t%d\n" % row)
    out = {}
    for name, (t0, t1) in host.items():
        evs = sorted((s, e, n) for s, e, n in dev_events
                     if s >= t0 and e <= t1)
        busy, cur_s, cur_e = 0.0, None, None
        for s, e, _ in evs:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        kernels = sum(1 for _, _, n in evs if not n.startswith(_NON_KERNEL))
        out[name] = {"kernels": kernels, "copies": len(evs) - kernels,
                     "window_ns": t1 - t0, "busy_ns": busy,
                     "idle_share": 1.0 - busy / (t1 - t0)}
    return out


def _timed(fn, reps=3):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def step_scan(states, rngs, block, k1, k2, out):
    """Per-step time, kernels per iteration and idle share of progs.run."""
    from eldorado_tpu import vec
    n = int(states.rng.shape[0])
    progs = vec._kernel_programs(states, "storage", block)

    def run(steps):
        bctx, bdyn, brngs = progs.block_in(states, rngs)
        jax.block_until_ready(bdyn)
        t0 = time.perf_counter()
        r = progs.run(bctx, bdyn, brngs, steps, False)
        jax.block_until_ready(r[:2])
        return time.perf_counter() - t0

    s1, s2 = 200, 1000
    t0 = time.perf_counter()
    run(s1), run(s2), run(k1), run(k2)            # compile every length
    compile_s = time.perf_counter() - t0
    t1 = min(run(s1) for _ in range(3))
    t2 = min(run(s2) for _ in range(3))
    per_step = (t2 - t1) / (s2 - s1)
    tdir = os.path.join(out, f"block{block}")
    with jax.profiler.trace(tdir):
        for k in (k1, k2):
            bctx, bdyn, brngs = progs.block_in(states, rngs)
            jax.block_until_ready(bdyn)
            with jax.profiler.TraceAnnotation(f"run{k}"):
                jax.block_until_ready(
                    progs.run(bctx, bdyn, brngs, k, False)[:2])
    path = sorted(glob.glob(f"{tdir}/plugins/profile/*/*.xplane.pb"))[-1]
    red = reduce_trace(path, {f"run{k1}", f"run{k2}"},
                       summary=os.path.join(tdir, "lines.tsv"))
    a, b = red[f"run{k1}"], red[f"run{k2}"]
    return {"what": "blocked step scan", "envs": n, "block": block,
            "us_per_step": per_step * 1e6,
            "env_steps_per_s": n / per_step,
            "kernels_per_iteration": (b["kernels"] - a["kernels"])
            / (k2 - k1),
            "copies_per_iteration": (b["copies"] - a["copies"]) / (k2 - k1),
            f"idle_share_run{k2}": b["idle_share"],
            f"device_us_per_step_run{k2}": b["busy_ns"] / k2 / 1e3,
            "compile_and_warm_s": compile_s}


def xla_rollout(states, rngs):
    """Per-step time of the env-major vec.rollout scan."""
    from eldorado_tpu import vec
    n = int(states.rng.shape[0])
    s1, s2 = 100, 500
    for s in (s1, s2):
        jax.block_until_ready(vec.rollout(states, rngs, s)[0].rng)
    t1 = _timed(lambda: vec.rollout(states, rngs, s1)[0].rng)
    t2 = _timed(lambda: vec.rollout(states, rngs, s2)[0].rng)
    per_step = (t2 - t1) / (s2 - s1)
    return {"what": "env-major xla scan", "envs": n,
            "us_per_step": per_step * 1e6, "env_steps_per_s": n / per_step}


def reset_event(states, rngs, block):
    """One full reset queue: reset_q (mapgen + reset body) and apply_q."""
    import jax.numpy as jnp
    from eldorado_tpu import vec
    from eldorado_tpu.core import engine as E
    progs = vec._kernel_programs(states, "storage", block)
    bctx, bdyn, brngs = progs.block_in(states, rngs)
    i_done = E.DYN_FIELDS.index("done")
    bdyn = bdyn[:i_done] + (jnp.ones_like(bdyn[i_done]),) + bdyn[i_done + 1:]
    bdyn, brngs, qstate, _, resetq = progs.run_q(
        bctx, bdyn, brngs, progs.qstate_init(), 1)
    buf = progs.reset_q(resetq)
    t_reset = _timed(lambda: progs.reset_q(resetq), reps=5)

    def apply():
        c = jax.tree_util.tree_map(jnp.copy, (bdyn, bctx, qstate))
        jax.block_until_ready(c)
        t0 = time.perf_counter()
        jax.block_until_ready(progs.apply_q(c[0], c[1], states, c[2], buf))
        return time.perf_counter() - t0
    apply()
    t_apply = min(apply() for _ in range(5))
    return {"what": "reset event", "envs": int(states.rng.shape[0]),
            "queue": progs.q_cap, "reset_q_ms": t_reset * 1e3,
            "apply_q_ms": t_apply * 1e3,
            "queued_envs": int(np.asarray(resetq[0]))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--blocks", default="1024,4096")
    ap.add_argument("--k", default="20,60",
                    help="the two traced run lengths")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "step_trace"))
    args = ap.parse_args()
    from eldorado_tpu import vec
    os.makedirs(args.out, exist_ok=True)
    dev = jax.devices()[0]
    head = {"card": _card(), "platform": dev.platform,
            "device_kind": dev.device_kind}
    states = vec.vec_reset(12345, args.envs, 4, 3, 0, 100000)
    rngs = vec.sampler_init(42, args.envs)
    k1, k2 = (int(v) for v in args.k.split(","))
    rows = [step_scan(states, rngs, int(b), k1, k2, args.out)
            for b in args.blocks.split(",")]
    rows.append(xla_rollout(states, rngs))
    rows.append(reset_event(states, rngs, int(args.blocks.split(",")[0])))
    for r in rows:
        print(json.dumps({**head, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
