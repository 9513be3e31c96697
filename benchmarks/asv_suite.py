"""asv benchmark classes mirroring the reference's grid.

The reference tracks perf history with airspeed-velocity over
``TimeEnvs`` (reference: benchmarks/benchmarks.py:5-69, published at its
README dashboard). These classes follow the same asv conventions
(``params``/``param_names``/``setup``/``time_*``/``peakmem_*``) so an asv
host can run ``asv run`` against ``asv.conf.json`` at the repo root; they
are also plain Python (no asv import), smoke-tested in the regular suite
(tests/test_benchmarks.py) and runnable standalone:

    python benchmarks/asv_suite.py          # one pass at small sizes

The reference's thread-count axis becomes the execution backend
(xla: the env-major scan | kernel: the blocked scan of
rollout_chunked(backend="kernel")).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                 ".jax_cache"))


class TimeEnvs:
    """sample+step rollout throughput (reference TimeEnvs.time_run)."""

    params = ([64, 512, 4096], ["xla", "kernel"])
    param_names = ["n_envs", "backend"]
    timeout = 900
    steps = 100

    def setup(self, n_envs, backend):
        import jax

        from eldorado_tpu.vec import (kernel_rollout, rollout,
                                      sampler_init, vec_reset)
        self.states = vec_reset(12345, n_envs, 4, 3, 0, 100000)
        self.rngs = sampler_init(42, n_envs)
        if backend == "kernel":
            def run(s, r):
                return kernel_rollout(s, r, self.steps, "storage",
                                      min(256, n_envs))
        else:
            def run(s, r):
                return rollout(s, r, self.steps, "storage", "none")
        self._run = run
        self._bur = jax.block_until_ready
        out = run(self.states, self.rngs)       # compile outside timing
        self._bur(out[0].rng)

    def time_run(self, n_envs, backend):
        s, r, _ = self._run(self.states, self.rngs)
        self._bur(s.rng)


class TimeSampler:
    """Sampler-only scan (reference TimeEnvs.time_sample)."""

    params = ([64, 4096],)
    param_names = ["n_envs"]
    timeout = 600
    draws = 100

    def setup(self, n_envs):
        import functools

        import jax

        from eldorado_tpu.core import engine as E
        from eldorado_tpu.vec import _active_mask, sampler_init, vec_reset
        states = vec_reset(12345, n_envs, 4, 3, 0, 100000)
        self.masks = _active_mask(states, "storage")
        self.rngs = sampler_init(42, n_envs)

        @functools.partial(jax.jit, static_argnums=(2,))
        def sample_scan(rngs, masks, k):
            def body(r, _):
                a, r, _t = jax.vmap(E.sample_action)(r, masks)
                return r, a
            return jax.lax.scan(body, rngs, None, length=k)

        self._f = sample_scan
        self._bur = jax.block_until_ready
        self._bur(self._f(self.rngs, self.masks, self.draws)[0])

    def time_sample(self, n_envs):
        self._bur(self._f(self.rngs, self.masks, self.draws)[0])


class TimeReset:
    """Full vectorised reset incl. on-device map procgen (reference
    TimeEnvs.time_reset; sequential-mode only there too)."""

    params = ([16, 128],)
    param_names = ["n_envs"]
    timeout = 600

    def setup(self, n_envs):
        import jax
        import jax.numpy as jnp

        from eldorado_tpu.core import engine as E

        @jax.jit
        def reset(seeds):
            make = jax.vmap(lambda s: E.make_state(s, 4, 3, 0, 100000))
            return jax.vmap(E.reset_env)(make(seeds))

        self._f = reset
        self._seed = [0]
        self._jnp = jnp
        self._bur = jax.block_until_ready
        self._bur(reset(jnp.arange(n_envs, dtype=jnp.uint32)).rng)

    def time_reset(self, n_envs):
        # fresh seeds per call
        self._seed[0] += 1
        seeds = (self._jnp.arange(n_envs, dtype=self._jnp.uint32)
                 + self._seed[0])
        self._bur(self._f(seeds).rng)


class MemState:
    """Bytes of device state per env (reference peakmem_runner analogue)."""

    params = ([1024],)
    param_names = ["n_envs"]

    def setup(self, n_envs):
        from eldorado_tpu.vec import vec_reset
        self.states = vec_reset(12345, n_envs, 4, 3, 0, 100000)

    def track_state_bytes_per_env(self, n_envs):
        import jax
        total = sum(x.size * x.dtype.itemsize
                    for x in jax.tree_util.tree_leaves(self.states))
        return total / n_envs


def main():
    for cls in (TimeEnvs, TimeSampler, TimeReset, MemState):
        grid = [()]
        for axis in cls.params:
            grid = [g + (v,) for g in grid for v in (
                axis if isinstance(axis, (list, tuple)) else [axis])]
        for combo in grid[:2]:                    # small standalone pass
            small = tuple(min(c, 64) if isinstance(c, int) else c
                          for c in combo)
            b = cls()
            b.setup(*small)
            for name in dir(b):
                if name.startswith(("time_", "track_")):
                    out = getattr(b, name)(*small)
                    print(f"{cls.__name__}.{name}{small}: ok"
                          + (f" -> {out}" if out is not None else ""))


if __name__ == "__main__":
    main()
