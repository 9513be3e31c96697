"""eldorado_tpu — an accelerator-native JAX re-design of
aapo-kossi/gym-eldorado.

The reference (C++20 + pybind11, reference: README.md:79-86) is a
vectorised hex-board RL environment with a built-in masked random sampler
and a lock-free threaded runner.  Here the whole engine is pure JAX: the
env batch is a pytree axis in device memory, the step is one jitted
program, and scale-out is a `jax.sharding.Mesh` instead of a
thread pool.

Public surface:

* `eldorado_tpu.vec` — `VecEnv`, `vec_reset`/`vec_step`/`vec_sample`,
  `rollout`/`rollout_chunked`/`kernel_rollout` (lockstep batches,
  auto-reset).
* `eldorado_tpu.stream` — the per-step learner feed: packed trajectory
  records off the kernel scan, streamed through the native
  `TrajectoryRing` to a consumer thread (`stream_rollout`).
* `eldorado_tpu.compat` — a `city_of_gold`-shaped module mirror
  (structured dtypes, `cog_env`, `action_sampler`, `vec` getters).
* `eldorado_tpu.parallel` — mesh construction, `ShardedRunner` (incl.
  the per-shard blocked rollout driver), and the multi-process
  pod bootstrap (`parallel.bootstrap`).
* `eldorado_tpu.core.engine` — the single-env jitted reset/step/sampler.
* `eldorado_tpu.ops.rng` — bit-exact libstdc++ minstd_rand0 /
  uniform_int_distribution streams.
"""
from . import constants, errors
from .constants import Difficulty
from .errors import GenerateMapFailure, MapCapacityError
from .vec import (VecEnv, check_map_generation, kernel_rollout, rollout,
                  rollout_chunked, sampler_init, vec_reset, vec_sample,
                  vec_step)
from .stream import stream_rollout

__all__ = [
    "constants", "errors", "Difficulty",
    "GenerateMapFailure", "MapCapacityError",
    "VecEnv", "vec_reset", "vec_step", "vec_sample", "sampler_init",
    "rollout", "rollout_chunked", "kernel_rollout", "check_map_generation",
    "stream_rollout",
]

__version__ = "0.4.0"
