"""Worker for the multi-process bootstrap test (not a pytest module).

Run as: python tests/_mp_worker.py <coordinator_port> <process_id> <n_procs>

Each process sees 4 virtual CPU devices; the group forms a (n_procs, 4)
("host","chip") mesh. The worker builds its process-local env rows via
bootstrap.vec_reset_distributed, runs a short sharded rollout, and checks
its addressable shard rows bit-exactly against a single-device reference
computed locally (every process can afford the tiny global batch here —
the point is that the *construction path* never materialises it).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
port, pid, n_procs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

# CPU only, so the two processes never contend for one accelerator
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=n_procs, process_id=pid)
assert jax.process_count() == n_procs, jax.process_count()
assert len(jax.devices()) == 4 * n_procs, len(jax.devices())

from eldorado_tpu import vec  # noqa: E402
from eldorado_tpu.core import engine as E  # noqa: E402
from eldorado_tpu.parallel import bootstrap, runner  # noqa: E402
from eldorado_tpu.parallel.mesh import make_mesh  # noqa: E402

N = 16
mesh = make_mesh()
assert mesh.devices.shape == (n_procs, 4), mesh.devices.shape

start, stop = bootstrap.local_env_range(mesh, N)
per = N // n_procs
assert (start, stop) == (pid * per, (pid + 1) * per), (start, stop)

states, rngs = bootstrap.vec_reset_distributed(
    mesh, seed=5, n_envs=N, n_players=4, n_pieces=2, max_steps=8)

# reference: the single-controller construction + rollout of the same batch
ref_states = vec.vec_reset(5, N, 4, 2, 0, 8)
ref_rngs = vec.sampler_init(42, N)

def local_rows(garr):
    shards = sorted((s for s in garr.addressable_shards),
                    key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards])

for name in E.EnvState._fields:
    got = local_rows(getattr(states, name))
    want = np.asarray(getattr(ref_states, name))[start:stop]
    assert np.array_equal(got, want), f"reset mismatch: {name}"
assert np.array_equal(local_rows(rngs), np.asarray(ref_rngs)[start:stop])

# one short multi-process sharded rollout must match the single-device scan
out_s, out_r, _stats = runner.sharded_rollout(mesh, states, rngs, 10)
ref_s, ref_r, _ = vec.rollout(ref_states, ref_rngs, 10, auto_reset="step")
for name in E.EnvState._fields:
    got = local_rows(getattr(out_s, name))
    want = np.asarray(getattr(ref_s, name))[start:stop]
    assert np.array_equal(got, want), f"rollout mismatch: {name}"
assert np.array_equal(local_rows(out_r), np.asarray(ref_r)[start:stop])

print(f"MP_WORKER_OK {pid}")
