"""Multi-process bootstrap: per-host env construction (parallel/bootstrap).

The reference partitions envs across workers inside one process
(reference: include/runner.h:36-38); the pod-scale analogue partitions the
batch across *processes*, each host constructing only its own rows (env i
seeded seed + i, include/vec_environment.h:38-44). These tests prove the
per-host construction is bit-identical to the single-controller path —
first in-process (slice algebra + assembly on the virtual mesh), then in a
real 2-process jax.distributed group over subprocesses.
"""
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from eldorado_tpu import vec
from eldorado_tpu.core import engine as E
from eldorado_tpu.parallel import bootstrap
from eldorado_tpu.parallel import mesh as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_local_env_range_single_process():
    mesh = M.make_mesh(8)
    assert bootstrap.local_env_range(mesh, 32) == (0, 32)


def test_distributed_reset_matches_single_controller():
    """Single-process degenerate case: vec_reset_distributed must equal
    shard_envs(vec_reset(...)) exactly, sharding included."""
    mesh = M.make_mesh(8)
    states, rngs = bootstrap.vec_reset_distributed(
        mesh, seed=5, n_envs=16, n_pieces=2, max_steps=50)
    ref = M.shard_envs(vec.vec_reset(5, 16, 4, 2, 0, 50), mesh)
    ref_rngs = vec.sampler_init(42, 16)
    for name in E.EnvState._fields:
        got = getattr(states, name)
        assert np.array_equal(np.asarray(got), np.asarray(
            getattr(ref, name))), name
        assert got.sharding == M.env_sharding(mesh), name
    assert np.array_equal(np.asarray(rngs), np.asarray(ref_rngs))


def test_per_host_slice_seeding():
    """The seed algebra behind per-host construction: rows [s, e) built
    with vec_reset(seed + s, e - s) equal rows [s, e) of the global
    construction — so no host ever needs the global batch."""
    N = 12
    full = vec.vec_reset(5, N, 4, 2, 0, 50)
    for start, stop in ((0, 4), (4, 8), (8, 12)):
        part = vec.vec_reset(5 + start, stop - start, 4, 2, 0, 50)
        for name in E.EnvState._fields:
            assert np.array_equal(
                np.asarray(getattr(part, name)),
                np.asarray(getattr(full, name))[start:stop]), name


@pytest.mark.slow
def test_two_process_bootstrap_and_rollout():
    """Real 2-process jax.distributed group on CPU: per-host construction
    + a sharded rollout, each process checking its addressable shards
    bit-exactly (tests/_mp_worker.py)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(ROOT, ".jax_cache")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_mp_worker.py"),
         str(port), str(i), "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"MP_WORKER_OK {i}" in out, out
