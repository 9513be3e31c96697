"""Device-mesh construction for multi-chip / multi-host env sharding.

The reference scales by pinning OS threads to cores inside one process
(reference: include/runner.h:117-133); here the scale axis is a
`jax.sharding.Mesh` over the devices of one or more hosts. The env batch is
sharded over the ("host", "chip") axes; per-env work is embarrassingly
parallel, so the only collectives are metric/trajectory reductions — see
parallel/runner.py.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENV_AXES = ("host", "chip")


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A ("host", "chip") mesh over the given (or all) devices. Hosts map to
    the process dimension when running multi-process; single-process runs get
    a 1 x n_devices mesh, which keeps the same named-axis sharding code path
    compiling for any host count."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = np.asarray(devices)
    n_hosts = max(1, len({d.process_index for d in devices.flat}))
    grid = devices.reshape(n_hosts, -1)
    return Mesh(grid, ENV_AXES)


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for the env-batch leading axis: fully split over both mesh
    axes (batch 4096 on a 1x4 mesh = 1024 envs per device)."""
    return NamedSharding(mesh, P(ENV_AXES))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_envs(states, mesh: Mesh):
    """Place a batched EnvState pytree with the env axis split over the
    mesh. All leaves share the same leading env axis."""
    sh = env_sharding(mesh)
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sh), states)
