"""Multi-process runtime glue (reference P10: the dask distributed
scheduler, pyproject.toml:11 `dask[complete]`, replaced by the JAX
multi-process runtime).

The usual deployment is ONE process driving every local device (for
example four GPUs of one host): `initialize()` is then a no-op and
`make_host_chip_mesh()` lays the local devices out as a (data, time)
mesh. A multi-process job is launched explicitly: each process sets
`JAX_COORDINATOR_ADDRESS`, `JAX_NUM_PROCESSES` and `JAX_PROCESS_ID` (or
passes them to `initialize()`), and feeds its shard through
`global_from_local`. Everything downstream (chunked_* transforms,
shard_map halo exchange) is identical either way.
"""
from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["initialize", "make_host_chip_mesh", "global_from_local",
           "is_distributed"]

_initialized = False


def _runtime_initialized() -> bool:
    """Has jax.distributed been initialized (by us or the launcher)?"""
    try:
        from jax._src import distributed as _dist
        return _dist.global_state.client is not None
    except Exception:
        return _initialized


def is_distributed() -> bool:
    """True when the multi-process runtime is up (initialized by this
    module OR externally, e.g. a launcher script)."""
    return _runtime_initialized() and jax.process_count() > 1


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               **kw):
    """Initialize the JAX multi-process runtime (idempotent).

    Arguments default to JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID. Without a coordinator address this is a no-op and
    the process drives its local devices alone.
    """
    global _initialized
    if _initialized or _runtime_initialized():
        _initialized = True
        return
    coordinator_address = (coordinator_address or
                           os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if coordinator_address is None:
        return  # single-process run
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=(num_processes if num_processes is not None
                       else int(env_np) if env_np else None),
        process_id=(process_id if process_id is not None
                    else int(env_pid) if env_pid else None),
        **kw)
    _initialized = True


def make_host_chip_mesh(axis_names=("data", "time"),
                        time_parallel=None) -> Mesh:
    """Mesh over ALL global devices: processes map to 'data' (each
    process's recordings stay local) and its devices to 'time'.

    `time_parallel` overrides the size of the 'time' axis (must divide
    the global device count; default: the local device count).
    """
    devs = jax.devices()
    n = len(devs)
    tp = time_parallel if time_parallel is not None else \
        jax.local_device_count()
    if n % tp:
        raise ValueError(f"time_parallel={tp} must divide {n} devices")
    devs = sorted(devs, key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs).reshape(n // tp, tp), axis_names)


def global_from_local(x_local, mesh: Mesh, spec: P):
    """Assemble a global array from per-process local shards.

    `x_local`: this process's shard (numpy/jax array); `spec`: the GLOBAL
    PartitionSpec. Single-process: equivalent to a device_put with the
    given sharding.
    """
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(x_local, sharding)
    return jax.make_array_from_process_local_data(sharding, x_local)
