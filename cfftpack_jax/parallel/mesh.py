"""Device-mesh helpers.

Thin wrappers over jax.sharding.Mesh so callers (tests, apps, bench)
build 1-D/2-D meshes the same way on real devices and on the
virtual host-platform device pool (XLA_FLAGS=
--xla_force_host_platform_device_count=N).
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

__all__ = ["make_mesh", "local_mesh"]


def make_mesh(shape=None, axis_names=("data",), devices=None) -> Mesh:
    """Build a Mesh of the given logical shape over available devices.

    ``shape=None`` uses all devices on one axis.  Example:
    ``make_mesh((4, 2), ("data", "model"))``.
    """
    devs = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devs),)
    if int(np.prod(shape)) > len(devs):
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} "
                         f"devices, have {len(devs)}")
    devs = devs[: int(np.prod(shape))]
    arr = np.array(devs, dtype=object).reshape(shape)
    if len(axis_names) != len(shape):
        raise ValueError("axis_names must match mesh rank")
    return Mesh(arr, axis_names)


def local_mesh(n: int | None = None, axis: str = "data") -> Mesh:
    """1-D mesh over the first ``n`` (default: all) local devices."""
    devs = jax.devices()
    n = len(devs) if n is None else n
    return make_mesh((n,), (axis,), devices=devs[:n])


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialize multi-host JAX (jax.distributed) for a cluster.

    Pass the arguments explicitly where no cluster environment
    supplies them.  After this, jax.devices() spans all hosts and the
    mesh helpers above build global meshes.
    """
    import jax
    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    return jax.process_index(), jax.process_count()
