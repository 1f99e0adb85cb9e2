"""Device-mesh and sharding helpers.

The reference distributes the design vector (and the sparse-constraint vector)
in 1-D blocks over MPI ranks (`ParOptVec.{h,cpp}`, offsets via MPI_Allgather at
`ParOptInteriorPoint.cpp:214-229`).  The JAX-native equivalent: the design axis
``n`` is sharded over a 1-D `jax.sharding.Mesh` axis (named ``"d"``) with a
`NamedSharding`; everything of size ``ncon`` / ``qn_subspace`` is replicated.
All cross-device reductions then lower to XLA `all-reduce` (NCCL between GPUs) inside the
jitted step — there is no explicit communication code anywhere in the
framework (the SPMD analogue of `MPI_Allreduce`-in-vector-ops, `ParOptVec.cpp:
63-143`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "DESIGN_AXIS",
    "HOST_AXIS",
    "design_mesh",
    "design_sharding",
    "replicated_sharding",
    "shard_design",
    "replicate",
    "init_distributed",
    "hybrid_design_mesh",
]

# Name of the mesh axis over which design-dimension arrays are sharded.
DESIGN_AXIS = "d"
# Outer (cross-host) mesh axis of the hybrid multi-host mesh.
HOST_AXIS = "host"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize multi-process (multi-host) JAX — the SPMD analogue of the
    reference's `MPI_Init` (every rank runs the same program; the runtime
    wires the global device view).

    All arguments default to JAX's own environment discovery
    (`JAX_COORDINATOR_ADDRESS`/`JAX_NUM_PROCESSES`/`JAX_PROCESS_ID`, or a
    cluster JAX detects).  Safe to call once per process
    before any device access; a no-op when already initialized."""
    if getattr(jax.distributed, "is_initialized", None) is not None \
            and jax.distributed.is_initialized():  # pragma: no cover
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def hybrid_design_mesh(n_hosts: Optional[int] = None,
                       local_devices: Optional[int] = None,
                       devices: Optional[Sequence[jax.Device]] = None
                       ) -> Mesh:
    """2-D ('host', 'd') mesh for multi-host runs: the outer axis crosses
    hosts (the slower network), the inner axis stays within a host's
    devices.

    Design-dimension arrays shard over BOTH axes — `P(('host', 'd'))` — so
    each chip owns one contiguous block of the design vector (the
    reference's 1-D block distribution, `ParOptVec.h:75-98`) and XLA's
    hierarchical all-reduce stays within a host before crossing hosts.

    In a single process the mesh is a reshape of the device list; in a
    multi-process run each row of the mesh is one process's devices."""
    if devices is None:
        devices = jax.devices()
    if n_hosts is None:
        n_hosts = max(jax.process_count(), 1)
    if local_devices is None:
        local_devices = len(devices) // n_hosts
    assert n_hosts * local_devices == len(devices), \
        (n_hosts, local_devices, len(devices))
    if jax.process_count() > 1:
        # group the outer axis by owning process (each row of the mesh =
        # one process's local devices, so the inner-axis collectives stay
        # process-local)
        devs = sorted(devices, key=lambda d: (d.process_index, d.id))
        dev_mesh = np.asarray(devs).reshape(n_hosts, local_devices)
    else:
        dev_mesh = np.asarray(devices).reshape(n_hosts, local_devices)
    return Mesh(dev_mesh, (HOST_AXIS, DESIGN_AXIS))


def _design_spec(mesh: Mesh) -> P:
    """PartitionSpec sharding the design axis over every mesh axis."""
    if HOST_AXIS in mesh.axis_names:
        return P((HOST_AXIS, DESIGN_AXIS))
    return P(DESIGN_AXIS)


def design_mesh(devices: Optional[Sequence[jax.Device]] = None,
                n_devices: Optional[int] = None) -> Mesh:
    """Create a 1-D mesh over ``devices`` (default: all available)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DESIGN_AXIS,))


def design_sharding(mesh: Optional[Mesh]) -> Optional[NamedSharding]:
    """Sharding for a [n]-shaped (or leading-axis-n) design-dimension array.
    On a hybrid ('host', 'd') mesh the design axis shards over both axes."""
    if mesh is None:
        return None
    return NamedSharding(mesh, _design_spec(mesh))


def row_sharding(mesh: Optional[Mesh]) -> Optional[NamedSharding]:
    """Sharding for a [k, n] array of stacked design vectors: shard axis 1."""
    if mesh is None:
        return None
    spec = _design_spec(mesh)
    return NamedSharding(mesh, P(None, *spec))


def replicated_sharding(mesh: Optional[Mesh]) -> Optional[NamedSharding]:
    if mesh is None:
        return None
    return NamedSharding(mesh, P())


def shard_design(x: jax.Array, mesh: Optional[Mesh]) -> jax.Array:
    """Place a design-dimension array with block sharding on its last... first
    axis.  1-D arrays [n] shard on axis 0; 2-D [k, n] stacks shard on axis 1."""
    if mesh is None:
        return x
    if x.ndim == 1:
        return jax.device_put(x, design_sharding(mesh))
    return jax.device_put(x, row_sharding(mesh))


def replicate(x: jax.Array, mesh: Optional[Mesh]) -> jax.Array:
    if mesh is None:
        return x
    return jax.device_put(x, replicated_sharding(mesh))
