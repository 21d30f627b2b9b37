"""Device-mesh helpers.

The reference is single-threaded with no scaling layer (SURVEY §2.3); this is
the green-field scaling foundation: meshes over which the batched tracker
(data parallelism over sequences) and the sharded reductions (candidate-point
parallelism) are laid out.  Every GPU of a host reaches every other at the
same rate (NVLink, all to all), so a flat 1D mesh over ``jax.devices()``
serves; XLA lowers ``psum``/``all_gather`` to NCCL collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize multi-host JAX.

    Thin wrapper over ``jax.distributed.initialize`` so several hosts use
    the same meshes/collectives as one: after initialization,
    ``jax.devices()`` spans all hosts and ``make_mesh`` lays its axes over
    them in XLA's default device order.  Pass ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id`` explicitly where no
    cluster environment provides them.  No-op if already initialized.
    """
    import jax as _jax

    try:
        _jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    devices=None,
) -> Mesh:
    """Create a mesh over the available devices.

    Default: a 1D ``data`` mesh over all local devices.  Pass
    ``axis_sizes=(d, p)`` and ``axis_names=("data", "points")`` for the
    composite DP x point-sharding layout.
    """
    if devices is None:
        devices = jax.devices()
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    n = int(np.prod(axis_sizes))
    assert n <= len(devices), (axis_sizes, len(devices))
    dev_array = np.asarray(devices[:n]).reshape(axis_sizes)
    return Mesh(dev_array, axis_names)


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (batch) dimension over ``axis``; replicate the rest."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh, axis: str = "data"):
    """Place a pytree with leading batch dims onto the mesh, batch-sharded."""
    sharding = data_sharding(mesh, axis)

    def place(x):
        import jax.numpy as jnp

        x = jnp.asarray(x)
        if x.ndim == 0:
            return jax.device_put(x, replicated(mesh))
        return jax.device_put(x, NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1)))))

    return jax.tree_util.tree_map(place, tree)
