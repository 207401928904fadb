"""Mesh helpers: shard independent inversions across devices.

The reference's multi-node story is "grid points are separate jobs"
(``/root/reference/model3D.py:36-57``) and chains are separate processes
(``point.py:104-107``).  Here (SURVEY.md §2.2) both are batch axes of
one SPMD program — chains vmap *within* a device, grid points shard
*across* devices on a 1-D ``points`` mesh.  No collectives are needed in
the hot loop (the problem is embarrassingly parallel); reductions only
appear in diagnostics (misfit maps), where XLA inserts them
automatically from the sharding annotations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def points_mesh(n_devices=None, devices=None):
    """1-D mesh over all (or the first n) local devices."""
    devices = np.array(devices if devices is not None
                       else jax.devices()[: n_devices])
    return Mesh(devices, axis_names=("points",))


def multislice_mesh(n_slices, per_slice=None, devices=None):
    """Plain 2-D ("dcn", "points") mesh: ``n_slices`` groups of devices.

    ``invert_grid`` shards its flat lane axis over BOTH axes, and —
    because grid points and chains are independent — the hot loop
    contains no collectives at all, so the tracks are bitwise identical
    to a flat 1-D mesh
    (tests/test_parallel_grid.py::test_multislice_mesh_identical).
    Device order matters only for placement, not results.
    """
    devices = np.asarray(devices if devices is not None
                         else jax.devices())
    per_slice = per_slice or len(devices) // n_slices
    n = n_slices * per_slice
    return Mesh(devices[:n].reshape(n_slices, per_slice),
                axis_names=("dcn", "points"))


def shard_points(mesh, tree):
    """Place a pytree of arrays with leading point axis onto the mesh."""
    sharding = NamedSharding(mesh, P("points"))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def pad_to_multiple(n, m):
    return int(-(-n // m) * m)
