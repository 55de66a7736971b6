"""Device-mesh sharding of batched columns + lateral halo exchange.

The reference distributes grid columns over MPI ranks with host-model
ghost-column exchange (``dtypes/UnstructuredGridType.F90:22-66``,
``alm/MPPVSFMALM_Driver.F90:483-490``).  Here the column axis is
sharded over a 1-D ``jax.sharding.Mesh`` axis ("col"); the implicit
vertical solves stay embarrassingly parallel per shard, and lateral
coupling uses `ppermute` neighbor halos inside `shard_map` — the
operator-split lateral-flux design of the reference (SURVEY §2.8) keeps
the implicit system block-diagonal per shard.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding
from jax import shard_map


def column_mesh(n_devices=None, axis="col"):
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def shard_columns(x, mesh: Mesh, axis="col"):
    """Place [ncol, ...] arrays with the column axis sharded."""
    spec = P(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def halo_exchange_1d(x, axis_name="col"):
    """Exchange boundary columns with both neighbors along a 1-D mesh axis.

    ``x`` is the local [ncol_local, nz] shard; returns (from_left,
    from_right) ghost columns [nz].  Non-periodic: edge devices receive
    their own boundary (mirrors the reference's no-lateral-flow domain
    edge).  Must be called inside shard_map.
    """
    n = jax.lax.psum(1, axis_name)
    idx = jax.lax.axis_index(axis_name)
    right_first = x[-1]  # send to right neighbor
    left_first = x[0]    # send to left neighbor
    perm_r = [(i, (i + 1) % n) for i in range(n)]
    perm_l = [(i, (i - 1) % n) for i in range(n)]
    from_left = jax.lax.ppermute(right_first, axis_name, perm_r)
    from_right = jax.lax.ppermute(left_first, axis_name, perm_l)
    # clamp edges (non-periodic)
    from_left = jnp.where(idx == 0, x[0], from_left)
    from_right = jnp.where(idx == n - 1, x[-1], from_right)
    return from_left, from_right


def lateral_flux_op_split(P_cols, conductance, axis_name="col"):
    """Explicit lateral Darcy flux between neighboring columns
    (operator-split source term, ``ge/GoveqnRichardsODEPressureType.F90:
    2615-2747`` semantics): ghost pressures via halo exchange, flux =
    -K * dP, returned as a per-column source to feed the next implicit
    vertical solve."""
    from_left, from_right = halo_exchange_1d(P_cols, axis_name)
    left = jnp.concatenate([from_left[None], P_cols[:-1]], axis=0)
    right = jnp.concatenate([P_cols[1:], from_right[None]], axis=0)
    return -conductance * ((P_cols - left) + (P_cols - right))
