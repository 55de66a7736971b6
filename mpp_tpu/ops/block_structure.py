"""COO -> batched block-tridiagonal structure.

Every KSP-path system in the framework is assembled per-column: cells are
ordered column-major (cell = col*nlev + k) and every coupling stays
within a level or reaches level k±1 of the same column (two-point flux
discretization on column meshes; radiation two-stream bands;
MATPREALLOCATOR sparsity of ``soe/SystemOfEquationsBaseType.F90:593-613``
discovers exactly this band structure).  Instead of a CSR solve, the
batched path scatters the same COO values into [ncol, nlev, m, m]
sub/diag/super blocks and solves with the exact batched block-Thomas
sweep (``ops/block_thomas``).

The template is built once from the (rows, cols) pattern at setup time
(numpy); ``assemble`` is pure jnp and jit/vmap/shard_map compatible.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from mpp_tpu.ops.block_thomas import block_thomas


def chain_shape(ncells: int, rows: np.ndarray, cols: np.ndarray,
                dof: int = 1):
    """Infer (ncol, nlev) of equal-length contiguous cell chains from a
    COO pattern whose couplings only reach cell i±1.

    Cells i and i+1 belong to the same chain iff any entry couples them;
    chains must all have the same length for the batched layout."""
    cell_r = np.asarray(rows, np.int64) // dof
    cell_c = np.asarray(cols, np.int64) // dof
    linked = np.zeros(ncells - 1, bool) if ncells > 1 else np.zeros(0, bool)
    d = cell_c - cell_r
    if np.abs(d).max(initial=0) > 1:
        raise ValueError("coupling reaches beyond cell i±1")
    m = d == 1
    linked[cell_r[m]] = True
    m = d == -1
    linked[cell_c[m]] = True
    breaks = np.nonzero(~linked)[0] + 1
    lengths = np.diff(np.concatenate([[0], breaks, [ncells]]))
    lengths = lengths[lengths > 0]
    if lengths.size == 0:
        return 1, ncells
    if np.unique(lengths).size != 1:
        raise ValueError(f"unequal chain lengths {sorted(set(lengths))}")
    nlev = int(lengths[0])
    return ncells // nlev, nlev


class BlockTridiagTemplate:
    """Maps COO entries of a per-column banded system onto L/D/U blocks.

    Global dof index convention: g = (col*nlev + k)*dof + j."""

    def __init__(self, ncol: int, nlev: int, dof: int,
                 rows: np.ndarray, cols: np.ndarray):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        cell_r, j_r = np.divmod(rows, dof)
        cell_c, j_c = np.divmod(cols, dof)
        col_r, k_r = np.divmod(cell_r, nlev)
        col_c, k_c = np.divmod(cell_c, nlev)
        if not np.array_equal(col_r, col_c):
            raise ValueError("coupling crosses column boundaries")
        dk = k_c - k_r
        if np.abs(dk).max(initial=0) > 1:
            raise ValueError("coupling reaches beyond level k±1")
        band = dk + 1  # 0 = L, 1 = D, 2 = U
        self.ncol, self.nlev, self.dof = ncol, nlev, dof
        self.dest = jnp.asarray(
            ((band * ncol + col_r) * nlev + k_r) * dof * dof
            + j_r * dof + j_c)
        self._flat_len = 3 * ncol * nlev * dof * dof

    def assemble(self, vals):
        """Scatter COO values (same order as the template's rows/cols)
        into (L, D, U) blocks [ncol, nlev, dof, dof]."""
        flat = jnp.zeros(self._flat_len, jnp.asarray(vals).dtype)
        flat = flat.at[self.dest].add(vals)
        L, D, U = flat.reshape(3, self.ncol, self.nlev, self.dof, self.dof)
        return L, D, U

    def solve(self, vals, b):
        """Assemble and solve: returns x [ncol, nlev, dof]."""
        L, D, U = self.assemble(vals)
        bb = jnp.asarray(b).reshape(self.ncol, self.nlev, self.dof)
        return block_thomas(L, D, U, bb)
