"""Row gathers over the scene's SoA tables.

- `take_rows`: `col[idx]` for small static tables (materials, entities,
  lights — the reference's DynTable payloads, src/runtime/table/DynTable.h:12),
  with the empty and one-row tables handled without a gather.
- `gather_cols`: several per-triangle attribute columns fetched at one index
  vector (the hit shader's vertex-attribute load, compare
  mapping_cpu.art:467) as one stacked [T, K] row gather.
"""
from __future__ import annotations

import jax.numpy as jnp


def take_rows(col: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """col[idx] for a small static first axis; idx must be pre-clipped."""
    r = col.shape[0]
    if r == 0:
        return jnp.zeros(idx.shape, col.dtype)
    if r == 1:
        return jnp.broadcast_to(col[0], idx.shape + col.shape[1:])
    return col[idx]


def gather_cols(idx, cols):
    """Gather len(cols) f32 columns (each [T]) at idx ([N] i32,
    pre-clipped); returns a list of [N] arrays. Differentiable in the
    column values (the gather's scatter-add adjoint)."""
    tab = jnp.stack([c.astype(jnp.float32) for c in cols], axis=1)
    out = tab[idx]
    return [out[:, j] for j in range(len(cols))]
