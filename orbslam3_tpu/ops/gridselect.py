"""Spatially-uniform keypoint selection (replaces the CPU quadtree).

The reference's DistributeOctTree (src/ORBextractor.cc:226-431) recursively
splits the image until the node count reaches the per-level budget, then
keeps the best-response keypoint per node — i.e. it spends the budget
breadth-first across space, densifying only where corners are dense.

Fixed-shape equivalent (fixed-shape, sort-based): bucket candidates into a
regular grid and select in *round-robin rank order* — every cell's best
candidate first, then every cell's second best, etc., until the budget is
filled; ties inside a rank resolved by response.  This reproduces the
quadtree's spatial uniformity property (SURVEY §7.4 item 3) with two
argsorts instead of a sequential tree.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def select_uniform(xy: jnp.ndarray, response: jnp.ndarray, valid: jnp.ndarray,
                   hw: tuple[int, int], grid: tuple[int, int],
                   budget: int) -> jnp.ndarray:
    """Pick `budget` candidate indices, spatially spread.

    xy: (M, 2) float pixel coords; response: (M,); valid: (M,) bool.
    hw: image (h, w); grid: (rows, cols).  Returns (budget,) int32 indices
    into the candidate arrays, with -1 padding where fewer than `budget`
    valid candidates exist.
    """
    m = xy.shape[0]
    rows, cols = grid
    h, w = hw
    cy = jnp.clip((xy[:, 1] * (rows / h)).astype(jnp.int32), 0, rows - 1)
    cx = jnp.clip((xy[:, 0] * (cols / w)).astype(jnp.int32), 0, cols - 1)
    cell = cy * cols + cx
    n_cells = rows * cols

    # responses quantized to integers (FAST scores <= 255) so the
    # lexicographic sort keys are exact in int32
    r = jnp.clip(response, 0.0, 4094.0)
    rq = (r * 16.0).astype(jnp.int32)  # 16x sub-integer resolution
    maxr = 1 << 16

    cell_v = jnp.where(valid, cell, n_cells)  # invalid -> sentinel cell
    # pass 1: sort by (cell asc, response desc)
    key1 = cell_v * maxr + (maxr - 1 - rq)
    order1 = jnp.argsort(key1)
    cells_s = cell_v[order1]
    rq_s = rq[order1]
    valid_s = valid[order1]

    # rank within cell: index minus index-of-first-element-of-cell
    idx = jnp.arange(m)
    is_first = jnp.concatenate([jnp.array([True]), cells_s[1:] != cells_s[:-1]])
    cell_start = jax.lax.cummax(jnp.where(is_first, idx, 0))
    rank = idx - cell_start

    # pass 2: sort by (rank asc, response desc); invalids pushed to the end
    key2 = jnp.where(valid_s, rank * maxr + (maxr - 1 - rq_s),
                     jnp.iinfo(jnp.int32).max)
    order2 = jnp.argsort(key2)
    chosen = order1[order2[:budget]]
    ok = valid_s[order2[:budget]]
    return jnp.where(ok, chosen, -1)
