"""Legality masks via summed-area tables.

The reference computes, per step, one ``scipy.signal.convolve2d(grid,
ones(ph, pw), "valid") == 0`` per orientation
(``dummy_env_rectangular_pin.py:1846-1850``) — a per-step hot spot whose
kernel size varies per board, which would force recompilation (or a gather
over kernels) if translated directly.

Here: build a 2-D prefix sum (summed-area table) of the occupancy grid once
per step; the occupied-cell count of ANY ``ph x pw`` rectangle is then four
gathers, so per-board dynamic component sizes are just integer offsets — no
data-dependent shapes, fully ``vmap`` friendly.
"""

from __future__ import annotations

import jax.numpy as jnp


def occupancy_sat(grid: jnp.ndarray) -> jnp.ndarray:
    """Zero-padded inclusive 2-D prefix sum: S[i, j] = sum(grid[:i, :j])."""
    s = jnp.cumsum(jnp.cumsum(grid.astype(jnp.int32), axis=0), axis=1)
    return jnp.pad(s, ((1, 0), (1, 0)))


def free_placement_mask(grid: jnp.ndarray, ph, pw) -> jnp.ndarray:
    """mask[x, y] = 1 iff a ph x pw rectangle with top-left (x, y) fits.

    "Fits" = fully inside the grid and over only unoccupied cells — exactly
    the semantics of boundary masking (rows_cols_to_mask,
    dummy_env_rectangular_pin.py:1767-1806) plus the valid-mode convolution
    test (:1846-1850). ``ph``/``pw`` may be traced scalars (per-board sizes).
    """
    h, w = grid.shape
    sat = occupancy_sat(grid)
    x = jnp.arange(h)
    y = jnp.arange(w)
    x2 = jnp.clip(x + ph, 0, h)
    y2 = jnp.clip(y + pw, 0, w)
    occupied = (sat[x2][:, y2] - sat[x][:, y2] - sat[x2][:, y] + sat[x][:, y])
    in_bounds = ((x + ph) <= h)[:, None] & ((y + pw) <= w)[None, :]
    return in_bounds & (occupied == 0)


def orientation_action_mask(grid: jnp.ndarray, comp_h, comp_w,
                            num_orientations: int) -> jnp.ndarray:
    """All orientation planes of the legal-action mask, bool[O, H, W].

    Orientation semantics follow the reference: 0 = (h, w), 1 = (w, h), and
    planes 2/3 are copies of 0/1 since 180/270-degree footprints match
    (compute_action_mask, dummy_env_rectangular_pin.py:1853-1870).
    """
    sat = occupancy_sat(grid)
    h, w = grid.shape
    x = jnp.arange(h)
    y = jnp.arange(w)

    def plane(ph, pw):
        x2 = jnp.clip(x + ph, 0, h)
        y2 = jnp.clip(y + pw, 0, w)
        occ = sat[x2][:, y2] - sat[x][:, y2] - sat[x2][:, y] + sat[x][:, y]
        inb = ((x + ph) <= h)[:, None] & ((y + pw) <= w)[None, :]
        return inb & (occ == 0)

    p0 = plane(comp_h, comp_w)
    if num_orientations == 1:
        return p0[None]
    p1 = plane(comp_w, comp_h)
    if num_orientations == 2:
        return jnp.stack([p0, p1])
    return jnp.stack([p0, p1, p0, p1])


def paint_rectangle(grid: jnp.ndarray, x, y, ph, pw,
                    value: int = 1) -> jnp.ndarray:
    """Set grid[x:x+ph, y:y+pw] = value with traced scalars (update_grid,
    dummy_env_rectangular_pin.py:1738-1765)."""
    h, w = grid.shape
    rows = jnp.arange(h)
    cols = jnp.arange(w)
    region = (((rows >= x) & (rows < x + ph))[:, None]
              & ((cols >= y) & (cols < y + pw))[None, :])
    return jnp.where(region, jnp.asarray(value, grid.dtype), grid)
