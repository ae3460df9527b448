"""Device-side heightfield queries (batch-last).

- ``sample_min3``: the reference's observation-scan rule — integer cell
  lookup taking the min of (r,c), (r+1,c), (r,c+1)
  (legged_robot.py:842-852);
- ``sample_bilinear``: C0 height + analytic in-cell gradient;
- per-env windows: ``extract_patches`` / ``PatchExtractor`` cut one
  (S, S) window per env by a plain gather; ``patch_sample_min3`` (the
  scan rule) and ``patch_sample_bilinear`` (the general engine's contact
  sampling, with the trimesh wall rule) evaluate against it.

``None`` grid means an infinite flat plane at z=0. The JAX package builds
the windows from a superblock table and queries them by one-hot
contractions, TPU workarounds; gathers give the same values.
"""
from __future__ import annotations

import dataclasses

import torch


def _cell_coords(grid, x, y):
    hs = grid.horizontal_scale
    R, C = grid.height.shape
    fx = torch.clamp((x + grid.border_size) / hs, 0.0, R - 2.001)
    fy = torch.clamp((y + grid.border_size) / hs, 0.0, C - 2.001)
    ix = torch.floor(fx).to(torch.int64)
    iy = torch.floor(fy).to(torch.int64)
    return ix, iy, fx - ix, fy - iy


def _gather(grid, ix, iy):
    C = grid.height.shape[1]
    return grid.height.reshape(-1)[ix * C + iy]


def sample_min3(grid, x, y):
    """Reference height-scan sampling: min of 3 neighbor cells, meters."""
    if grid is None:
        return torch.zeros_like(x)
    ix, iy, _, _ = _cell_coords(grid, x, y)
    h1 = _gather(grid, ix, iy)
    h2 = _gather(grid, ix + 1, iy)
    h3 = _gather(grid, ix, iy + 1)
    return torch.minimum(torch.minimum(h1, h2), h3)


def sample_bilinear(grid, x, y):
    """Returns (h, dh/dx, dh/dy) at world (x, y); flat plane if grid None.

    When ``grid.wall_thresh > 0`` (trimesh) cells whose corner spread
    exceeds it collide as a flat floor at the min corner, the vertical-face
    rule (TerrainGrid.wall_thresh): stairs are steps, not ramps."""
    if grid is None:
        z = torch.zeros_like(x)
        return z, z, z
    ix, iy, tx, ty = _cell_coords(grid, x, y)
    h00 = _gather(grid, ix, iy)
    h10 = _gather(grid, ix + 1, iy)
    h01 = _gather(grid, ix, iy + 1)
    h11 = _gather(grid, ix + 1, iy + 1)
    h0 = h00 * (1 - tx) + h10 * tx
    h1 = h01 * (1 - tx) + h11 * tx
    h = h0 * (1 - ty) + h1 * ty
    inv_hs = 1.0 / grid.horizontal_scale
    dhdx = ((h10 - h00) * (1 - ty) + (h11 - h01) * ty) * inv_hs
    dhdy = ((h01 - h00) * (1 - tx) + (h11 - h10) * tx) * inv_hs
    if grid.wall_thresh > 0.0:
        m4 = torch.minimum(torch.minimum(h00, h10), torch.minimum(h01, h11))
        big4 = torch.maximum(torch.maximum(h00, h10),
                             torch.maximum(h01, h11))
        steep = (big4 - m4) > grid.wall_thresh
        h = torch.where(steep, m4, h)
        dhdx = torch.where(steep, 0.0, dhdx)
        dhdy = torch.where(steep, 0.0, dhdy)
    return h, dhdx, dhdy


# ------------------------------------------------------- per-env windows

PATCH_SIZE = 32


@dataclasses.dataclass(frozen=True)
class TerrainPatch:
    h: torch.Tensor       # (N, S, S) heights, meters
    r0: torch.Tensor      # (N,) int32 window origin (row)
    c0: torch.Tensor      # (N,) int32 window origin (col)


def window_origin(grid, x, y, size):
    """(r0, c0) int32 (N,): the window of ``size`` cells centered at world
    (x, y), clamped into the grid."""
    hs = grid.horizontal_scale
    R, C = grid.height.shape
    r0 = torch.clamp(((x + grid.border_size) / hs).to(torch.int32)
                     - size // 2, 0, R - size)
    c0 = torch.clamp(((y + grid.border_size) / hs).to(torch.int32)
                     - size // 2, 0, C - size)
    return r0.to(torch.int32), c0.to(torch.int32)


def gather_windows(height, r0, c0, size):
    """(N, size, size) windows of ``height`` at origins (r0, c0)."""
    ar = torch.arange(size, device=height.device)
    rows = r0.to(torch.int64)[:, None] + ar[None]             # (N, S)
    cols = c0.to(torch.int64)[:, None] + ar[None]
    return height[rows[:, :, None], cols[:, None, :]]


def extract_patches(grid, x, y, size=PATCH_SIZE):
    """One (size, size) window per env centered at world (x, y) — (N,)
    each. Returns (h (N, S, S), r0 (N,) int32, c0 (N,) int32)."""
    r0, c0 = window_origin(grid, x, y, size)
    return gather_windows(grid.height, r0, c0, size), r0, c0


class PatchExtractor:
    """Per-env window extraction with the JAX package's contract
    (``__call__(x, y) -> TerrainPatch``), as one plain gather."""

    def __init__(self, grid, size=PATCH_SIZE):
        self.grid = grid
        self.size = int(size)

    def __call__(self, x, y):
        h, r0, c0 = extract_patches(self.grid, x, y, self.size)
        return TerrainPatch(h=h, r0=r0, c0=c0)


def _patch_coords(grid, patch, x, y):
    """World (P, N) -> clamped in-patch cell coords (P, N)."""
    hs = grid.horizontal_scale
    S = patch.h.shape[-1]
    fx = (x + grid.border_size) / hs - patch.r0[None, :]
    fy = (y + grid.border_size) / hs - patch.c0[None, :]
    fx = torch.clamp(fx, 0.0, S - 1.001)
    fy = torch.clamp(fy, 0.0, S - 1.001)
    ix = torch.floor(fx).to(torch.int64)
    iy = torch.floor(fy).to(torch.int64)
    return ix, iy, fx - ix, fy - iy


def patch_sample_min3(grid, patch, x, y):
    """Reference min-of-3-cells scan rule (legged_robot.py:848-852)
    against the per-env patch: the min3 stencil on the patch, then one
    gather per query. x, y: (P, N)."""
    if grid is None or patch is None:
        return sample_min3(grid, x, y)
    h = patch.h                                            # (N, S, S)
    S = h.shape[-1]
    m3 = torch.minimum(h, torch.minimum(
        torch.cat([h[:, 1:], h[:, -1:]], dim=1),
        torch.cat([h[:, :, 1:], h[:, :, -1:]], dim=2)))
    ix, iy, _, _ = _patch_coords(grid, patch, x, y)
    n = h.shape[0]
    env = torch.arange(n, device=h.device)[None, :]
    return m3.reshape(n, S * S)[env, ix * S + iy]


def _patch_gather(flat, env, ix, iy, S):
    """flat: (N, S*S) window heights; (P, N) cell indices -> (P, N)."""
    return flat[env, ix * S + iy]


def patch_sample_bilinear(grid, patch, x, y):
    """(h, dh/dx, dh/dy) at world (x, y) [(P, N) each] against the per-env
    patch: four corner gathers, then the JAX package's one-hot contraction
    order (rows weighted first, then columns). Equal to sample_bilinear
    away from the patch edges; with ``grid.wall_thresh > 0`` the
    vertical-face rule reads the window's wall grid (``_wall_grid``)."""
    if grid is None or patch is None:
        return sample_bilinear(grid, x, y)
    h_w = patch.h                                          # (N, S, S)
    S = h_w.shape[-1]
    n = h_w.shape[0]
    flat = h_w.reshape(n, S * S)
    env = torch.arange(n, device=h_w.device)[None, :]
    ix, iy, tx, ty = _patch_coords(grid, patch, x, y)
    h00 = _patch_gather(flat, env, ix, iy, S)
    h10 = _patch_gather(flat, env, ix + 1, iy, S)
    h01 = _patch_gather(flat, env, ix, iy + 1, S)
    h11 = _patch_gather(flat, env, ix + 1, iy + 1, S)
    inv_hs = 1.0 / grid.horizontal_scale
    # row contraction at the two query columns, then the column one
    t0 = h00 * (1.0 - tx) + h10 * tx
    t1 = h01 * (1.0 - tx) + h11 * tx
    h = t0 * (1.0 - ty) + t1 * ty
    dhdy = t0 * -inv_hs + t1 * inv_hs
    g0 = h00 * -inv_hs + h10 * inv_hs
    g1 = h01 * -inv_hs + h11 * inv_hs
    dhdx = g0 * (1.0 - ty) + g1 * ty
    if grid.wall_thresh > 0.0:
        mw = _wall_grid(h_w, grid.wall_thresh).reshape(n, S * S)
        mq = _patch_gather(mw, env, ix, iy, S)
        steep = mq < h
        h = torch.where(steep, mq, h)
        dhdx = torch.where(steep, 0.0, dhdx)
        dhdy = torch.where(steep, 0.0, dhdy)
    return h, dhdx, dhdy


_WALL_BIG = 1e9


def _wall_grid(h, wall_thresh):
    """Per-cell wall grid for the trimesh vertical-face rule: entry
    (r, c) = min of the cell's 4 corners when the corner spread exceeds
    ``wall_thresh``, else +BIG. Elementwise shifts only; the last row /
    column is never a query cell (floor coords are clamped to S-2)."""
    hr = torch.cat([h[..., 1:, :], h[..., -1:, :]], dim=-2)
    hc = torch.cat([h[..., :, 1:], h[..., :, -1:]], dim=-1)
    hrc = torch.cat([hc[..., 1:, :], hc[..., -1:, :]], dim=-2)
    m4 = torch.minimum(torch.minimum(h, hr), torch.minimum(hc, hrc))
    big4 = torch.maximum(torch.maximum(h, hr), torch.maximum(hc, hrc))
    return torch.where(big4 - m4 > wall_thresh, m4, _WALL_BIG)
