"""Device-side heightfield queries (batch-last).

- ``sample_min3``: the reference's observation-scan rule — integer cell
  lookup taking the min of (r,c), (r+1,c), (r,c+1)
  (legged_robot.py:842-852);
- ``sample_bilinear``: C0 height + analytic in-cell gradient;
- per-env windows: ``extract_patches`` / ``PatchExtractor`` cut one
  (S, S) window per env by a plain gather, and ``patch_sample_min3``
  evaluates the scan rule against it.

``None`` grid means an infinite flat plane at z=0. The JAX package builds
the windows from a superblock table and one-hot contractions, a TPU
workaround; a gather gives the same values.
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
    """Returns (h, dh/dx, dh/dy) at world (x, y); flat plane if grid None."""
    if grid is None:
        z = torch.zeros_like(x)
        return z, z, z
    if grid.wall_thresh > 0.0:
        raise NotImplementedError("the trimesh wall rule is not ported")
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
