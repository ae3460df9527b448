"""Global terrain map: a grid of procedurally generated cells + border.

The reference generator's behavior (legged_gym/utils/terrain.py:38-164):
an int16 global heightfield at horizontal_scale=0.1 m /
vertical_scale=0.005 m with a border, three selection modes (curriculum /
randomized / selected), difficulty-parameterized primitives, and per-cell
spawn origins at the max height of the central 2x2 m patch. Generation is
host-side numpy with the same seeded generator and primitives as the JAX
package, so the same seed gives bit-identical heights.

The device-side product is a ``TerrainGrid``: a float32 height map (meters)
on the env's device plus metadata, read by the contact window and the
height scanner.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from benchmark.reference.terrain import primitives as P


@dataclasses.dataclass(frozen=True)
class TerrainGrid:
    """Device-side terrain. ``height[r, c]`` in meters; world (x, y) maps to
    (r, c) = ((x + border) / hs, (y + border) / hs)."""
    height: torch.Tensor         # (R, C) float32, meters
    raw: np.ndarray              # (R, C) int16 (reference height_field_raw)
    horizontal_scale: float
    vertical_scale: float
    border_size: float
    # trimesh vertical-face collision rule: cells whose corner spread
    # exceeds this (meters; slope_treshold * horizontal_scale) collide as
    # a flat floor at the min corner with a vertical wall at the gridline,
    # the sampler-level equivalent of the reference's slope-corrected
    # trimesh (utils/terrain.py:69-73). 0 = plain bilinear (heightfield)
    wall_thresh: float = 0.0


class Terrain:
    """Host-side generator (init-time numpy). Public surface matches the
    reference ``Terrain`` (terrain.py:38): ``height_field_raw``,
    ``env_origins``, plus ``grid()`` for the device product."""

    def __init__(self, cfg, num_robots, seed=0):
        self.cfg = cfg
        self.num_robots = num_robots
        self.type = cfg.mesh_type
        self.rng = np.random.default_rng(seed)
        if self.type in ["none", "plane"]:
            return
        nr, nc = cfg.num_rows, cfg.num_cols
        hs = cfg.horizontal_scale
        self.env_length = cfg.terrain_length   # consumed by the terrain
        self.env_width = cfg.terrain_width     # curriculum (legged_env)
        self.cell_m = (cfg.terrain_length, cfg.terrain_width)
        self.cell_px = (int(cfg.terrain_length / hs),
                        int(cfg.terrain_width / hs))
        self.border_px = int(cfg.border_size / hs)
        self._cum_props = np.cumsum(cfg.terrain_proportions)

        stack = np.zeros((nr, nc) + self.cell_px, np.int16)
        for (i, j), (choice, difficulty) in self._plan(nr, nc):
            stack[i, j] = self._build_cell(choice, difficulty)

        self.height_field_raw = self._assemble(stack)
        self.env_origins = self._origins(stack)
        self.heightsamples = self.height_field_raw

    @functools.cached_property
    def _mesh(self):
        """(vertices, triangles) of a trimesh terrain, built when first
        read: the simulation collides against ``grid()`` and its wall rule,
        only a viewer needs the mesh."""
        if self.type != "trimesh":
            raise AttributeError(f"a {self.type} terrain has no mesh")
        return convert_heightfield_to_trimesh(
            self.height_field_raw, self.cfg.horizontal_scale,
            self.cfg.vertical_scale, self.cfg.slope_treshold)

    @property
    def vertices(self):
        return self._mesh[0]

    @property
    def triangles(self):
        return self._mesh[1]

    # ------------------------------------------------------------- plan
    def _plan(self, nr, nc):
        """Yield ((row, col), (choice, difficulty)) per cell — the three
        selection modes of reference terrain.py:75-107."""
        cfg = self.cfg
        for i in range(nr):
            for j in range(nc):
                if cfg.curriculum:
                    yield (i, j), (j / nc + 0.001, i / nr)
                elif cfg.selected:
                    yield (i, j), (None, None)
                else:
                    yield (i, j), (self.rng.uniform(0, 1),
                                   self.rng.choice([0.5, 0.75, 0.9]))

    # --------------------------------------------------------- generate
    def _build_cell(self, choice, difficulty):
        """One cell heightfield. The difficulty->parameter formulas and
        the cumulative-proportion dispatch mirror reference
        terrain.py:109-145 exactly (they define the task family)."""
        cfg = self.cfg
        hs, vs = cfg.horizontal_scale, cfg.vertical_scale
        hf = np.zeros(self.cell_px, np.int16)

        if choice is None:                    # "selected" mode
            kwargs = dict(cfg.terrain_kwargs)
            getattr(P, kwargs.pop("type"))(hf, hs, vs, **kwargs)
            return hf

        d = difficulty
        cp = self._cum_props
        if choice < cp[0]:
            sgn = -1.0 if choice < cp[0] / 2 else 1.0
            P.pyramid_sloped(hf, hs, vs, slope=sgn * d * 0.4,
                             platform_size=3.0)
        elif choice < cp[1]:
            P.pyramid_sloped(hf, hs, vs, slope=d * 0.4, platform_size=3.0)
            P.random_uniform(hf, hs, vs, min_height=-0.05, max_height=0.05,
                             step=0.005, downsampled_scale=0.2,
                             rng=self.rng)
        elif choice < cp[3]:
            sgn = -1.0 if choice < cp[2] else 1.0
            P.pyramid_stairs(hf, hs, vs, step_width=0.31,
                             step_height=sgn * (0.05 + 0.18 * d),
                             platform_size=3.0)
        elif choice < cp[4]:
            P.discrete_obstacles(hf, hs, vs, 0.05 + d * 0.2, 1.0, 2.0, 20,
                                 platform_size=3.0, rng=self.rng)
        elif len(cp) > 5 and choice < cp[5]:
            P.stepping_stones(hf, hs, vs,
                              stone_size=1.5 * (1.05 - d),
                              stone_distance=(0.05 if d == 0 else 0.1),
                              max_height=0.0, platform_size=4.0,
                              rng=self.rng)
        elif len(cp) > 6 and choice < cp[6]:
            P.gap(hf, hs, vs, gap_size=1.0 * d, platform_size=3.0)
        elif len(cp) > 5:
            P.pit(hf, hs, vs, depth=1.0 * d, platform_size=4.0)
        else:
            P.discrete_obstacles(hf, hs, vs, 0.05 + d * 0.2, 1.0, 2.0, 20,
                                 platform_size=3.0, rng=self.rng)
        return hf

    # --------------------------------------------------------- assemble
    def _assemble(self, stack):
        """(nr, nc, h, w) cell stack -> bordered global int16 field in one
        transpose+reshape+pad (no per-cell blitting)."""
        nr, nc, h, w = stack.shape
        interior = stack.transpose(0, 2, 1, 3).reshape(nr * h, nc * w)
        b = self.border_px
        return np.pad(interior, ((b, b), (b, b)))

    def _origins(self, stack):
        """(nr, nc, 3) spawn origins: cell centers in xy; z = max height
        of the central 2x2 m patch (reference terrain.py:158-164),
        vectorized over all cells."""
        nr, nc, h, w = stack.shape
        hs, vs = self.cfg.horizontal_scale, self.cfg.vertical_scale
        Lm, Wm = self.cell_m
        x1, x2 = int((Lm / 2 - 1) / hs), int((Lm / 2 + 1) / hs)
        y1, y2 = int((Wm / 2 - 1) / hs), int((Wm / 2 + 1) / hs)
        z = stack[:, :, x1:x2, y1:y2].max(axis=(2, 3)) * vs
        ox = (np.arange(nr)[:, None] + 0.5) * Lm * np.ones((1, nc))
        oy = np.ones((nr, 1)) * (np.arange(nc)[None, :] + 0.5) * Wm
        return np.stack([ox, oy, z], axis=-1)

    # ----------------------------------------------------------- device
    def grid(self, device="cuda") -> TerrainGrid:
        h = self.height_field_raw.astype(np.float32) * self.cfg.vertical_scale
        wall = 0.0
        if self.type == "trimesh":
            wall = self.cfg.slope_treshold * self.cfg.horizontal_scale
        return TerrainGrid(height=torch.as_tensor(h, device=device),
                           raw=self.height_field_raw,
                           horizontal_scale=self.cfg.horizontal_scale,
                           vertical_scale=self.cfg.vertical_scale,
                           border_size=self.cfg.border_size,
                           wall_thresh=wall)


def convert_heightfield_to_trimesh(hf, horizontal_scale, vertical_scale,
                                   slope_threshold=0.75):
    """Heightfield -> (vertices, triangles) with steep slopes corrected to
    vertical faces (API parity with isaacgym.terrain_utils, for export /
    rendering). The collision path applies the equivalent correction at
    the sampler level via ``TerrainGrid.wall_thresh``."""
    rows, cols = hf.shape
    y = np.linspace(0, (cols - 1) * horizontal_scale, cols)
    x = np.linspace(0, (rows - 1) * horizontal_scale, rows)
    yy, xx = np.meshgrid(y, x)
    z = hf.astype(np.float32) * vertical_scale

    if slope_threshold is not None:
        # shift vertices at steep slopes horizontally so faces go vertical
        st = slope_threshold * horizontal_scale / vertical_scale
        move_x = np.zeros((rows, cols))
        move_y = np.zeros((rows, cols))
        move_x[: rows - 1] += hf[1:] - hf[: rows - 1] > st
        move_x[1:] -= hf[: rows - 1] - hf[1:] > st
        move_y[:, : cols - 1] += hf[:, 1:] - hf[:, : cols - 1] > st
        move_y[:, 1:] -= hf[:, : cols - 1] - hf[:, 1:] > st
        xx += move_x * horizontal_scale
        yy += move_y * horizontal_scale

    vertices = np.stack([xx.ravel(), yy.ravel(), z.ravel()],
                        axis=1).astype(np.float32)
    idx = np.arange(rows * cols).reshape(rows, cols)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    tris = np.concatenate([
        np.stack([a, c, d], axis=1),
        np.stack([a, d, b], axis=1),
    ]).astype(np.uint32)
    return vertices, tris
