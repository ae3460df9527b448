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

import numpy as np
import torch

from legged_gym_tpu_torch.terrain import primitives as P


@dataclasses.dataclass(frozen=True)
class TerrainGrid:
    """Device-side terrain. ``height[r, c]`` in meters; world (x, y) maps to
    (r, c) = ((x + border) / hs, (y + border) / hs)."""
    height: torch.Tensor         # (R, C) float32, meters
    raw: np.ndarray              # (R, C) int16 (reference height_field_raw)
    horizontal_scale: float
    vertical_scale: float
    border_size: float
    # trimesh vertical-face rule (> 0); heightfield terrain keeps 0
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
        if self.type == "trimesh":
            raise NotImplementedError(
                "trimesh terrain (kernel variant K2) is not ported")

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
        return TerrainGrid(height=torch.as_tensor(h, device=device),
                           raw=self.height_field_raw,
                           horizontal_scale=self.cfg.horizontal_scale,
                           vertical_scale=self.cfg.vertical_scale,
                           border_size=self.cfg.border_size)
