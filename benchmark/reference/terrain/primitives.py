"""Heightfield terrain primitives (host-side numpy, init-time only).

Re-implements the behavior of the eight terrain generators the reference
uses from ``isaacgym.terrain_utils`` plus its two local ones
(gap/pit, legged_gym/utils/terrain.py:166-187). Each
function mutates ``hf`` — an int16 heightfield of shape (length_px,
width_px) in units of ``vertical_scale`` meters — the same discrete
representation the reference builds (terrain.py:60).

A SubTerrain-like context is just (hf, horizontal_scale, vertical_scale).
"""
import numpy as np


def _to_units(h_m, vertical_scale):
    return int(round(h_m / vertical_scale))


def pyramid_sloped(hf, hs, vs, slope, platform_size=3.0):
    """Pyramid slope: height rises linearly toward the center, flat
    platform of ``platform_size`` meters in the middle."""
    rows, cols = hf.shape
    cx, cy = (rows - 1) / 2, (cols - 1) / 2
    x = np.abs(np.arange(rows) - cx) / cx
    y = np.abs(np.arange(cols) - cy) / cy
    # distance-to-edge fraction (1 at center, 0 at edge)
    frac = (1 - np.maximum(x[:, None], y[None, :]))
    max_h = slope * (rows / 2) * hs
    hf += (frac * max_h / vs).astype(np.int16)
    # flat center platform at the peak height
    half = int(platform_size / hs / 2)
    r0, r1 = int(cx) - half, int(cx) + half
    c0, c1 = int(cy) - half, int(cy) + half
    hf[r0:r1, c0:c1] = hf[int(cx), int(cy)]
    return hf


def random_uniform(hf, hs, vs, min_height=-0.05, max_height=0.05,
                   step=0.005, downsampled_scale=0.2, rng=None):
    """Uniform noise in [min, max] quantized to ``step``, sampled on a
    coarse grid of ``downsampled_scale`` meters and upsampled."""
    rng = rng or np.random.default_rng()
    rows, cols = hf.shape
    hmin = _to_units(min_height, vs)
    hmax = _to_units(max_height, vs)
    nstep = max(_to_units(step, vs), 1)
    levels = np.arange(hmin, hmax + nstep, nstep)
    dr = max(int(rows * hs / downsampled_scale), 1)
    dc = max(int(cols * hs / downsampled_scale), 1)
    coarse = rng.choice(levels, size=(dr, dc))
    # nearest-neighbor upsample
    ri = np.minimum((np.arange(rows) * dr // rows), dr - 1)
    ci = np.minimum((np.arange(cols) * dc // cols), dc - 1)
    hf += coarse[np.ix_(ri, ci)].astype(np.int16)
    return hf


def pyramid_stairs(hf, hs, vs, step_width=0.31, step_height=0.18,
                   platform_size=3.0):
    """Concentric rectangular steps toward the center (negative
    step_height descends)."""
    rows, cols = hf.shape
    sw = max(int(step_width / hs), 1)
    sh = _to_units(step_height, vs)
    half_plat = int(platform_size / hs / 2)
    height = 0
    r0, r1, c0, c1 = 0, rows, 0, cols
    while (r1 - r0) > 2 * half_plat and (c1 - c0) > 2 * half_plat:
        r0 += sw; r1 -= sw; c0 += sw; c1 -= sw
        height += sh
        hf[r0:r1, c0:c1] = height
    return hf


def discrete_obstacles(hf, hs, vs, max_height=0.25, min_size=1.0,
                       max_size=2.0, num_rects=20, platform_size=3.0,
                       rng=None):
    """Random rectangles at heights uniformly in {-max, .., +max},
    flat platform kept clear in the center."""
    rng = rng or np.random.default_rng()
    rows, cols = hf.shape
    hmax = _to_units(max_height, vs)
    heights = np.arange(-hmax, hmax + 1, max(hmax // 2, 1))
    for _ in range(num_rects):
        w = int(rng.uniform(min_size, max_size) / hs)
        l = int(rng.uniform(min_size, max_size) / hs)
        r = rng.integers(0, max(rows - l, 1))
        c = rng.integers(0, max(cols - w, 1))
        hf[r:r + l, c:c + w] = rng.choice(heights)
    half = int(platform_size / hs / 2)
    cx, cy = rows // 2, cols // 2
    hf[cx - half:cx + half, cy - half:cy + half] = 0
    return hf


def wave(hf, hs, vs, num_waves=2, amplitude=0.1):
    rows, cols = hf.shape
    amp = _to_units(amplitude, vs)
    x = np.arange(rows)[:, None] * num_waves * 2 * np.pi / rows
    y = np.arange(cols)[None, :] * num_waves * 2 * np.pi / cols
    hf += (amp * (np.sin(x) + np.cos(y))).astype(np.int16)
    return hf


def stepping_stones(hf, hs, vs, stone_size=1.0, stone_distance=0.1,
                    max_height=0.0, platform_size=4.0, depth=-10.0,
                    rng=None):
    """Grid of square stones separated by deep trenches."""
    rng = rng or np.random.default_rng()
    rows, cols = hf.shape
    ss = max(int(stone_size / hs), 1)
    sd = max(int(stone_distance / hs), 1)
    hmax = _to_units(max_height, vs)
    hf[:] = _to_units(depth, vs)
    r = 0
    while r < rows:
        c = int(rng.integers(0, ss + sd)) - (ss + sd)
        while c < cols:
            h = int(rng.integers(-hmax, hmax + 1)) if hmax > 0 else 0
            hf[max(r, 0):r + ss, max(c, 0):c + ss] = h
            c += ss + sd
        r += ss + sd
    half = int(platform_size / hs / 2)
    cx, cy = rows // 2, cols // 2
    hf[cx - half:cx + half, cy - half:cy + half] = 0
    return hf


def gap(hf, hs, vs, gap_size=1.0, platform_size=3.0):
    """Deep square moat around a central platform
    (reference terrain.py:166-178)."""
    rows, cols = hf.shape
    gs = int(gap_size / hs)
    ps = int(platform_size / hs)
    cx, cy = rows // 2, cols // 2
    x1 = (rows - ps) // 2
    x2 = x1 + gs
    y1 = (cols - ps) // 2
    y2 = y1 + gs
    hf[cx - x2:cx + x2, cy - y2:cy + y2] = -1000
    hf[cx - x1:cx + x1, cy - y1:cy + y1] = 0
    return hf


def pit(hf, hs, vs, depth=1.0, platform_size=4.0):
    """Central platform sunk ``depth`` meters (reference terrain.py:180-187)."""
    rows, cols = hf.shape
    d = _to_units(depth, vs)
    half = int(platform_size / hs / 2)
    x1, x2 = rows // 2 - half, rows // 2 + half
    y1, y2 = cols // 2 - half, cols // 2 + half
    hf[x1:x2, y1:y2] = -d
    return hf
