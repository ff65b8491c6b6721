"""Host-side renderer (port of ``gym_puzzles_tpu/render/raster.py``): rgb_array
frames of one env's state, for ``render(mode='rgb_array')``, the live viewer,
video recording and the single-env image observations.

It replaces the reference's pyglet/OpenGL rendering (multi_robot_puzzle_00.py:
528-601, 02.py:590-707, core.py:421-459) with a GL-free rasterizer: black
background, dark-grey walls, grey block with white centre and vertex dots,
white agents, blue goal disc (v0 / v3) or white goal dot and grey margin
ring (v2); v2's ``agent_vision`` mode draws only points and heading lines
(02.py:665-707).

The state's tensors are copied to the host as they are (float32), and the
geometry is the JAX package's numpy arithmetic on them, so the frames equal
the JAX package's pixel for pixel.  Polygons and discs are filled by the C++
core (``csrc/_raster.cpp`` through :mod:`._raster_cpp`, built at first
use); the numpy :func:`_fill_polygon` / :func:`_fill_circle` are its plain
version.  Heading lines are drawn in numpy (:func:`_draw_line`), as in the
JAX package.
"""

from __future__ import annotations

import numpy as np

from gym_puzzles_tpu_torch.envs import config as C
from gym_puzzles_tpu_torch.render import _raster_cpp as cpp
from gym_puzzles_tpu_torch.render.palette import BLUE, GREY, LT_GREY, WHITE


def _fill_polygon(img, verts_px, color):
    """Fill a convex polygon given float pixel vertices [N,2] (y-up)."""
    h, w, _ = img.shape
    v = np.asarray(verts_px, np.float64)
    x0 = max(int(np.floor(v[:, 0].min())), 0)
    x1 = min(int(np.ceil(v[:, 0].max())) + 1, w)
    y0 = max(int(np.floor(v[:, 1].min())), 0)
    y1 = min(int(np.ceil(v[:, 1].max())) + 1, h)
    if x0 >= x1 or y0 >= y1:
        return
    xs = np.arange(x0, x1) + 0.5
    ys = np.arange(y0, y1) + 0.5
    gx, gy = np.meshgrid(xs, ys)
    inside = np.ones(gx.shape, bool)
    n = len(v)
    for i in range(n):
        a = v[i]
        b = v[(i + 1) % n]
        # CCW polygon: inside = left of every edge
        inside &= (b[0] - a[0]) * (gy - a[1]) - (b[1] - a[1]) * (gx - a[0]) >= 0
    img[y0:y1, x0:x1][inside] = color


def _fill_circle(img, cx, cy, r, color, filled=True, thickness=2.0):
    h, w, _ = img.shape
    x0 = max(int(cx - r - thickness), 0)
    x1 = min(int(cx + r + thickness) + 1, w)
    y0 = max(int(cy - r - thickness), 0)
    y1 = min(int(cy + r + thickness) + 1, h)
    if x0 >= x1 or y0 >= y1:
        return
    xs = np.arange(x0, x1) + 0.5
    ys = np.arange(y0, y1) + 0.5
    gx, gy = np.meshgrid(xs, ys)
    d2 = (gx - cx) ** 2 + (gy - cy) ** 2
    if filled:
        mask = d2 <= r * r
    else:
        mask = (d2 <= (r + thickness) ** 2) & (d2 >= (r - thickness) ** 2)
    img[y0:y1, x0:x1][mask] = color


def _draw_line(img, a, b, color, thickness=1.5):
    """Thick line via distance-to-segment test over the bounding box."""
    h, w, _ = img.shape
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    lo = np.maximum(np.floor(np.minimum(a, b) - thickness), 0).astype(int)
    hi = np.minimum(np.ceil(np.maximum(a, b) + thickness) + 1,
                    [w, h]).astype(int)
    if (hi <= lo).any():
        return
    xs = np.arange(lo[0], hi[0]) + 0.5
    ys = np.arange(lo[1], hi[1]) + 0.5
    gx, gy = np.meshgrid(xs, ys)
    ab = b - a
    denom = ab @ ab + 1e-12
    t = np.clip(((gx - a[0]) * ab[0] + (gy - a[1]) * ab[1]) / denom, 0.0, 1.0)
    dx = gx - (a[0] + t * ab[0])
    dy = gy - (a[1] + t * ab[1])
    mask = dx * dx + dy * dy <= thickness * thickness
    img[lo[1]:hi[1], lo[0]:hi[0]][mask] = color


def _polygon(img, verts_px, color):
    cpp.fill_polygon(img, np.asarray(verts_px, np.float32), color)


def _circle(img, cx, cy, r, color, filled=True, thickness=2.0):
    cpp.fill_circle(img, float(cx), float(cy), float(r), color, bool(filled), float(thickness))


def _body_polys_px(table, pos, ang, ppm, height_px):
    """World-space fixture polygons -> pixel coords (y flipped for images)."""
    c, s = np.cos(ang), np.sin(ang)
    # body origins
    lc = table.local_center
    org_x = pos[:, 0] - (c * lc[:, 0] - s * lc[:, 1])
    org_y = pos[:, 1] - (s * lc[:, 0] + c * lc[:, 1])
    polys = []
    for f in range(table.num_fixtures):
        b = int(table.fix_body[f])
        n = int(table.fix_count[f])
        v = table.fix_verts[f, :n]
        wx = org_x[b] + c[b] * v[:, 0] - s[b] * v[:, 1]
        wy = org_y[b] + s[b] * v[:, 0] + c[b] * v[:, 1]
        px = np.stack([wx * ppm, height_px - wy * ppm], axis=1)
        polys.append((b, px))
    return polys


def _render(logic, pos, angle, goal, mode):
    """One frame from host copies of one env's body positions [B, 2], angles
    [B] and goal [3] (float32)."""
    cfg = logic.cfg
    if cfg.variant == "v2":
        W, H = C.V2_VIEWPORT_W, C.V2_VIEWPORT_H
        ppm = C.V2_SCALE
    elif cfg.variant == "v3":
        W, H = C.V3_SCREEN_W, C.V3_SCREEN_H
        ppm = C.V3_SCALE
    else:
        W, H = C.V0_VIEWPORT_W, C.V0_VIEWPORT_H
        ppm = C.V0_SCALE

    img = np.zeros((H, W, 3), np.uint8)
    lay = logic.layout

    # goal marker
    if cfg.variant == "v0":
        _circle(img, goal[0], H - goal[1], C.V0_EPSILON, BLUE)
    elif cfg.variant == "v3":
        gx = goal[0] * (W / 2) + W / 2
        gy = goal[1] * (W / 2) + H / 2
        _circle(img, gx, H - gy, C.V3_EPSILON, BLUE)
    else:  # v2: white dot + margin ring, goal stored normalized (x RATIO)
        gx = goal[0] / C.V2_RATIO * ppm
        gy = goal[1] / C.V2_RATIO * ppm
        eps_px = 0.1 / C.V2_RATIO * ppm
        _circle(img, gx, H - gy, 6, WHITE)
        _circle(img, gx, H - gy, eps_px, LT_GREY, filled=False, thickness=3)

    polys = _body_polys_px(lay.table, pos, angle, ppm, H)
    agent_set = set(int(s) for s in lay.agent_slots)
    if mode != "agent_vision":
        for b, px in polys:
            if b in agent_set:
                color = WHITE
            elif b == lay.block_slot:
                color = GREY
            else:
                color = LT_GREY
            # pixel coords are y-flipped -> reverse winding for the fill test
            _polygon(img, px[::-1], color)

    # centers + block vertices (small white dots), heading lines in agent mode
    for a in lay.agent_slots:
        _circle(img, pos[a, 0] * ppm, H - pos[a, 1] * ppm,
                max(3.0, 0.05 * ppm), GREY if mode != "agent_vision" else WHITE)
        if mode == "agent_vision":
            ang = float(angle[a])
            tip = pos[a] + 0.35 * np.array([-np.sin(ang), np.cos(ang)])
            _draw_line(img, (pos[a, 0] * ppm, H - pos[a, 1] * ppm),
                       (tip[0] * ppm, H - tip[1] * ppm), WHITE)
    b = lay.block_slot
    _circle(img, pos[b, 0] * ppm, H - pos[b, 1] * ppm, max(3.0, 0.05 * ppm), WHITE)

    # block vertices
    ang = float(angle[b])
    c, s = np.cos(ang), np.sin(ang)
    lc = lay.table.local_center[b]
    ox = pos[b, 0] - (c * lc[0] - s * lc[1])
    oy = pos[b, 1] - (s * lc[0] + c * lc[1])
    for v in lay.block_verts:
        wx = ox + c * v[0] - s * v[1]
        wy = oy + s * v[0] + c * v[1]
        _circle(img, wx * ppm, H - wy * ppm, max(2.0, 0.02 * ppm), WHITE)
    return img


def _host(x) -> np.ndarray:
    """A state tensor as a numpy array on the host, its dtype kept."""
    return x.detach().cpu().numpy()


def render_state(logic, env_state, mode: str = "human_vision") -> np.ndarray:
    """Render one env's state to an (H, W, 3) uint8 frame.

    ``logic``: the PuzzleEnvLogic; ``env_state``: one env's EnvState (its
    tensors without the env axis, on any device).  ``mode``:
    'human_vision' | 'agent_vision' (v2's two styles).
    """
    bodies = env_state.bodies
    return _render(logic, _host(bodies.pos), _host(bodies.angle), _host(env_state.goal_pos),
                   mode)


def render_batch(logic, batched_state, indices=None, mode: str = "human_vision") -> np.ndarray:
    """Render several envs of a batched EnvState (env axis last, as the
    port's ``VectorEnv`` keeps it) -> [N, H, W, 3]; ``indices`` default to
    every env.  The state is copied to the host once."""
    bodies = batched_state.bodies
    pos, angle, goal = (_host(x) for x in (bodies.pos, bodies.angle, batched_state.goal_pos))
    indices = range(angle.shape[-1]) if indices is None else indices
    return np.stack([_render(logic, pos[..., i], angle[..., i], goal[..., i], mode)
                     for i in indices])
