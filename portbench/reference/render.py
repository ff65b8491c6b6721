"""Rasterizer in plain PyTorch ops: a frozen copy of the port's
``render/device.py`` and its palette.

The reference renders with pyglet/OpenGL and reads the pixels back to the
host (``_get_image``, multi_robot_puzzle_00.py:594-601).  Here a frame is
computed from the batched env state in PyTorch ops on the state's device, so
pixel observations feed a CNN policy with no host round trip.

Rasterization is per-pixel coverage tests over the whole env batch at once:
convex polygon fills are products of half-plane tests (unrolled over the
fixtures and their edges), discs and rings are radius tests, heading lines
distance-to-segment tests.  Geometry, colours and the sampling convention
(pixel centres at ``k*d + 0.5``, the y flip, slice-style downsampling) are
the JAX renderer's, computed in float32 in the same order, and later paints
win.  The one difference allowed is float contraction: XLA on the CPU may
fuse ``a*b - c*d`` into an FMA where eager PyTorch does not, so a pixel on a
shape's edge can differ from the JAX frame.

Each paint is a handful of small elementwise kernels over ``[E, h, w]``
(v0 paints about 52 masks per frame): a few hundred kernel launches per
frame, none of them a hand-written kernel -- the JAX renderer is plain
``jnp`` too.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.types import device_const
from portbench.reference import config as C

# the reference's colours: black background, grey block, white agents, blue
# goal disc, dark-grey walls
GREY = (127, 127, 127)
WHITE = (255, 255, 255)
LT_GREY = (51, 51, 51)
BLUE = (58, 153, 255)


def _variant_geometry(cfg):
    if cfg.variant == "v2":
        return C.V2_VIEWPORT_W, C.V2_VIEWPORT_H, C.V2_SCALE
    if cfg.variant == "v3":
        return C.V3_SCREEN_W, C.V3_SCREEN_H, C.V3_SCALE
    return C.V0_VIEWPORT_W, C.V0_VIEWPORT_H, C.V0_SCALE


def _col(x):
    """[E] -> [E, 1, 1], to broadcast against the pixel grid."""
    return x[:, None, None]


def make_device_renderer(logic, downsample: int = 4, mode: str = "human_vision"):
    """Build ``render(env_state) -> [E, h, w, 3] uint8`` for a batched
    ``EnvState`` (env axis last); the frame lies on the state's device.

    ``downsample=d`` samples every d-th full-resolution pixel (the host
    pipeline's ``img[::d, ::d]`` slicing).  ``mode='agent_vision'`` (v2's
    agent view) skips the fixture fills and draws the agents' centres white
    with heading lines.  ``render.height`` / ``render.width`` give the frame
    size."""
    cfg = logic.cfg
    lay = logic.layout
    table = lay.table
    W, H, ppm = _variant_geometry(cfg)
    d = downsample
    h, w = (H + d - 1) // d, (W + d - 1) // d

    # full-res pixel-centre coordinates of the sampled grid; the tests run in
    # y-down pixel space, the y flip happens at each test site
    gx_np = (np.arange(w) * d + 0.5).astype(np.float32)
    gy_np = (np.arange(h) * d + 0.5).astype(np.float32)

    fix_body = [int(b) for b in table.fix_body]
    fix_verts = [np.asarray(table.fix_verts[f, : int(table.fix_count[f])], np.float32)
                 for f in range(table.num_fixtures)]
    local_center = np.asarray(table.local_center, np.float32)
    agent_slots = [int(s) for s in lay.agent_slots]
    block_slot = int(lay.block_slot)
    block_verts = np.asarray(lay.block_verts, np.float32)

    def fixture_color(b):
        if b in agent_slots:
            return WHITE
        if b == block_slot:
            return GREY
        return LT_GREY

    center_r = max(3.0, 0.05 * ppm)
    vert_r = max(2.0, 0.02 * ppm)

    def render(env_state):
        pos = env_state.bodies.pos  # [B, 2, E] world metres
        ang = env_state.bodies.angle  # [B, E]
        dev = ang.device
        E = ang.shape[-1]
        gx = device_const(gx_np, dev).view(1, 1, w)
        gy = device_const(gy_np, dev).view(1, h, 1)
        colors = {c: device_const(np.array(c, np.uint8), dev)
                  for c in (BLUE, GREY, LT_GREY, WHITE)}

        def paint(img, mask, color):
            return torch.where(mask[..., None], colors[color], img)

        def disc_mask(cx_px, cy_px_yup, r):
            """Filled disc at a y-up pixel centre ([E] each)."""
            dx = gx - _col(cx_px)
            dy = gy - _col(H - cy_px_yup)
            return dx * dx + dy * dy <= r * r

        def ring_mask(cx_px, cy_px_yup, r, thickness):
            dx = gx - _col(cx_px)
            dy = gy - _col(H - cy_px_yup)
            d2 = dx * dx + dy * dy
            return (d2 <= (r + thickness) ** 2) & (d2 >= (r - thickness) ** 2)

        def segment_mask(ax, ay_yup, bx, by_yup, thickness):
            ay, by = H - ay_yup, H - by_yup
            abx, aby = bx - ax, by - ay
            denom = _col(abx * abx + aby * aby + 1e-12)
            ax, ay, abx, aby = _col(ax), _col(ay), _col(abx), _col(aby)
            t = torch.clamp(((gx - ax) * abx + (gy - ay) * aby) / denom, 0.0, 1.0)
            dx = gx - (ax + t * abx)
            dy = gy - (ay + t * aby)
            return dx * dx + dy * dy <= thickness * thickness

        def poly_mask(px, py):
            """Convex fill: pixel centre left of every edge.  ``px``/``py``
            [N, E] in y-down pixel space, in the reversed winding the caller
            applies."""
            m = torch.ones((E, h, w), dtype=torch.bool, device=dev)
            n = px.shape[0]
            for i in range(n):
                j = (i + 1) % n
                ax, ay, bx, by = _col(px[i]), _col(py[i]), _col(px[j]), _col(py[j])
                m &= (bx - ax) * (gy - ay) - (by - ay) * (gx - ax) >= 0
            return m

        cth, sth = torch.cos(ang), torch.sin(ang)
        lc = device_const(local_center, dev)[..., None]  # [B, 2, 1]
        org_x = pos[:, 0] - (cth * lc[:, 0] - sth * lc[:, 1])
        org_y = pos[:, 1] - (sth * lc[:, 0] + cth * lc[:, 1])

        img = torch.zeros((E, h, w, 3), dtype=torch.uint8, device=dev)
        goal = env_state.goal_pos  # [3, E] in variant units

        # goal marker (variant units -> px)
        if cfg.variant == "v0":
            img = paint(img, disc_mask(goal[0], goal[1], C.V0_EPSILON), BLUE)
        elif cfg.variant == "v3":
            gx_px = goal[0] * (W / 2) + W / 2
            gy_px = goal[1] * (W / 2) + H / 2
            img = paint(img, disc_mask(gx_px, gy_px, C.V3_EPSILON), BLUE)
        else:  # v2: white dot + margin ring; the goal is stored normalized
            gx_px = goal[0] / C.V2_RATIO * ppm
            gy_px = goal[1] / C.V2_RATIO * ppm
            eps_px = 0.1 / C.V2_RATIO * ppm
            img = paint(img, disc_mask(gx_px, gy_px, 6.0), WHITE)
            img = paint(img, ring_mask(gx_px, gy_px, eps_px, 3.0), LT_GREY)

        # fixture fills (human vision only)
        if mode != "agent_vision":
            for f, verts in enumerate(fix_verts):
                b = fix_body[f]
                v = device_const(verts, dev)[..., None]  # [N, 2, 1]
                wx = org_x[b] + cth[b] * v[:, 0] - sth[b] * v[:, 1]
                wy = org_y[b] + sth[b] * v[:, 0] + cth[b] * v[:, 1]
                px, py = wx * ppm, H - wy * ppm
                img = paint(img, poly_mask(px.flip(0), py.flip(0)), fixture_color(b))

        # centres + heading lines
        for a in agent_slots:
            m = disc_mask(pos[a, 0] * ppm, pos[a, 1] * ppm, center_r)
            img = paint(img, m, GREY if mode != "agent_vision" else WHITE)
            if mode == "agent_vision":
                tip_x = pos[a, 0] - 0.35 * sth[a]
                tip_y = pos[a, 1] + 0.35 * cth[a]
                img = paint(img, segment_mask(pos[a, 0] * ppm, pos[a, 1] * ppm,
                                              tip_x * ppm, tip_y * ppm, 1.5), WHITE)
        b = block_slot
        img = paint(img, disc_mask(pos[b, 0] * ppm, pos[b, 1] * ppm, center_r), WHITE)

        # block vertex dots
        v = device_const(block_verts, dev)[..., None]  # [8, 2, 1]
        wx = org_x[b] + cth[b] * v[:, 0] - sth[b] * v[:, 1]
        wy = org_y[b] + sth[b] * v[:, 0] + cth[b] * v[:, 1]
        for k in range(block_verts.shape[0]):
            img = paint(img, disc_mask(wx[k] * ppm, wy[k] * ppm, vert_r), WHITE)
        return img

    render.height = h
    render.width = w
    return render
