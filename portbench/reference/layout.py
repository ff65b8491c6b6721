"""World layout builder: per-variant ShapeTable + body-slot conventions.

The port's own copy of ``gym_puzzles_tpu/envs/layout.py`` (numpy only); all
three builders are kept so every variant's table can be checked.

Body slot order (fixed for every variant): walls 0..3 (left, right, bottom,
top, matching the reference's border loop order 00.py:260-275), block 4,
agents 5..4+A.  The layout also precomputes the static masks the env logic
needs: which contact pairs connect agent i to the block / to a wall, and the
deduplicated block vertex list that feeds the observation
(00.py:356-361,470-472).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference import config as C
from portbench.reference import shapes as shp
from portbench.reference.types import BodySpec, FixtureSpec, ShapeTable, build_shape_table

WALL_SLOTS = (0, 1, 2, 3)
BLOCK_SLOT = 4
FIRST_AGENT_SLOT = 5


@dataclasses.dataclass(frozen=True, eq=False)
class WorldLayout:
    """Static world description consumed by the env logic."""

    table: ShapeTable
    num_agents: int
    block_slot: int
    agent_slots: np.ndarray  # [A] int
    agent_block_pairs: np.ndarray  # [A, P] bool: pairs linking agent i <-> block
    agent_wall_pairs: np.ndarray  # [A, P] bool
    block_verts: np.ndarray  # [8, 2] dedup'd T-block vertices, obs order
    world_w: float  # world width in meters (VIEWPORT_W / SCALE)
    world_h: float


def _wall_specs(world_w: float, world_h: float, thickness: float):
    """Four static walls (00.py:260-275 pattern: two verticals then two
    horizontals, positioned at the screen edges' midpoints)."""
    borders = [(0.0, 0.5), (1.0, 0.5), (0.5, 0.0), (0.5, 1.0)]
    specs = []
    positions = []
    for i, (bx, by) in enumerate(borders):
        if i < 2:
            half = (thickness, world_h)
        else:
            half = (world_w, thickness)
        specs.append(
            BodySpec(
                fixtures=[FixtureSpec(vertices=shp.box_vertices(*half), density=0.0,
                                      friction=C.DEFAULT_FRICTION)],
                static=True,
                name=f"wall_{i}",
            )
        )
        positions.append((world_w * bx, world_h * by))
    return specs, positions


def _merge_fixture_verts(fixtures):
    """Reference vertex dedup: iterate fixtures in creation order, append
    vertices not already seen (blocks.py:107-109, 00.py:356-361)."""
    merged = []
    for f in fixtures:
        merged += [tuple(v) for v in f if tuple(v) not in merged]
    return np.array(merged)


def _t_block_vertices(scale: float):
    """The two T-block box fixtures at Box2D vertex order + the dedup'd
    8-vertex obs list.  ``scale`` is the box half-extent unit: v0 light /
    v3 light use 0.5, heavy 1.0 (00.py:303-332, blocks.py:80-90)."""
    f1 = shp.box_vertices(1.0 * scale, 1.0 * scale, (0.0, -1.0 * scale))
    f2 = shp.box_vertices(3.0 * scale, 1.0 * scale, (0.0, 1.0 * scale))
    return [f1, f2], _merge_fixture_verts([f1, f2])


def _l_block_vertices(scale: float):
    """L-block: two offset boxes (blocks.py:92-103, 00.py:335-344) -> 7
    dedup'd vertices (the boxes share one corner)."""
    f1 = shp.box_vertices(1.0 * scale, 1.0 * scale, (1.0 * scale, 0.5 * scale))
    f2 = shp.box_vertices(1.0 * scale, 2.0 * scale, (-1.0 * scale, -0.5 * scale))
    return [f1, f2], _merge_fixture_verts([f1, f2])


def _i_block_vertices(scale: float):
    """I-block: one centered box (blocks.py:105-109, 00.py:346-351) -> 4
    vertices."""
    f1 = shp.box_vertices(1.0 * scale, 2.0 * scale)
    return [f1], _merge_fixture_verts([f1])


def block_fixture_vertices(shape: str, scale: float):
    """Per-shape fixture vertex lists + dedup'd obs vertex table.  The
    reference's ``Block`` entity supports T/L/I (blocks.py:15,80-109); v0
    carries the same three fixture recipes in its multi-block scaffolding
    (00.py:320-351)."""
    fn = {"t": _t_block_vertices, "l": _l_block_vertices, "i": _i_block_vertices}
    return fn[shape](scale)


def block_obs_vert_count(shape: str) -> int:
    """Dedup'd vertex count per shape: T=8, L=7 (shared corner), I=4."""
    return {"t": 8, "l": 7, "i": 4}[shape]


def _finish(table, cfg, block_verts, world_w, world_h) -> WorldLayout:
    A = cfg.num_agents
    agent_slots = np.arange(FIRST_AGENT_SLOT, FIRST_AGENT_SLOT + A)
    ab = np.stack([table.pairs_between(s, BLOCK_SLOT) for s in agent_slots])
    aw = np.stack(
        [
            np.logical_or.reduce([table.pairs_between(s, w) for w in WALL_SLOTS])
            for s in agent_slots
        ]
    )
    return WorldLayout(
        table=table,
        num_agents=A,
        block_slot=BLOCK_SLOT,
        agent_slots=agent_slots,
        agent_block_pairs=ab,
        agent_wall_pairs=aw,
        block_verts=block_verts,
        world_w=world_w,
        world_h=world_h,
    )


def build_v0(cfg: C.EnvConfig) -> tuple[WorldLayout, np.ndarray]:
    """v0 world (00.py:260-376).  Returns (layout, wall_positions [4,2])."""
    world_w = C.V0_VIEWPORT_W / C.V0_SCALE
    world_h = C.V0_VIEWPORT_H / C.V0_SCALE
    walls, wall_pos = _wall_specs(world_w, world_h, 1.0)

    blk_scale = 1.0 if cfg.heavy else 0.5  # scaled = S/2 or S with S=2 -> half-extent unit
    blk_dense = C.V0_DENSE * (2.0 if cfg.heavy else 1.0)
    fixtures, obs_verts = block_fixture_vertices(cfg.block_shape, blk_scale)
    block = BodySpec(
        fixtures=[FixtureSpec(vertices=f, density=blk_dense, friction=C.V0_FR)
                  for f in fixtures],
        linear_damping=C.V0_DAMP,
        angular_damping=C.V0_DAMP,
        name=f"{cfg.block_shape}_block",
    )
    # v0 agents: fixtureDef without density/friction (00.py:368-376) ->
    # density 0 (mass fallback 1), friction 0.2.
    agents = [
        BodySpec(
            fixtures=[FixtureSpec(vertices=C.V0_AGENT_POLY, density=0.0,
                                  friction=C.DEFAULT_FRICTION, from_hull=True)],
            linear_damping=C.V0_DAMP,
            angular_damping=C.V0_DAMP,
            name=f"agent_{i}",
        )
        for i in range(cfg.num_agents)
    ]
    table = build_shape_table(walls + [block] + agents)
    return _finish(table, cfg, obs_verts, world_w, world_h), np.array(wall_pos)


def build_v2(cfg: C.EnvConfig) -> tuple[WorldLayout, np.ndarray]:
    """v2 world (02.py:313-411): car-like agents with two zero-density wheel
    fixtures, low-friction block, BOUNDS-thick walls."""
    world_w = C.V2_VIEWPORT_W / C.V2_SCALE
    world_h = C.V2_VIEWPORT_H / C.V2_SCALE
    walls, wall_pos = _wall_specs(world_w, world_h, C.V2_BOUNDS)

    blk_dense = C.V2_HEAVY_BLK_DENSE if cfg.heavy else C.V2_BLK_DENSE
    f1 = shp.box_vertices(0.1, 0.1, (0.0, -0.1))
    f2 = shp.box_vertices(0.3, 0.1, (0.0, 0.1))
    merged = [tuple(v) for v in f1]
    merged += [tuple(v) for v in f2 if tuple(v) not in merged]
    block = BodySpec(
        fixtures=[
            FixtureSpec(vertices=f1, density=blk_dense, friction=C.V2_FR),
            FixtureSpec(vertices=f2, density=blk_dense, friction=C.V2_FR),
        ],
        linear_damping=C.V2_LINEAR_DAMP,
        angular_damping=C.V2_ANG_DAMP,
        name="t_block",
    )
    wheel1 = shp.box_vertices(0.005, 0.05, (0.06, 0.0))
    wheel2 = shp.box_vertices(0.005, 0.05, (-0.06, 0.0))
    agents = [
        BodySpec(
            fixtures=[
                FixtureSpec(vertices=C.V2_AGENT_POLY, density=C.V2_AGT_DENSE,
                            friction=C.V2_FR, from_hull=True),
                FixtureSpec(vertices=wheel1, density=0.0, friction=C.V2_FR),
                FixtureSpec(vertices=wheel2, density=0.0, friction=C.V2_FR),
            ],
            linear_damping=C.V2_LINEAR_DAMP,
            angular_damping=C.V2_ANG_DAMP,
            name=f"agent_{i}",
        )
        for i in range(cfg.num_agents)
    ]
    table = build_shape_table(walls + [block] + agents)
    return _finish(table, cfg, np.array(merged), world_w, world_h), np.array(wall_pos)


def build_v3(cfg: C.EnvConfig) -> tuple[WorldLayout, np.ndarray]:
    """v3 world (core.py:186-243, robot.py:34-44, blocks.py:70-109)."""
    world_w = C.V3_SCREEN_W / C.V3_SCALE
    world_h = C.V3_SCREEN_H / C.V3_SCALE
    walls, wall_pos = _wall_specs(world_w, world_h, C.V3_BORDER)

    blk_scale = 1.0 if cfg.heavy else 0.5
    blk_dense = C.V3_DENSE * (2.0 if cfg.heavy else 1.0)
    fixtures, obs_verts = block_fixture_vertices(cfg.block_shape, blk_scale)
    block = BodySpec(
        fixtures=[FixtureSpec(vertices=f, density=blk_dense, friction=C.V3_BLOCK_FR)
                  for f in fixtures],
        linear_damping=C.V3_BLOCK_DAMP,
        angular_damping=C.V3_BLOCK_DAMP,
        name=f"block_{cfg.block_shape}",
    )
    agent_verts = C.V2_AGENT_POLY * C.V3_AGENT_SCALE  # robot.py:38
    agents = [
        BodySpec(
            fixtures=[FixtureSpec(vertices=agent_verts, density=C.V3_AGENT_DENSITY,
                                  friction=C.V3_AGENT_FR, from_hull=True)],
            # robot.py:41-42: damping commented out -> 0
            name=f"agent_{i}",
        )
        for i in range(cfg.num_agents)
    ]
    table = build_shape_table(walls + [block] + agents)
    return _finish(table, cfg, obs_verts, world_w, world_h), np.array(wall_pos)


def build(cfg: C.EnvConfig):
    return {"v0": build_v0, "v2": build_v2, "v3": build_v3}[cfg.variant](cfg)
