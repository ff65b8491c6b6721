"""Rendering: the on-device rasterizer behind pixel observations
(:mod:`gym_puzzles_tpu_torch.render.device`) and its palette."""
