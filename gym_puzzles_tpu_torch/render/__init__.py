"""Rendering: the on-device rasterizer behind pixel observations
(:mod:`gym_puzzles_tpu_torch.render.device`), the host-side rasterizer of
one env's frame (:mod:`gym_puzzles_tpu_torch.render.raster`, on the C++
core of ``csrc/_raster.cpp``), the live viewer
(:mod:`gym_puzzles_tpu_torch.render.window`) and the palette."""
