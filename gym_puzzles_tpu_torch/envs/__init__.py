"""Batched env logic in PyTorch (port of ``gym_puzzles_tpu.envs``)."""
