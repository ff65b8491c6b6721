"""PPO on the port's envs: networks, normalizer, learner, checkpoints,
evaluation, export and the CLIs (port of ``gym_puzzles_tpu/train/``, flat
observations)."""
