"""The plain reference that decides ``correct``: frozen copies, in plain
PyTorch and float32, of the port's plain tick (``world``, ``solver``,
``narrowphase``), v0 env logic (``base``, ``common``, ``v0``), renderer
(``render``) and PPO learner (``learner``).

Nothing here imports the port or the JAX package, and nothing takes what the
port made: the benchmark hands both sides the same inputs.  Matmuls and
convolutions run with TF32 off (``learner.plain_precision``).
"""
