"""Batched 2D rigid body engine in PyTorch: the port of
``gym_puzzles_tpu.engine``.  ``world.step`` is the plain version; the fused
CUDA tick kernel is ``step_cuda.step_fused``, and the staged tick
``world.step_batched`` runs the CUDA contact-solve kernel
``solver_cuda.solve_contacts``."""
