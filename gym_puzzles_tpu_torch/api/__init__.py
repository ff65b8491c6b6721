"""Public env API: ``make`` and the batched ``VectorEnv``."""
