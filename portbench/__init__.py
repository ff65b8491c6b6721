"""The benchmark of the PyTorch and CUDA port (``gym_puzzles_tpu_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON line.
"""
