"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell a run.

    python3 fsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names the cells; each cell's configuration,
traffic mix, limits and per-layer metrics are files of their own under this
folder, found by name (``spec.py``).
"""
