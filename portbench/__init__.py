"""portbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see
``harness.py`` for how a cell's files are found.
"""
