"""The benchmark of the PyTorch and CUDA port: ``run.py`` runs one cell; see ``BENCHMARK.json`` and ``PERF.md``."""
