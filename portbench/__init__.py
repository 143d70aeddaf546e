"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
is one configuration under one traffic mix, named in ``BENCHMARK.json``
at the root of the repository; ``portbench/run.py`` runs one cell once."""
