"""The benchmark of the PyTorch port of Demeter (``repro_torch``).

``perfbench/run.py`` runs one cell once; ``BENCHMARK.json`` at the root
of the repository lists the cells and metrics.  See ``perfbench/paths.py``
for where each piece lives.
"""
