"""The benchmark of the PyTorch / CUDA port (``src/repro_torch``).

``python3 -m chipbench.run`` runs one cell of ``BENCHMARK.json`` once;
``README.md`` beside this file says how it is laid out and extended.
"""
