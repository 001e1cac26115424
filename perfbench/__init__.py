"""The serving benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything a cell needs is found by name: its
configuration under ``configs/`` (which names its family's reference
under ``reference/`` and its value code under ``reference/codes/``), its
traffic mix under ``traffic/`` (which names its loop under
``traffic/loops/`` and its length distributions under
``traffic/lengths/``), its correctness limit and control under ``cells/``
and each metric's reader under ``metrics/``.  ``reference/`` is plain
PyTorch; nothing here imports JAX or the JAX package.
"""
