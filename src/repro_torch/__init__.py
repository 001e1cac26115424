"""PyTorch/CUDA port of the ESPIM serving system (``src/repro`` is the JAX
reference).  Same layout as the reference package: ``configs``, ``core``
(offline pack pipeline + sparse decode runtime), ``quant``, ``kernels``
(hand-written CUDA kernels for Hopper + their plain PyTorch versions),
``models``, ``serve`` and ``telemetry``.  Imports torch and numpy, never
jax, and nothing of the reference package."""
