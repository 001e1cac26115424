"""Plain PyTorch reference of the served model (no kernels, no cache, no
batching): one module a model family (``<family>.py``), the blocks they
share (``common.py``), a frozen copy of the offline pack arithmetic the
ESPIM deployments need (``espim_pack.py``) and one module a value code
(``codes/<quant>.py``).  Imports neither JAX, the JAX package nor the
port."""
