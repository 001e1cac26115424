"""Hand-written CUDA kernels for Hopper (``csrc/``), their build and
ctypes binding (``build.py``), the launch wrappers (``espim_spmv.py``,
``dense_mv.py``, ``flash_attention.py``, ``wkv.py``,
``decode_attention.py``, which keeps its plain version beside it), the
plain PyTorch versions (``ref.py``) and the dispatching ops
(``ops.py``)."""
