# Hand-written CUDA kernels of the port (csrc/), their ctypes wrappers
# (gp.py, flash_attention.py, rglru_scan.py, int8_quant.py, adamw.py), the
# plain PyTorch oracles beside them (ref.py) and the dispatch layer the
# numerics call (ops.py).  Nothing here builds or loads a kernel at import
# time: the first CUDA call does.
