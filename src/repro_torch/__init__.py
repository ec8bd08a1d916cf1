"""PyTorch/CUDA port of the suggestion service (``repro`` is the JAX
reference).  Runs on the CUDA card unless ``device="cpu"`` is passed.

Numerics are float32 throughout, as in the reference with x64 off.  TF32
matrix products would keep about three decimal digits, so the port turns
them off explicitly (``torch.backends.cuda.matmul.allow_tf32 = False``).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
