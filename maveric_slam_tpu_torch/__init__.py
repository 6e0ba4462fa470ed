"""maveric_slam_tpu_torch — the SLAM engine on PyTorch and CUDA (NVIDIA Hopper).

A port of `maveric_slam_tpu` (JAX/XLA/Pallas), which stays the reference.
Plain tensor code is PyTorch; every Pallas kernel on the ported path is a
CUDA C++ kernel for sm_90a under `csrc/`, built at first use (see
`ops/kernels/_build.py`) and held against a plain PyTorch version of the
same function that sits beside its wrapper.

Entry points take `device=None`, meaning CUDA; they raise when CUDA is
absent. Pass `device="cpu"` to run the plain versions on the CPU.
"""

import torch

__version__ = "0.1.0"

# The geometry (8-point normal matrices, svd3, PnP) and the f32-carried int8
# SuperPoint convolutions need true f32 products: TF32 keeps ~10 mantissa
# bits, which breaks the int8 net's integer exactness and costs the geometry
# up to the errors the JAX package measured with bf16 passes. cuDNN's conv
# TF32 is on by default, so both switches are set.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
