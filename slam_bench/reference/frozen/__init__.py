"""A frozen copy of the plain PyTorch path of `maveric_slam_tpu_torch`, the
benchmark's reference.

The modules are the port's own plain versions, copied with their relative
layout so that their imports resolve inside this package. The kernel
wrappers under `ops/kernels/` keep only their plain versions, on every
device, so nothing here launches a hand-written kernel, and nothing imports
the port. Later changes to the port do not reach this copy.
"""

import torch

# f32 products stay true f32, as the configuration states.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
