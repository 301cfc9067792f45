"""mpc_tpu_torch: the PyTorch/CUDA port of ``mpc_tpu``.

A second package beside the JAX reference ``mpc_tpu``, with the same module
tree where that helps a reader find a counterpart. Everything here is plain
PyTorch on tensors with a leading lane axis; the one hand-written kernel (the
PANOC candidate fan, ``ops/fused_psi.py`` + ``csrc/fused_psi.cu``) runs on an
NVIDIA Hopper card.

The solver runs in float32, like the JAX package on the TPU, so matrix
products must not silently drop to TF32 on the card: both switches are set
once, here.
"""

import torch

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
