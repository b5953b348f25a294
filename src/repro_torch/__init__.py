"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The package mirrors ``repro``'s layout (configs/, core/, kernels/, models/,
serving/, launch/) module for module, so each port sits where a reader
expects its counterpart.  It imports torch, numpy and the standard library
only; every Pallas kernel of the main path is a hand-written CUDA C++
kernel under ``kernels/csrc`` with a plain-torch version beside it.

Entry points (``launch.serve.build_pair``, ``serving.engine.ServingModel``,
``serving.engine.Engine``) run on ``device="cuda"`` unless the caller asks
for the CPU, where every op takes its plain version.
"""
import torch

# float32 matrix products and convolutions stay full float32 on the card:
# TF32 keeps ~3 decimal digits, which would break parity with the float32
# reference and the stated kernel tolerances.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
