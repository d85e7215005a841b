"""PyTorch/CUDA port of the elastic training job, its live operator, the
policy simulator, the cloud layer and the trace workloads, beside the JAX
package.

The port imports ``torch``, numpy and the standard library only; it never
imports ``jax``, ``ml_dtypes`` or any module of ``repro``.  Framework-free code
it needs is copied in.  Module names mirror ``src/repro/`` so each
counterpart is easy to find.

float32 matrix products and convolutions run in full float32: TF32 is turned
off here, at package import, because the port is held to the JAX reference at
float32 tolerances (TF32 keeps about three decimal digits).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
