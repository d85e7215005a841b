"""Hand-written Hopper kernels of the port, their plain versions and wrappers.

``csrc/*.cu`` (CUDA C++, built by ``_build``) and ``rmsnorm.py`` (Triton) are
the kernels; ``ref.py`` holds the plain PyTorch version of each; ``ops.py``
dispatches by tensor device and keeps the launch counts.
"""
