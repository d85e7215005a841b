"""Decoders of the port: dense GQA (SwiGLU, GELU, squared ReLU, qk_norm),
MoE (granite-moe) and Mamba-2 SSD, in training and serving."""
