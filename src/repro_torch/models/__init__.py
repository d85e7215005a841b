"""Decoders of the port: dense GQA + SwiGLU (yi-6b) and Mamba-2 SSD
(mamba2-1.3b)."""
