"""Dense GQA + SwiGLU decoder of the port (yi-6b family)."""
