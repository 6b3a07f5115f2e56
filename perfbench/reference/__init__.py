"""The plain reference that decides ``correct``: NumPy and PyTorch only,
importing nothing of the program (``repro_torch``) or the JAX package."""
