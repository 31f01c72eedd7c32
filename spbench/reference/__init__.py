"""The plain reference that decides ``correct``: plain NumPy and PyTorch.

It imports nothing of the port (``sparse_linear_tpu_torch``), nor JAX,
nor the JAX package, and takes nothing the port made: it works from the
triples the benchmark handed the port, and reads the port's answers only
to judge them."""
