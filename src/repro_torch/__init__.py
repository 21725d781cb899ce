"""repro_torch: the PageRank-fabric system ported to PyTorch and CUDA for
one NVIDIA H100.  The JAX package ``repro`` is the reference it is held
against; this package imports nothing of it, and nothing of JAX."""
__version__ = "0.1.0"
