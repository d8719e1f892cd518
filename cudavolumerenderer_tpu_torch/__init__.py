"""cudavolumerenderer_tpu_torch — the PyTorch/CUDA port of cudavolumerenderer_tpu.

Same module layout and function names as the JAX package, which stays in
the repository as the reference every function here is tested against.
Plain tensor code is PyTorch; each Pallas kernel of a ported render path
is a hand-written CUDA kernel for Hopper, built with nvcc at first use:
fastSK's persistent tail kernel (ops/tailpk.py, csrc/tailpk.cu) and
brickSK's tracking kernel (ops/tracking.py, csrc/tracking.cu).

This package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"
