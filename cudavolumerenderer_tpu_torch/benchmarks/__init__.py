"""Benchmarks of the PyTorch/CUDA port, run as modules
(`python -m cudavolumerenderer_tpu_torch.benchmarks.<name>`)."""
