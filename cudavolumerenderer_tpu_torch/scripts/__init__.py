"""Entry points of the port run as modules
(`python -m cudavolumerenderer_tpu_torch.scripts.<name>`)."""
