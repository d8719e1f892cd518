"""Sharded rendering over a torch.distributed process group (port of
cudavolumerenderer_tpu/parallel/)."""
