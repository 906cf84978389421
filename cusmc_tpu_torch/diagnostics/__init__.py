"""diagnostics of the PyTorch port (see the matching cusmc_tpu.diagnostics)."""
