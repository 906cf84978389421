"""smc of the PyTorch port (see the matching cusmc_tpu.smc)."""
