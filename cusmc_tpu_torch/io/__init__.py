"""IO of the PyTorch port (see ``cusmc_tpu.io``)."""

from cusmc_tpu_torch.io.data import (
    demo_model_params,
    generate_y_sim,
    load_csv,
    load_y_sim,
    write_output,
    write_sim_output,
)

__all__ = [
    "demo_model_params",
    "generate_y_sim",
    "load_csv",
    "load_y_sim",
    "write_output",
    "write_sim_output",
]
