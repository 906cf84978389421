"""Device milliseconds a step in kernels that are not the port's own
(cuBLAS, PyTorch's elementwise kernels and reductions): the composed
path of the model's propagate and reweight, and what surrounds the
kernels."""


def read(ctx):
    g = ctx["groups"].get("composed")
    return g["seconds"] * 1e3 / ctx["steps"] if g else None
