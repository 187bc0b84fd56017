from .linear import (QuantizedLinear, quantize_weights_mx, quartet_linear,
                     quartet_linear_reference_flow)

__all__ = ["QuantizedLinear", "quartet_linear", "quantize_weights_mx",
           "quartet_linear_reference_flow", "QuartetDense",
           "swap_dense_kernels"]


def __getattr__(name):
    # the Flax layers import flax, which the main path does not need
    if name in ("QuartetDense", "swap_dense_kernels"):
        from . import flax_layers
        return getattr(flax_layers, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
