from . import quantize_int8

__all__ = ["quantize_int8"]
