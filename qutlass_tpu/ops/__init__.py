from . import emulation, int8path

__all__ = ["emulation", "int8path"]
