from .struct import replace, struct

__all__ = ["replace", "struct"]
