from . import rng, warps

__all__ = ["rng", "warps"]
