from .tiling import TiledLinear, memory_efficient_linear

__all__ = ["TiledLinear", "memory_efficient_linear"]
