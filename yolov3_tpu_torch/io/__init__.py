from .checkpoint import load_checkpoint, save_checkpoint
from .resolve import load_weights, save_weights

__all__ = ["load_checkpoint", "save_checkpoint", "load_weights", "save_weights"]
