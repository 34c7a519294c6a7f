from .checkpoint import load_checkpoint, load_tf_keras_checkpoint, save_checkpoint
from .darknet import load_darknet_weights, save_darknet_weights
from .resolve import load_weights, save_weights

__all__ = ["load_checkpoint", "load_tf_keras_checkpoint", "save_checkpoint",
           "load_darknet_weights", "save_darknet_weights", "load_weights", "save_weights"]
