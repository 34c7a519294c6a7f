from .spec import LayerSpec, SubModelSpec, ModelSpec, parse_model_config
from .network import (init_model, apply_model, fold_batch_norm, head_grid_sizes,
                      param_count)

__all__ = [
    "LayerSpec",
    "SubModelSpec",
    "ModelSpec",
    "parse_model_config",
    "init_model",
    "apply_model",
    "fold_batch_norm",
    "head_grid_sizes",
    "param_count",
]
