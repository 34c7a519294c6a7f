"""Transfer learning: sub-tree weight transfer + freeze masks.

Counterpart of ``yolov3_tpu/models/transfer.py`` (reference
core/transfer_learning.py semantics):
  * transfer_list 'all' → full checkpoint load (the train app's business);
  * 'backbone' / 'neck' → load a checkpoint saved from a (possibly
    truncated) model and copy the matching sub-model weights; selecting
    'neck' implies 'backbone';
  * freeze_train_list → matching sub-models excluded from updates
    (substring match on sub-model names);
  * batch_norm_freeze_list → matching sub-models run BN in inference mode.

Transfer is a subtree copy, freezing a tree of bools the train step consumes.
"""

from __future__ import annotations

from ..tree import tree_map
from .spec import ModelSpec


def _clean(selector_list):
    return [s for s in (selector_list or []) if s and s != "none"]


def expand_transfer_list(transfer_list) -> list[str]:
    tl = _clean(transfer_list)
    if "neck" in tl:
        return ["backbone", "neck"]
    if "backbone" in tl:
        return ["backbone"]
    return tl


def transfer_weights(params, state, ref_params, ref_state, sub_model_selectors):
    """Copy sub-model subtrees whose name contains any selector substring."""
    selectors = _clean(sub_model_selectors)
    for name in params:
        if not any(s in name for s in selectors):
            continue
        if name in ref_params:
            params[name] = tree_map(lambda x: x, ref_params[name])
        if name in ref_state:
            state[name] = tree_map(lambda x: x, ref_state[name])
    return params, state


def trainable_mask(params, freeze_train_list):
    """Tree of bools: False for params in frozen sub-models."""
    selectors = _clean(freeze_train_list)
    if not selectors:
        return None
    mask = {}
    for name, sub in params.items():
        frozen = any(s in name for s in selectors)
        mask[name] = tree_map(lambda _: not frozen, sub)
    return mask


def bn_frozen_selectors(batch_norm_freeze_list) -> tuple:
    return tuple(_clean(batch_norm_freeze_list))


def do_transfer_learning(spec: ModelSpec, params, state, transfer_learning_config,
                         load_fn):
    """Apply a transfer_learning_config (reference YAML schema).

    ``load_fn(output_stage) → (ref_params, ref_state)`` loads the input
    checkpoint into a model truncated at that stage ('backbone' / 'neck').

    Returns (params, state, trainable_mask_or_None, bn_frozen_tuple).
    """
    cfg = transfer_learning_config or {}
    transfer = expand_transfer_list(cfg.get("transfer_list"))
    if transfer:
        ref_params, ref_state = load_fn(transfer[-1])
        params, state = transfer_weights(params, state, ref_params, ref_state, transfer)
    mask = trainable_mask(params, cfg.get("freeze_train_list"))
    bn_frozen = bn_frozen_selectors(cfg.get("batch_norm_freeze_list"))
    return params, state, mask, bn_frozen
