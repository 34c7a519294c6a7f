"""Config layer: YAML loaders, safe arithmetic evaluation, anchors & class names.

Framework-neutral copy of ``yolov3_tpu/config.py`` (the port imports
nothing of the JAX package); tests/test_torch_layers_network.py pins the
copies to their originals.

Schema-compatible with the reference run configs (train_config.yaml,
detect_config.yaml, evaluate_config.yaml — see reference train.py:220-232)
and the model-DSL configs under config/models/** (reference
core/parse_model.py). Filter-count expressions like ``3*(2+2+1+nclasses)``
(reference core/parse_model.py:258-259) are evaluated with a restricted AST
walker, never ``eval``.
"""

from __future__ import annotations

import ast
import operator
import os

import numpy as np
import yaml

_BIN_OPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod,
    ast.Pow: operator.pow,
}

_UNARY_OPS = {ast.UAdd: operator.pos, ast.USub: operator.neg}


def safe_eval_expr(expr: str, variables: dict | None = None):
    """Evaluate a small arithmetic expression over named integer variables.

    Supports numbers, +-*/()//%**, unary +-, names bound in ``variables``,
    and tuple literals (incl. ``None`` elements, for input-shape strings like
    ``(None, None, 3)`` used by the legacy single-file model format).
    """
    variables = variables or {}

    def walk(node):
        if isinstance(node, ast.Expression):
            return walk(node.body)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float)) or node.value is None:
                return node.value
            raise ValueError(f"disallowed constant {node.value!r}")
        if isinstance(node, ast.BinOp) and type(node.op) in _BIN_OPS:
            return _BIN_OPS[type(node.op)](walk(node.left), walk(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARY_OPS:
            return _UNARY_OPS[type(node.op)](walk(node.operand))
        if isinstance(node, ast.Name):
            if node.id in variables:
                return variables[node.id]
            raise ValueError(f"unknown name {node.id!r} in expression")
        if isinstance(node, ast.Tuple):
            return tuple(walk(e) for e in node.elts)
        raise ValueError(f"disallowed expression node {type(node).__name__}")

    return walk(ast.parse(expr, mode="eval"))


def load_yaml(path: str) -> dict:
    """Load a run/model config. ``$VAR`` / ``${VAR}`` in string values are
    expanded from the environment (extension over the reference: lets bundled
    configs point at external image corpora relocatably, e.g.
    ``${PETS_DATA_ROOT}/train``)."""
    with open(path, "r") as stream:
        return _expandvars(yaml.safe_load(stream))


_VAR_DEFAULT_RE = None


def _expandvars(obj):
    if isinstance(obj, str) and "$" in obj:
        global _VAR_DEFAULT_RE
        if _VAR_DEFAULT_RE is None:
            import re

            _VAR_DEFAULT_RE = re.compile(r"\$\{(\w+):-([^}]*)\}")
        # shell-style ${VAR:-default} first, then plain $VAR / ${VAR}
        obj = _VAR_DEFAULT_RE.sub(lambda m: os.environ.get(m.group(1), m.group(2)), obj)
        return os.path.expandvars(obj)
    if isinstance(obj, dict):
        return {k: _expandvars(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_expandvars(v) for v in obj]
    return obj


def get_anchors(anchors_file: str) -> np.ndarray:
    """Load anchors CSV → float array of shape (nscales, 3, 2).

    Matches reference core/utils.py:31-37 (3 anchors per scale, (w, h) pairs,
    normalized to [0, 1] image coordinates).
    """
    nanchors_per_scale = 3
    anchor_entry_size = 2
    anchors_table = np.loadtxt(anchors_file, dtype=float, delimiter=",")
    return anchors_table.reshape(-1, nanchors_per_scale, anchor_entry_size)


def count_file_lines(filename: str) -> int:
    """Number of lines in a file — the reference's nclasses convention
    (reference core/utils.py:40-43, train.py:133-134)."""
    with open(filename, "r") as fp:
        return len(fp.readlines())


def read_class_names(filename: str) -> list[str]:
    with open(filename, "r") as fp:
        return [line.rstrip("\n") for line in fp.readlines()]


def dir_filelist(images_dir: str, ext_list=".*") -> list[str]:
    """List files under a dir filtered by extension (reference core/utils.py:46-53)."""
    filenames = []
    for f in sorted(os.listdir(images_dir)):
        ext = os.path.splitext(f)[1]
        if ext_list != ".*" and ext.lower() not in ext_list:
            continue
        filenames.append(f"{images_dir}/{f}")
    return filenames
