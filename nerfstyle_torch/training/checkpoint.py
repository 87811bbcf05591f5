"""Checkpoint save/load in the JAX package's ``.npz`` format (counterpart of
``nerfstyle_tpu/training/checkpoint.py``).

One ``.npz`` holds ``__meta__`` (JSON: configs, counters, and the tree
structures) and ``<group>.NNNNN``, the leaves of each named tree in JAX
``tree_flatten`` order.  That order is reproduced here without JAX: dict keys
sorted, list and tuple items in order (a NamedTuple such as
``PersistedOccupancy`` in field order), ``None`` holds no leaf, anything else
is a leaf.  So a checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree: Any) -> List[Any]:
    """Leaves of a nested dict/list/tuple tree in JAX ``tree_flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_flatten(item)]
    return [tree]


def _unflatten(template: Any, leaves: List[Any], pos: int, conv) -> Tuple[Any, int]:
    if template is None:
        return None, pos
    if isinstance(template, dict):
        out = {}
        for k in sorted(template):
            out[k], pos = _unflatten(template[k], leaves, pos, conv)
        return {k: out[k] for k in template}, pos
    if isinstance(template, (list, tuple)):
        items = []
        for item in template:
            v, pos = _unflatten(item, leaves, pos, conv)
            items.append(v)
        if _is_namedtuple(template):
            return type(template)(*items), pos
        return type(template)(items), pos
    return conv(leaves[pos]), pos + 1


def _structure(tree: Any) -> str:
    """Readable structure string stored in the meta (not read back)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(t) for t in tree)
        if _is_namedtuple(tree):
            return f"{type(tree).__name__}({inner})"
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: Path, meta: Dict, trees: Dict[str, Any]) -> None:
    """Write meta (JSON-serializable) and named trees to one ``.npz``."""
    arrays = {}
    structures = {}
    for group, tree in trees.items():
        structures[group] = _structure(tree)
        for i, leaf in enumerate(tree_flatten(tree)):
            arrays[f"{group}.{i:05d}"] = _to_numpy(leaf)
    meta = dict(meta)
    meta["__structures__"] = structures
    arrays["__meta__"] = np.frombuffer(json.dumps(meta, default=str).encode(), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    tmp.replace(path)


def load_checkpoint(path: Path) -> Tuple[Dict, Dict[str, list]]:
    """Read meta and the per-group leaf lists (in saved order)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        groups: Dict[str, list] = {}
        for k in sorted(k for k in data.files if k != "__meta__"):
            group, _idx = k.rsplit(".", 1)
            groups.setdefault(group, []).append(data[k])
    return meta, groups


def restore_tree(template: Any, leaves: list, device=None) -> Any:
    """Rebuild a tree with the template's structure from saved leaves, as
    tensors on ``device``."""
    n = len(tree_flatten(template))
    if n != len(leaves):
        raise ValueError(
            f"checkpoint leaf count {len(leaves)} does not match template {n} — "
            "config/code mismatch"
        )
    tree, _ = _unflatten(template, leaves, 0, lambda v: torch.as_tensor(np.asarray(v)).to(device))
    return tree
