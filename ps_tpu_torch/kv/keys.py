"""Parameter-key handling, without ``jax.tree_util``.

Counterpart of ``ps_tpu/kv/keys.py``. Keys are slash-joined paths through
nested dicts, lists and tuples ("mlp_0/kernel"), visited in the order
``jax.tree_util`` visits them: dict keys sorted, sequences in order,
``None`` an empty node. The same nested dict therefore gives the same key
strings in the same order in both packages, which checkpoints, partition
rules and the weight converter rely on.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

_LEAF = object()  # marks a leaf's place in a treedef


def _walk(tree, path, out):
    if isinstance(tree, dict):
        return {k: _walk(tree[k], path + (str(k),), out) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, path + (str(i),), out)
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    out.append(("/".join(path), tree))
    return _LEAF


def flatten_with_keys(tree: Any) -> Tuple[Dict[str, Any], Any]:
    """Flatten a nested structure into a ``{key: leaf}`` dict plus its
    treedef (the structure with every leaf replaced by a marker).

    Keys are slash-joined path strings; collisions are an error.
    """
    leaves: List[Tuple[str, Any]] = []
    treedef = _walk(tree, (), leaves)
    out: Dict[str, Any] = {}
    for k, leaf in leaves:
        if k in out:
            raise ValueError(f"duplicate parameter key {k!r}")
        out[k] = leaf
    return out, treedef


def unflatten(treedef, kv: Dict[str, Any], key_order: List[str]) -> Any:
    """Rebuild the structure from a key dict using the original flatten
    order."""
    leaves = iter([kv[k] for k in key_order])

    def build(node):
        if node is _LEAF:
            return next(leaves)
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return node

    return build(treedef)
