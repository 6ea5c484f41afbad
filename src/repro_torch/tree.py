"""Nested containers of tensors, the port's counterpart of JAX pytrees.

A tree is a leaf (a tensor or any other object), a dict, a NamedTuple, a
tuple or a list of trees.  Leaves come out in JAX's flattening order: dict
keys sorted, NamedTuple fields and sequence items in order.  A leaf's path
names each step the way ``jax.tree_util`` keys print: the dict key, the
NamedTuple field as ``.field`` and the sequence index, so that
``"$".join(map(str, path))`` is the JAX checkpoint name of the leaf
(``repro_torch.checkpoint``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

PyTree = Any
Path = Tuple[Any, ...]
_END = object()


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves_with_path(tree: PyTree, path: Path = (), is_leaf: Optional[Callable] = None
                     ) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in JAX's flattening order; a node for which
    ``is_leaf`` is true is a leaf, whatever its type."""
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in leaves_with_path(tree[k], path + (k,), is_leaf)]
    if _is_namedtuple(tree):
        return [item for f in tree._fields
                for item in leaves_with_path(getattr(tree, f), path + (f".{f}",), is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [item for i, x in enumerate(tree) for item in leaves_with_path(x, path + (i,), is_leaf)]
    return [(path, tree)]


def leaves(tree: PyTree, is_leaf: Optional[Callable] = None) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf=is_leaf)]


def unflatten(tree: PyTree, new_leaves, is_leaf: Optional[Callable] = None) -> PyTree:
    """A tree of ``tree``'s structure holding ``new_leaves`` (in the order
    ``leaves(tree, is_leaf)`` gives)."""
    it = iter(new_leaves)

    def build(node):
        if is_leaf is not None and is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(tree)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *ys) for x, *ys in zip(leaves(tree), *others, strict=True)])
