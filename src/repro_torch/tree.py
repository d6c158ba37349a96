"""Trees of the port: nested dicts, lists, tuples and NamedTuples whose
leaves are tensors (a parameter dict, an optimizer state, a batch).

Every function here walks a tree in ``jax.tree_util``'s order — dict keys
sorted, sequences and NamedTuple fields in order — and a leaf's path is
spelled as the reference's checkpoints spell it: dict keys and field names
as they are, sequence positions as numbers, joined by ``/``
(``params/period/0/mixer/wq``, ``opt/mu/embed/tok``).  So a tree of the port
flattens to the same leaves, in the same order and under the same names as
the reference's tree of the same layout: a sum over the leaves adds them in
the reference's order, and one checkpoint is read by either package.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

__all__ = ["leaves_with_path", "leaves", "unflatten", "tree_map",
           "map_with_path"]


def _children(node, is_leaf: Optional[Callable] = None) -> Optional[list]:
    """(key, child) pairs of an inner node, in the reference's order (dict
    keys, field names, positions); None for a leaf."""
    if is_leaf is not None and is_leaf(node):
        return None
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _rebuild(node, kids: list) -> Any:
    """A node of ``node``'s type over new children given in walk order."""
    if isinstance(node, dict):
        return dict(zip(sorted(node), kids))
    if hasattr(node, "_fields"):
        return type(node)(*kids)
    return type(node)(kids)


def leaves_with_path(tree) -> list:
    """[(path, leaf)] in the reference's order."""
    out: list = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for key, child in kids:
            walk(child, f"{path}/{key}" if path else str(key))

    walk(tree, "")
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure over ``new_leaves``, given in walk order."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), tree)


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None
             ) -> Any:
    """``fn(leaf, *others)`` over the leaves of ``tree``, rebuilt in its
    structure.  Each of ``rest`` has ``tree``'s structure down to its
    leaves and may hold a subtree where ``tree`` has a leaf (the
    reference's ``flatten_up_to``: a factored second moment is a
    ``{"row", "col"}`` dict where its parameter is one tensor)."""
    kids = _children(tree, is_leaf)
    if kids is None:
        return fn(tree, *rest)
    keys = ([k for k, _ in kids] if isinstance(tree, dict)
            else range(len(kids)))
    return _rebuild(tree, [
        tree_map(fn, child, *(r[k] for r in rest), is_leaf=is_leaf)
        for k, (_, child) in zip(keys, kids)])


def map_with_path(fn: Callable, tree, path: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``, rebuilt in its
    structure (paths spelled as :func:`leaves_with_path` spells them)."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    return _rebuild(tree, [
        map_with_path(fn, child, f"{path}/{key}" if path else str(key))
        for key, child in kids])
