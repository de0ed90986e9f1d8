"""Nested-dict trees of tensors in the JAX package's leaf order.

``jax.tree.flatten`` visits a dict's keys in sorted order (lists and
tuples in their own order); the optimizer's global norm sums its leaves in
that order, and a checkpoint numbers its ``leaf_XXXXX.npy`` files by it, so
the port flattens the same way.  A leaf is anything that is not a dict, a
list or a tuple.
"""

from __future__ import annotations

from typing import Any, Callable


def _is_node(x: Any) -> bool:
    return isinstance(x, (dict, list, tuple))


def _children(x: Any) -> list[Any]:
    return [x[k] for k in sorted(x)] if isinstance(x, dict) else list(x)


def leaves(tree: Any) -> list[Any]:
    """The leaves of ``tree``, in ``jax.tree.leaves`` order."""
    if not _is_node(tree):
        return [tree]
    return [leaf for child in _children(tree) for leaf in leaves(child)]


def unflatten(like: Any, new_leaves: list[Any]) -> Any:
    """A tree shaped like ``like`` whose leaves are ``new_leaves``, taken
    in ``leaves`` order."""
    it = iter(new_leaves)

    def build(node: Any) -> Any:
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}        # keep the key order
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)
    tree = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree has")
    return tree


def map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of the same structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("tree.map: the trees differ in structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``jax.tree_util.tree_map_with_path``: ``fn(path, leaf, *others)``
    leaf by leaf, in ``leaves`` order.  ``path`` is the tuple of keys from
    the root to the leaf: a dict's key as it is (a str in every tree of
    this package), a list's or tuple's index as an int."""
    paths: list[tuple] = []

    def walk(node: Any, path: tuple) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, c in enumerate(node):
                walk(c, path + (i,))
        else:
            paths.append(path)
    walk(tree, ())
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(paths) for f in flat):
        raise ValueError("tree.map_with_path: the trees differ in structure")
    return unflatten(tree, [fn(p, *xs) for p, *xs in zip(paths, *flat)])


def structure(tree: Any) -> str:
    """``str(jax.tree.structure(tree))`` for a tree of dicts, lists, tuples
    and leaves, e.g. ``PyTreeDef({'a': *, 'b': [*, *]})``."""
    def spell(node: Any) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {spell(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(spell(c) for c in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(spell(c) for c in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({spell(tree)})"
