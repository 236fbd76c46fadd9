"""Nested dicts and lists of arrays, flattened the way ``jax.tree_util``
flattens them, for the checkpoint and incident files.

A tree is a dict (keys visited in sorted order), a list or tuple (in
order), ``None`` (an empty subtree, no leaf) or a leaf (a tensor, an
array or a Python scalar).  A leaf's path is its keys and indices joined
with ``/``: the strings the reference's checkpoints store, so a tree of
the reference's layout flattens to the same paths and leaves in the same
order in both packages.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def flatten(tree: Any) -> Tuple[List[str], List[Any]]:
    """(paths, leaves) of ``tree``, in ``jax.tree_util`` order."""
    paths: List[str] = []
    leaves: List[Any] = []

    def walk(node, prefix: List[str]) -> None:
        if node is None:
            return
        if _is_node(node):
            for key, child in _children(node):
                walk(child, prefix + [key])
            return
        paths.append("/".join(prefix))
        leaves.append(node)

    walk(tree, [])
    return paths, leaves


def unflatten_like(template: Any, leaves: List[Any],
                   convert: Callable[[Any, Any], Any]) -> Any:
    """A tree shaped like ``template`` whose i-th leaf is
    ``convert(template leaf i, leaves[i])``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return convert(node, next(it))

    return build(template)


def leaves_like(template: Any, tree: Any) -> List[Any]:
    """The subtrees of ``tree`` at the places of ``template``'s leaves, in
    flatten order: ``tree`` has ``template``'s structure down to those
    places, and anything (a tuple, a dict) below them."""
    out: List[Any] = []

    def walk(node, other) -> None:
        if node is None:
            return
        if _is_node(node):
            for (key, child), (_, sub) in zip(_children(node),
                                              _children(other)):
                walk(child, sub)
            return
        out.append(other)

    walk(template, tree)
    return out


def structure(tree: Any) -> str:
    """The tree's shape with ``*`` for each leaf, in the format of the
    reference's ``str(treedef)``, e.g. ``PyTreeDef({'a': [*, *], 'b': *})``."""

    def fmt(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(fmt(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(fmt(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({fmt(tree)})"
