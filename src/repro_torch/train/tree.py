"""Trees of tensors: nested dicts, NamedTuples, lists and tuples.

The JAX package walks its parameters and optimizer state as pytrees; the
port keeps the same trees as plain Python containers and walks them
here, in the same order (a dict's keys sorted, as JAX flattens them) and
with the same path names (a dict key as itself, a NamedTuple field as
``.name``, a sequence index as its number), so a leaf's path reads the
same in both packages.  ``None`` is an empty subtree, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

__all__ = ["flatten_with_paths", "leaves", "map_tree", "unflatten_like"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(path component, child) pairs of a container, in JAX's order."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    raise TypeError(f"not a container: {type(tree).__name__}")


def _is_container(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def flatten_with_paths(tree, prefix: str = "",
                       is_leaf: Optional[Callable[[Any], bool]] = None
                       ) -> List[Tuple[str, Any]]:
    """Every leaf with its ``/``-joined path, in JAX's flattening order
    (a node for which ``is_leaf`` holds is a leaf)."""
    if tree is None:
        return []
    if not _is_container(tree) or (is_leaf is not None and is_leaf(tree)):
        return [(prefix, tree)]
    out = []
    for name, child in _children(tree):
        out += flatten_with_paths(child, f"{prefix}/{name}" if prefix
                                  else name, is_leaf)
    return out


def leaves(tree) -> List[Any]:
    """Every leaf, in JAX's flattening order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def map_tree(fn: Callable, tree, *rest, with_path: bool = False,
             is_leaf: Optional[Callable[[Any], bool]] = None):
    """A tree of the same structure whose leaves are ``fn(leaf, *others)``
    (``fn(path, leaf, *others)`` with ``with_path``); ``rest`` are trees
    of the same structure.  A node of ``tree`` for which ``is_leaf``
    holds is a leaf, whatever its type."""

    def walk(path, node, others):
        if node is None:
            return None
        if not _is_container(node) or (is_leaf is not None
                                       and is_leaf(node)):
            return fn(path, node, *others) if with_path else \
                fn(node, *others)
        other_kids = [_children(o) for o in others]
        mapped = {}
        for i, (name, child) in enumerate(_children(node)):
            mapped[name] = walk(f"{path}/{name}" if path else name, child,
                                [kids[i][1] for kids in other_kids])
        if isinstance(node, dict):
            return {k: mapped[str(k)] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(mapped[f".{f}"] for f in node._fields))
        return type(node)(mapped[str(i)] for i in range(len(node)))

    return walk("", tree, list(rest))


def unflatten_like(tree, values: Iterator[Any]):
    """``tree`` with its leaves replaced, in flattening order, by the
    items of ``values``."""
    it = iter(values)
    return map_tree(lambda _: next(it), tree)
