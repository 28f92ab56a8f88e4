"""Trees of tensors: nested dicts, lists and tuples, the shape of the
port's parameters and training state (the reference walks them with
``jax.tree``). :func:`tree_map` pairs the leaves of several trees by key
and index, so two trees whose dicts were built in other orders still pair
up; :func:`tree_leaves` lists one tree's leaves in its own order, and
:func:`tree_unflatten` puts such a list back into that tree's
structure."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

IsLeaf = Optional[Callable[[Any], bool]]


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf: IsLeaf = None
             ) -> Any:
    """``fn`` on each leaf of ``tree`` (and the leaves at the same place in
    each of ``rest``), in a tree of the same structure. ``is_leaf(x)`` true
    makes ``x`` a leaf even where it is a tuple (a PartitionSpec is)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves_with_paths(tree: Any, prefix: str = "", is_leaf: IsLeaf = None
                      ) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` in order; a path joins the keys and list indices
    with ``/`` (``params/layers/0/attn/wq``)."""
    if is_leaf is not None and is_leaf(tree):
        items = None
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        items = None
    if items is None:
        yield prefix, tree
        return
    for k, v in items:
        yield from leaves_with_paths(
            v, f"{prefix}/{k}" if prefix else str(k), is_leaf)


def tree_leaves(tree: Any, is_leaf: IsLeaf = None) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf=is_leaf)]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """``leaves``, in :func:`tree_leaves` order, in ``like``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
