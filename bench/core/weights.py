"""The weights of a cell, drawn by the benchmark from ``--seed``.

The benchmark, not the port's ``init_params``, draws them: every leaf of the
layout the configuration names (``"layout": "bench/layouts/<name>.py"``,
whose ``layout(model)`` lists the leaves in the port's tree order) from a
generator of its own, seeded with the run's seed and the leaf's place in the
list, on the device, in the configuration's dtype, one call a leaf. So the
reference can draw any leaf again, alone and in the same bits, after the
program's copy is freed.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

#: a leaf: (path, shape, kind, scale); kind "normal" (N(0, scale^2)) or
#: "gain" (1 + N(0, scale^2))
Leaf = Tuple[str, Tuple[int, ...], str, float]


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` under run seed ``seed`` (any
    whole number; the driver's exceed 32 bits)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019
            * (index + 1)) % (2 ** 63)


def draw_leaf(leaf: Leaf, seed: int, index: int, dtype: torch.dtype,
              device) -> torch.Tensor:
    _, shape, kind, scale = leaf
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, index))
    t = torch.randn(shape, generator=g, dtype=dtype, device=device)
    t.mul_(scale)
    if kind == "gain":
        t.add_(1.0)
    return t


def _put(tree: Dict, path: str, value) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        if k == "layers":
            node = node.setdefault("layers", [])
            continue
        if isinstance(node, list):
            i = int(k)
            while len(node) <= i:
                node.append({})
            node = node[i]
        else:
            node = node.setdefault(k, {})
    node[keys[-1]] = value


class Weights:
    """The leaves of one layout under one seed, in one dtype, on one
    device: the whole tree for the program, any part again for the
    reference."""

    def __init__(self, leaves: List[Leaf], dtype: str, seed: int, device):
        self.leaves, self.seed, self.device = leaves, seed, device
        self.dtype = DTYPES[dtype]

    def tree(self) -> Dict:
        """The whole parameter tree in the port's layout."""
        tree: Dict = {}
        for i, leaf in enumerate(self.leaves):
            _put(tree, leaf[0], draw_leaf(leaf, self.seed, i, self.dtype,
                                          self.device))
        return tree

    def prefix(self, prefix: str) -> Iterator[Tuple[str, torch.Tensor]]:
        """``(name, tensor)`` of each leaf whose path starts with
        ``prefix``, drawn again alone (``name`` the path after the prefix):
        the same bits :meth:`tree` gave."""
        for i, leaf in enumerate(self.leaves):
            if leaf[0].startswith(prefix):
                yield leaf[0][len(prefix):], draw_leaf(
                    leaf, self.seed, i, self.dtype, self.device)


def tree_paths(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """``(path, leaf)`` of a nested dict / list tree, paths joined by
    ``/`` as a layout writes them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for k, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree
