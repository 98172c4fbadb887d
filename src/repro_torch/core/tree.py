"""The reference's parameter and optimizer-state trees, leaf by leaf.

The JAX package stacks a model's layers on axis 0 (``layers/attn/wq`` is
one (L, dm, h, dh) array) and its optimizers, checkpoints and metrics work
per leaf of that stacked tree.  The port keeps one tensor a layer; a
:class:`Leaf` is the port's view of one reference leaf: the tensors of its
rows (``stacked``) or the one tensor of an unstacked leaf.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class Leaf(NamedTuple):
    tensors: list            # a stacked leaf: row l's tensor at [l]
    stacked: bool

    @property
    def shape(self) -> tuple[int, ...]:
        """The reference's shape of the leaf."""
        head = self.tensors[0].shape
        return (len(self.tensors), *head) if self.stacked else tuple(head)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensors[0].dtype

    def full(self) -> torch.Tensor:
        """The reference's array of the leaf (a stacked copy when
        ``stacked``)."""
        return (torch.stack(self.tensors) if self.stacked
                else self.tensors[0])


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Leaf]]:
    """(path, leaf) pairs of ``tree`` in the reference's order and with its
    path names (``jax.tree_util.tree_flatten_with_path``): a dict by sorted
    key, a tuple or list by index, a NamedTuple by field name, an object
    with ``ref_leaves()`` (a model) by its leaves; a tensor or a
    :class:`Leaf` is one leaf."""
    def join(key) -> str:
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, Leaf):
        return [(prefix, tree)]
    if isinstance(tree, torch.Tensor):
        return [(prefix, Leaf([tree], False))]
    if hasattr(tree, "ref_leaves"):
        tree = tree.ref_leaves()
        return [(join(k), leaf) for k, leaf in tree.items()]
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flatten(tree[k], join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for k, v in zip(tree._fields, tree)
                for pair in flatten(v, join(k))]
    if isinstance(tree, (tuple, list)):
        return [pair for i, v in enumerate(tree)
                for pair in flatten(v, join(i))]
    raise TypeError(f"no leaves in a {type(tree).__name__} at {prefix!r}")
