"""Nests of NamedTuples of tensors with a chunk's leading episode axis: the
per-episode select and the indexing that lets one episode run as the chunk
of one."""

from __future__ import annotations

import torch


def where_batch(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where with a per-episode ``cond`` (batch dims only) over values
    with trailing dims of their own."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - cond.ndim)), a, b)


def select(cond: torch.Tensor, old, new):
    """Per-episode :func:`where_batch` over a nest of NamedTuples."""
    if isinstance(old, tuple):
        return type(old)(*(select(cond, o, n) for o, n in zip(old, new)))
    return where_batch(cond, old, new)


def item(nest, i):
    """Index ``i`` of every tensor's leading axis in a nest of NamedTuples;
    ``None`` adds an axis of 1 (one episode as a chunk of one)."""
    if isinstance(nest, tuple):
        return type(nest)(*(item(x, i) for x in nest))
    return nest[i]
