"""Deterministic top-k with JAX's tie order.

``jax.lax.top_k`` lists equal values lower index first, and the decode's
pose provenance follows that order. ``torch.topk`` promises no tie
order, so every budgeted selection in the port goes through a stable
descending sort instead.
"""

import torch


def top_k(values, k):
    """(values, indices) of the ``k`` largest entries along the last axis,
    ties in ascending index order (``jax.lax.top_k`` semantics)."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]
