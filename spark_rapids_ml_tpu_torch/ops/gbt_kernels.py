"""Gradient-boosted trees on the port's histogram forest builder
(counterpart of ``spark_rapids_ml_tpu/ops/gbt_kernels.py``).

Boosting is sequential over rounds and parallel within one: each round
grows ``n_out`` trees (1 for squared or binary logistic loss, K for
multinomial softmax) on per-row gradient stats, as one tree batch of the
level-wise builder (``tree_kernels._grow_trees_batched``), so K5 (or K6)
runs at every split level as it does for RandomForest.

- **Every tree sees every row.** The port runs on one device, so the
  builder's ``allreduce`` hook stays unset; the JAX package sums the same
  histograms over its data-parallel mesh (``psum``).
- **Leaf values come from the gradient stats, Newton-style.** Trees grow
  with variance impurity on the residual (slots ``(w, r, r^2[, h])``); the
  leaf value is ``sum(r)/sum(h)`` (logistic, softmax) or ``sum(r)/sum(w)``
  (squared loss), scaled by the learning rate on the device in f32. Those
  exact numbers advance the training margins and are what the model
  stores, so transform-time margins reproduce the training margins.

Loss conventions follow the JAX package (sklearn's): squared error fits
mean residuals; binary logistic fits ``r = y - sigmoid(margin)`` with ``h
= p(1-p)``; softmax fits one tree per class per round on ``r_k = 1[y=k] -
p_k`` with the ``(K-1)/K`` damping on leaf values.

Feature subsets, when ``featureSubsetStrategy`` asks for them, are drawn
from ``tree_kernels.TorchDraws`` with tree id ``round * n_out + j`` (the
JAX package folds ``j`` into a per-round ``jax.random`` key, whose bits
cannot be reproduced). Without a subset (GBT's default ``"all"``) there
are no draws, and both packages grow the same trees.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch

from .tree_kernels import ForestConfig, _grow_trees_batched


class GBTConfig(NamedTuple):
    """Boosting configuration. ``loss``: "squared" | "logistic" |
    "multinomial"; ``n_out``: trees per round (1, or n_classes for
    multinomial); ``tree``: the per-round build config, with ``n_stats`` 3
    for squared loss (w, r, r^2) and 4 otherwise (w, r, r^2, h: the hessian
    slot rides through every histogram untouched, since variance impurity
    reads slots 0-2 only)."""

    loss: str
    n_out: int
    learning_rate: float
    tree: ForestConfig


def _row_stats(y: torch.Tensor, marg: torch.Tensor, mask: torch.Tensor, cfg: GBTConfig) -> torch.Tensor:
    """Per-row sufficient stats (n_out, n, S) for this round's trees."""
    w = mask
    if cfg.loss == "squared":
        r = (y - marg[:, 0]) * w
        return torch.stack([w, r, r * r], dim=1)[None]
    if cfg.loss == "logistic":
        p = torch.sigmoid(marg[:, 0])
        r = (y - p) * w
        h = torch.clamp_min(p * (1.0 - p), 1e-12) * w
        return torch.stack([w, r, r * r, h], dim=1)[None]
    if cfg.loss == "multinomial":
        p = torch.softmax(marg, dim=1)                                  # (n, K)
        onehot = torch.nn.functional.one_hot(y.long(), cfg.n_out).to(marg.dtype)
        r = (onehot - p) * w[:, None]
        h = torch.clamp_min(p * (1.0 - p), 1e-12) * w[:, None]
        return torch.stack([w[:, None].expand_as(r), r, r * r, h], dim=2).permute(1, 0, 2).contiguous()
    raise ValueError(f"unknown GBT loss {cfg.loss!r}")


def _leaf_values(leaf_stats: torch.Tensor, cfg: GBTConfig) -> torch.Tensor:
    """(T, M) learning-rate-scaled leaf predictions from raw leaf stats."""
    if cfg.loss == "squared":
        val = leaf_stats[:, :, 1] / torch.clamp_min(leaf_stats[:, :, 0], 1e-12)
    else:
        val = leaf_stats[:, :, 1] / torch.clamp_min(leaf_stats[:, :, 3], 1e-12)
        if cfg.loss == "multinomial":
            val = val * ((cfg.n_out - 1.0) / cfg.n_out)
    return cfg.learning_rate * val


def gbt_round(
    bins: torch.Tensor,
    mask: torch.Tensor,
    y: torch.Tensor,
    margins: torch.Tensor,
    *,
    cfg: GBTConfig,
    trees: Sequence[int],
    draws,
) -> Dict[str, torch.Tensor]:
    """One boosting round on one device: grow this round's ``n_out`` trees
    on the current gradient field and advance the margins.

    ``bins`` (n, d_pad) uint8, ``mask`` (n,) 1/0 row validity, ``y`` (n,)
    labels, ``margins`` (n, V) raw margins; ``trees`` the round's tree ids
    (what ``draws`` is asked for). Returns the tree tables ``feature``,
    ``threshold_bin``, ``leaf_stats``, ``gain``, ``values`` (the lr-scaled
    leaf payloads) and the new ``margins``."""
    sw = _row_stats(y, margins, mask, cfg)                              # (T, n, S)
    out = _grow_trees_batched(bins, sw, trees, draws, cfg.tree, return_rows=True)
    vscaled = _leaf_values(out["leaf_stats"], cfg)                      # (T, M)
    # each row's leaf came out of growth: no second descent
    upd = vscaled.gather(1, out["node"])                                # (T, n)
    return {
        "feature": out["feature"],
        "threshold_bin": out["threshold_bin"],
        "leaf_stats": out["leaf_stats"],
        "gain": out["gain"],
        "values": vscaled,
        "margins": margins + upd.T * mask[:, None],
    }


def gbt_loss(y: torch.Tensor, margins: torch.Tensor, mask: torch.Tensor, *, loss: str) -> torch.Tensor:
    """Mean training loss at the current margins."""
    if loss == "squared":
        per_row = (y - margins[:, 0]) ** 2
    elif loss == "logistic":
        m = margins[:, 0]
        # -[y log p + (1-y) log(1-p)] in the stable logaddexp form
        per_row = torch.logaddexp(torch.zeros_like(m), m) - y * m
    else:
        logp = torch.log_softmax(margins, dim=1)
        per_row = -logp.gather(1, y.long()[:, None])[:, 0]
    return (per_row * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
