"""Loss and local optimizer of the port — counterparts of
``cross_entropy_loss`` and ``default_optimizer`` in
:mod:`tpfl.learning.jax_learner`.

The optimizer is functional over node-stacked tensors (a nested dict of
params, the same structure of momentum traces), so one step updates
every node's model at once.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from tpfl_torch.utils.tree import Tree, tree_map


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample softmax cross entropy on f32 logits ``[..., C]`` and
    integer labels ``[...]`` -> losses ``[...]`` (training takes the
    mean, evaluation weighs each sample)."""
    flat = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).to(torch.float32),
        labels.reshape(-1).to(torch.long),
        reduction="none",
    )
    return flat.reshape(labels.shape)


class SGDMomentum:
    """``optax.sgd(lr, momentum)`` on stacked tensors: per leaf
    ``t = g + momentum·t`` and ``p = p + (-lr)·t``, with the trace
    starting at zero."""

    def __init__(self, lr: float, momentum: float = 0.9) -> None:
        self.lr = float(lr)
        self.momentum = float(momentum)

    def init(self, params: Tree) -> Tree:
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def step(self, params: Tree, grads: Tree, trace: Tree) -> tuple[Tree, Tree]:
        """(new params, new trace); the inputs are left unchanged."""
        new_t = tree_map(lambda g, t: g + self.momentum * t, grads, trace)
        new_p = tree_map(lambda p, t: p + t * (-self.lr), params, new_t)
        return new_p, new_t


def default_optimizer(lr: float) -> SGDMomentum:
    """Canonical local optimizer: SGD + momentum 0.9."""
    return SGDMomentum(lr, momentum=0.9)


OptimizerFactory = Callable[[float], SGDMomentum]
