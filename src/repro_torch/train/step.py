"""Train-step factory: loss -> grads -> (optional grad compression) ->
update.

The port of ``repro/train/step.py``.  One factory covers all families; the
batch dict keys select the path:

  decoder LMs   {"tokens"}           (+ "aux" image embeddings for a VLM)
  enc-dec       {"frames", "tokens"}

``jax.value_and_grad`` becomes ``loss.backward()`` on parameters that
require grad; the compressor's round trip and the optimizer's update then
run in place (``optim``), ``grad_norm`` is the f32 2-norm of the gradients
that were applied, and the gradients are freed before the step returns.
The step returns the same parameter and state trees it was given, their
tensors updated.
"""
from __future__ import annotations

import torch

from ..models import encdec as E
from ..models import transformer as T
from ..models.config import ModelConfig
from ..optim.adamw import slices, tree_leaves
from ..optim.grad_compress import GradCompressor

__all__ = ["make_loss_fn", "make_train_step", "init_train_state",
           "value_and_grad", "grad_norm"]


def make_loss_fn(cfg: ModelConfig):
    if cfg.family == "audio":
        def loss(params, batch):
            return E.loss_fn_encdec(cfg, params, batch["frames"],
                                    batch["tokens"])
    else:
        def loss(params, batch):
            return T.loss_fn(cfg, params, batch["tokens"],
                             batch.get("aux"))
    return loss


def init_train_state(cfg: ModelConfig, params, optimizer,
                     grad_compressor: GradCompressor | None = None):
    state = {"opt": optimizer.init(params)}
    if grad_compressor is not None:
        state["gc_err"] = grad_compressor.init(params)
    return state


def value_and_grad(loss_fn, params, batch):
    """(loss, gradients) of ``loss_fn(params, batch)``: the loss a 0-d f32
    tensor, the gradients a tree like ``params`` (zeros where a leaf took
    no part); each leaf's ``.grad`` is cleared again and its
    ``requires_grad`` put back."""
    leaves = tree_leaves(params)
    flags = [p.requires_grad for p in leaves]
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    try:
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            loss.backward()
        grads = {id(p): p.grad if p.grad is not None
                 else torch.zeros_like(p) for p in leaves}
    finally:
        for p, flag in zip(leaves, flags):
            p.grad = None
            p.requires_grad_(flag)
    return loss.detach(), _like(params, grads)


def _like(tree, by_id: dict):
    if isinstance(tree, dict):
        return {k: _like(v, by_id) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(v, by_id) for v in tree)
    return by_id[id(tree)]


def grad_norm(grads) -> torch.Tensor:
    """The f32 2-norm of every leaf of ``grads`` together, a slice of a
    leaf at a time (``optim.adamw.slices``)."""
    sq = None
    with torch.no_grad():
        for g in tree_leaves(grads):
            for gs, in slices(g):
                part = torch.sum(torch.square(gs.to(torch.float32)))
                sq = part if sq is None else sq + part
    return torch.sqrt(sq)


def make_train_step(cfg: ModelConfig, optimizer,
                    grad_compressor: GradCompressor | None = None):
    loss_fn = make_loss_fn(cfg)

    def train_step(params, state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        if grad_compressor is not None:
            grads, new_err = grad_compressor.roundtrip(grads,
                                                       state["gc_err"])
        params, opt = optimizer.update(grads, state["opt"], params)
        new_state = {"opt": opt}
        if grad_compressor is not None:
            new_state["gc_err"] = new_err
        gnorm = grad_norm(grads)
        del grads
        return params, new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
