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

``make_train_step(..., mesh=view)`` is the step of one rank of a
("data", "model") host mesh (``distributed.collectives.init_rank``'s
view), FSDP x TP by hand where ``repro`` jits the step over a mesh and
GSPMD inserts the collectives: the rank holds its blocks of the parameters
and of the optimizer state (``distributed.sharding.local_block`` under
``param_pspecs``) and its rows of the batch (``train.data.BatchRows``).
Its loss is the mean over its rows; the FSDP leaves' gradients come back
from the gather's backward reduce-scattered with a sum, the others are
all-reduced over ``data`` (qk-norm's over ``model`` too: it acts on the
rank's heads only), and all are divided by dp, so with equal rows the
update is the one-device step's.  The gradient compressor takes each
leaf's max over its shards; the returned loss is the global mean and
``grad_norm`` the global norm (a block replicated over an axis counted
once).  A 1x1 mesh runs the one-device model code.
"""
from __future__ import annotations

import math

import torch

from ..models import encdec as E
from ..models import transformer as T
from ..models.config import ModelConfig
from ..distributed import collectives as C
from ..distributed import sharding as SH
from ..optim.adamw import Adafactor, slices, tree_leaves
from ..optim.grad_compress import GradCompressor

__all__ = ["make_loss_fn", "make_train_step", "init_train_state",
           "value_and_grad", "grad_norm", "make_value_and_grad",
           "sharded_extra_bytes"]


def make_loss_fn(cfg: ModelConfig, par=None):
    """The loss of a batch; with a rank's ``par``
    (``distributed.collectives.Parallel``) the rank's, over its rows."""
    if cfg.family == "audio":
        def loss(params, batch):
            return E.loss_fn_encdec(cfg, params, batch["frames"],
                                    batch["tokens"])
    else:
        def loss(params, batch):
            return T.loss_fn(cfg, params, batch["tokens"],
                             batch.get("aux"), par)
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


def _sum_squares(leaves, device) -> torch.Tensor:
    sq = None
    with torch.no_grad():
        for g in leaves:
            for gs, in slices(g):
                part = torch.sum(torch.square(gs.to(torch.float32)))
                sq = part if sq is None else sq + part
    if sq is None:
        return torch.zeros((), dtype=torch.float32, device=device)
    return sq


def grad_norm(grads) -> torch.Tensor:
    """The f32 2-norm of every leaf of ``grads`` together, a slice of a
    leaf at a time (``optim.adamw.slices``)."""
    leaves = tree_leaves(grads)
    return torch.sqrt(_sum_squares(leaves, leaves[0].device))


def _owned(spec, mesh) -> bool:
    """Whether this rank counts its block of a leaf under ``spec``: it is
    the first along every axis the block is replicated over."""
    used = {a for ax in spec if ax is not None
            for a in (ax if isinstance(ax, tuple) else (ax,))}
    return all(mesh.index(a) == 0 for a in mesh.axis_names if a not in used)


def make_train_step(cfg: ModelConfig, optimizer,
                    grad_compressor: GradCompressor | None = None,
                    mesh=None):
    """The step ``(params, state, batch) -> (params, state, metrics)``;
    with ``mesh`` (a rank's view of a host mesh) the rank's sharded step
    (see the module note)."""
    if mesh is None:
        loss_fn = make_loss_fn(cfg)

        def grad_fn(params, batch):
            return value_and_grad(loss_fn, params, batch)
        reduce_max, norm = None, grad_norm
    else:
        grad_fn, reduce_max, norm = _sharded_parts(cfg, optimizer, mesh)

    def train_step(params, state, batch):
        loss, grads = grad_fn(params, batch)
        if grad_compressor is not None:
            grads, new_err = grad_compressor.roundtrip(
                grads, state["gc_err"], reduce_max=reduce_max)
        params, opt = optimizer.update(grads, state["opt"], params)
        new_state = {"opt": opt}
        if grad_compressor is not None:
            new_state["gc_err"] = new_err
        gnorm = norm(grads)
        del grads
        return params, new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_value_and_grad(cfg: ModelConfig, mesh):
    """One rank's ``(params, batch) -> (loss, grads)`` on ``mesh`` (its
    view): the global mean loss, and its gradient blocks of the global
    mean, each summed over the ranks that hold parts of it (FSDP leaves
    through the gather's reduce-scatter, the rest all-reduced here) and
    divided by dp.  Raises for what a mesh larger than 1x1 does not run
    (``distributed.sharding.check_shardable``)."""
    specs = par = None
    if mesh.size > 1:
        SH.check_shardable(cfg, mesh)
        full = T.init_params(cfg, device="meta")
        specs = SH.param_pspecs(cfg, full, mesh)
        SH.check_shardable(cfg, mesh, full, specs)
        par = C.Parallel(mesh, specs)
    dp = mesh.shape.get("data", 1)
    loss_fn = make_loss_fn(cfg, par)

    def fn(params, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        if specs is not None:
            with torch.no_grad():
                for names, g, spec in SH.named_specs(grads, specs):
                    if SH.fsdp_dim(spec) is None:
                        g.copy_(C.all_reduce(g, mesh, "data"))
                    if names[-1] in SH.PARTIAL_OVER_MODEL:
                        g.copy_(C.all_reduce(g, mesh, "model"))
                    if dp > 1:
                        g.div_(dp)
        return C.all_reduce(loss, mesh, "data") / dp, grads

    fn.specs = specs
    return fn


def _sharded_parts(cfg: ModelConfig, optimizer, mesh) -> tuple:
    """A rank's gradient function, the compressor's max over shards (None
    on a world of one) and the global gradient norm."""
    if mesh.size > 1 and isinstance(optimizer, Adafactor):
        raise NotImplementedError(
            "Adafactor's factored moments across shards are not ported "
            "yet (ROADMAP A12h-b); a mesh larger than 1x1 trains with "
            "AdamW")
    grad_fn = make_value_and_grad(cfg, mesh)
    specs = grad_fn.specs

    def max_over_shards(t):
        return C.all_reduce(t, mesh, None, op="max")

    def norm(grads) -> torch.Tensor:
        pairs = (SH.spec_leaves(grads, specs) if specs is not None
                 else [(g, ()) for g in tree_leaves(grads)])
        mine = [g for g, spec in pairs if _owned(spec, mesh)]
        sq = _sum_squares(mine, pairs[0][0].device)
        return torch.sqrt(C.all_reduce(sq, mesh, None))

    return grad_fn, (max_over_shards if mesh.size > 1 else None), norm


def sharded_extra_bytes(cfg: ModelConfig, batch: int, seq: int, params,
                        specs, mesh, act_bytes: int = 2) -> dict:
    """The collective bytes one rank of the sharded step moves a step
    beyond ``launch/dryrun.py::collective_bytes(cfg, "train", batch, seq,
    params, specs, mesh)``, by kind, and the named terms (``params`` the
    full tree, ``meta`` will do; ``batch`` global; activations of
    ``act_bytes``, bf16 as the dry run counts them).  With ``model`` > 1:

    * ``embedding``: the vocab-parallel lookup's all-reduce over
      ``model``, b·S·d activations, once (outside the checkpointed units);
    * ``logits_input``: *f* before the tied logits, whose backward
      all-reduces the logits' input gradient, b·S·d;
    * ``cross_entropy``: the max, the sum of exponentials and the target
      logit over ``model``, three f32 values a target, 3·b·(S-1)·4;
    * ``qk_norm_over_model``: the qk-norm gradients (replicated leaves
      that act on the rank's heads only), their blocks;

    then ``loss`` over ``data`` (4 bytes, dp > 1) and ``grad_norm`` over
    the world (4, more than one rank).  Under remat ``collective_bytes``
    gathers every FSDP leaf twice, but the leaves outside the checkpointed
    units (the embedding) are gathered once: ``all-gather`` is negative by
    their gathered blocks."""
    dp, tp = mesh.shape.get("data", 1), mesh.shape.get(SH.TP_AXIS, 1)
    b = batch // dp
    terms = {}
    if tp > 1:
        act = b * seq * cfg.d_model * act_bytes
        terms.update(embedding=act, logits_input=act,
                     cross_entropy=3 * b * (seq - 1) * 4)
        qk = sum(leaf.numel() * leaf.element_size()
                 for names, leaf, _ in SH.named_specs(params, specs)
                 if names[-1] in SH.PARTIAL_OVER_MODEL)
        if qk:
            terms["qk_norm_over_model"] = qk
    if dp > 1:
        terms["loss"] = 4
    if mesh.size > 1:
        terms["grad_norm"] = 4
    regather = 0
    if cfg.remat and dp > 1:
        for names, leaf, spec in SH.named_specs(params, specs):
            dim = SH.fsdp_dim(spec)
            if names[0] == "units" or dim is None:
                continue
            shape = SH.shard_shape(tuple(leaf.shape), spec, mesh)
            regather += leaf.element_size() * dp * math.prod(shape)
    return {"all-gather": -regather, "reduce-scatter": 0,
            "all-reduce": sum(terms.values()), "terms": terms}
