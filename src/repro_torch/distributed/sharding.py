"""Logical-axis sharding rules -> partition specs for params/batches/caches.

The port of ``repro/distributed/sharding.py``, with the same name-based
rules (``repro``'s DESIGN.md §8: 2-D "FSDP x TP"):

* ``data`` (x ``pod`` when multi-pod) is the FSDP axis: batch is
  data-parallel over it AND every weight matrix shards its non-TP dim over
  it (all-gathered for use; gradients reduce-scatter back).
* ``model`` is the tensor-parallel axis: attention heads / ff / vocab.
* MoE expert dim shards over the FSDP axes (expert parallelism); each
  expert's ff still shards over ``model``.
* Decode KV caches shard batch over FSDP and the *sequence* dim over
  ``model`` (sequence parallelism — the only layout that fits 500k-token
  caches); recurrent states shard their width over ``model``.

Rules are name-based over the tree's dict keys, with leading stacked dims
(units / layers) padded with None.

Torch has no ``PartitionSpec``: a spec here is a plain tuple with one entry
per dimension, ``None``, a mesh axis name, or a tuple of names (``repro``'s
``PartitionSpec`` converted with ``tuple``), and a spec tree mirrors its
tensor tree (dicts, lists, tuples) with a spec where each tensor is.  A mesh
is any object with ``axis_names`` and a ``shape`` mapping axis -> size
(``launch/mesh.py``'s description, or a test's stand-in).  ``repro``'s
``named_shardings`` and ``activate_mesh`` name JAX objects; in their place
:func:`shard_shape` gives one device's block of a tensor under a spec and
:func:`shard_bytes` the bytes one device holds of a tree.

For sharded execution (``train.step.make_train_step(..., mesh=...)``) a
rank holds :func:`local_block` of each leaf, and :func:`gather_tree` puts
the full leaves back together (checkpoints use it; the step does not).  An
axis that ``param_pspecs`` dropped leaves its dim whole: a leaf with no
FSDP axis is not gathered and its gradient is all-reduced over ``data``;
a tensor-parallel leaf whose ``model`` axis was dropped cannot be run
tensor-parallel, and :func:`check_shardable` raises for it.
"""
from __future__ import annotations

import math

import torch

from ..models.config import ModelConfig

TP_AXIS = "model"

__all__ = ["TP_AXIS", "dp_axes", "norm_axes", "param_pspecs",
           "batch_pspecs", "cache_pspecs", "axes_size", "shard_shape",
           "shard_bytes", "map_with_names", "spec_leaves", "local_block",
           "shard_tree", "gather_leaf", "gather_tree", "train_state_pspecs",
           "check_shardable", "named_specs", "fsdp_dim",
           "PARTIAL_OVER_MODEL"]


def dp_axes(mesh):
    """FSDP/DP axes present in the mesh ('pod' first when multi-pod)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def norm_axes(axes):
    """Collapse a 1-tuple mesh-axis set to its element and () to None, as
    ``repro`` does (its PartitionSpec equality distinguishes ('data',)
    from 'data')."""
    if isinstance(axes, tuple):
        if not axes:
            return None
        if len(axes) == 1:
            return axes[0]
    return axes


def map_with_names(fn, tree, names: tuple = ()):
    """``fn(names, tensor)`` over a tree of dicts, lists and tuples, keeping
    its containers; ``names`` are the dict keys on the way to the tensor
    (list and tuple positions are not names, as in ``repro``'s
    ``_path_names``)."""
    if isinstance(tree, dict):
        return {k: map_with_names(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_names(fn, v, names) for v in tree)
    return fn(list(names), tree)


def spec_leaves(tree, specs) -> list[tuple]:
    """(tensor, spec) pairs of a tensor tree and its spec tree, dict keys
    sorted as ``jax.tree`` orders them (a spec is a tuple: the walk follows
    the tensors)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in spec_leaves(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [p for t, s in zip(tree, specs) for p in spec_leaves(t, s)]
    return [(tree, specs)]


_REPLICATED = {
    "ln1", "ln2", "lnx", "final_norm", "enc_norm", "q_norm", "k_norm",
    "b_gates", "conv_b", "lam", "router", "step",
}


def axes_size(axes, mesh) -> int:
    """Devices along ``axes`` (None, one axis name or a tuple of them)."""
    if axes is None:
        return 1
    size = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        size *= mesh.shape[a]
    return size


def _base_spec(cfg: ModelConfig, names: list[str], name: str, fsdp, tp,
               shape=None, mesh=None) -> tuple:
    """Spec for the *unstacked* trailing dims of a leaf."""
    if name in _REPLICATED:
        return ()
    if name == "embed":
        return (tp, fsdp)                # (V, d): vocab over TP
    if name == "unembed":
        return (fsdp, tp)
    if name in ("wq", "wk", "wv"):
        return (fsdp, tp)
    if name == "wo":
        return (tp, fsdp)
    if name in ("bq", "bk", "bv"):
        return (tp,)
    if name in ("w_in", "w_gate", "w_out"):
        is_moe = (cfg.moe is not None and "mlp" in names
                  and "dense" not in names)
        if is_moe:                       # (E, d, ff) / (E, ff, d)
            # expert-parallel over FSDP when E divides it (arctic 128e);
            # otherwise FSDP the d/ff dims (mixtral 8e < 16 devices)
            e_ok = (shape is not None and len(shape) == 3
                    and fsdp and shape[0] % axes_size(fsdp, mesh) == 0)
            if name != "w_out":
                return (fsdp, None, tp) if e_ok else (None, fsdp, tp)
            return (fsdp, tp, None) if e_ok else (None, tp, fsdp)
        return (fsdp, tp) if name != "w_out" else (tp, fsdp)
    if name in ("w_x", "w_g", "w_up", "w_q", "w_k", "w_v", "w_gates",
                "r_gates", "w_if"):
        return (fsdp, tp)
    if name in ("w_down", "w_out_proj"):
        return (tp, fsdp)
    if name == "conv_w":
        return (None, tp)
    if name in ("w_a", "w_i"):
        return (None, tp)
    return ()                            # safe default: replicate


def param_pspecs(cfg: ModelConfig, params_tree, mesh):
    """Spec tree mirroring ``params_tree`` (tensors, e.g. on ``meta``)."""
    fsdp = norm_axes(dp_axes(mesh))
    tp = TP_AXIS if TP_AXIS in mesh.axis_names else None

    def spec_for(names, leaf):
        name = names[-1] if names else ""
        nd = leaf.dim()
        # strip stacked leading dims before shape-aware rules
        base_probe = _base_spec(cfg, names, name, fsdp, tp)
        trail = (tuple(leaf.shape[nd - len(base_probe):])
                 if nd >= len(base_probe) else tuple(leaf.shape))
        base = _base_spec(cfg, names, name, fsdp, tp, shape=trail, mesh=mesh)
        extra = nd - len(base)
        if extra < 0:                    # scalar against () etc.
            return ()
        full = (None,) * extra + base
        # drop axes that don't divide the dim (e.g. tiny reduced configs)
        return tuple(ax if ax is None or dim % axes_size(ax, mesh) == 0
                     else None for dim, ax in zip(leaf.shape, full))

    return map_with_names(spec_for, params_tree)


def _dp_if_divisible(b: int, mesh):
    fsdp = dp_axes(mesh)
    size = axes_size(fsdp, mesh)
    return norm_axes(fsdp) if (b % size == 0 and b >= size) else None


def cache_pspecs(cfg: ModelConfig, cache_tree, mesh, batch: int):
    """Decode cache/state sharding: batch over FSDP, seq/width over TP.

    ``batch`` disambiguates the batch dim (caches may carry a leading
    stacked-layer dim).
    """
    tp = TP_AXIS if TP_AXIS in mesh.axis_names else None
    tp_size = mesh.shape[tp] if tp else 1

    def divis(dim: int) -> bool:
        return bool(tp) and dim % tp_size == 0 and dim >= tp_size

    def spec_for(names, leaf):
        name = names[-1] if names else ""
        nd = leaf.dim()
        shape = tuple(leaf.shape)
        spec = [None] * nd
        # locate the batch dim (0 or 1 depending on stacking)
        bidx = None
        for i in range(min(2, nd)):
            if shape[i] == batch and (i == 0 or shape[0] != batch):
                bidx = i
                break
        if bidx is None and nd >= 2 and shape[0] == batch:
            bidx = 0
        if bidx is not None:
            spec[bidx] = _dp_if_divisible(batch, mesh)
        kv_names = ("k", "v", "xk", "xv",
                    "codes_k", "codes_v", "signs_k", "signs_v",
                    "scale_k", "scale_v")
        if name in kv_names and nd >= 4 and bidx is not None:
            t = shape[bidx + 1]          # sequence-parallel KV (raw OR
            if divis(t):                 # pwrel-compressed leaves)
                spec[bidx + 1] = tp
        elif name in ("h", "c", "n", "m", "conv") and nd >= 2:
            if divis(shape[-1]):
                spec[-1] = tp            # state width over TP
        # "C" (hd x hd matrix memory) stays replicated over TP
        return tuple(spec)

    return map_with_names(spec_for, cache_tree)


def batch_pspecs(cfg: ModelConfig, specs: dict, mesh):
    """Specs for an input_specs dict (tokens/aux/frames/token/cache/pos)."""
    batch = next(v.shape[0] for k, v in specs.items()
                 if k in ("tokens", "token", "frames"))
    out = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = cache_pspecs(cfg, v, mesh, batch)
        elif k == "pos":
            out[k] = ()
        else:
            dp = _dp_if_divisible(v.shape[0], mesh)
            out[k] = (dp,) + (None,) * (v.dim() - 1)
    return out


def shard_shape(shape, spec: tuple, mesh) -> tuple[int, ...]:
    """One device's block of a tensor of ``shape`` under ``spec``: each
    dim over the devices of its axes, rounded up (a dim the axes do not
    divide is padded to a whole block, as a sharded array's is); dims
    past the spec's are whole."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(math.ceil(d / axes_size(ax, mesh))
                 for d, ax in zip(shape, spec))


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors, e.g. on ``meta``)
    sharded by the spec tree ``specs``."""
    return sum(math.prod(shard_shape(tuple(t.shape), s, mesh))
               * t.element_size()
               for t, s in spec_leaves(tree, specs)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# sharded execution: a rank's blocks
# ---------------------------------------------------------------------------

#: leaves split over ``model`` by the rules above, which a tensor-parallel
#: step cannot run whole
_TP_LEAVES = {"embed", "unembed", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
              "w_in", "w_gate", "w_out"}

#: replicated leaves that act on a rank's heads only (qk-norm), so their
#: gradients are partial over ``model`` as well as over ``data``
PARTIAL_OVER_MODEL = ("q_norm", "k_norm")


def named_specs(tree, specs, names: tuple = ()):
    """(names, leaf, spec) of each leaf of ``tree`` and its spec tree,
    ``names`` the dict keys on the way to the leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_specs(v, specs[k], names + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            yield from named_specs(v, s, names)
    else:
        yield names, tree, specs


def fsdp_dim(spec) -> int | None:
    """The dim a spec shards over ``data`` (None: the leaf is not
    FSDP-sharded)."""
    for i, ax in enumerate(spec):
        if ax == "data" or (isinstance(ax, tuple) and "data" in ax):
            return i
    return None


def _axis_index(ax, mesh, coords) -> int:
    """A rank's block index along a spec entry's axes (the first axis
    major, as JAX orders a tuple of mesh axes)."""
    idx = 0
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        i = mesh.axis_names.index(a)
        idx = idx * mesh.sizes[i] + coords[i]
    return idx


def local_block(tensor: torch.Tensor, spec: tuple, mesh,
                coords=None) -> torch.Tensor:
    """The block of ``tensor`` that the rank at ``coords`` (default: the
    mesh view's own) holds under ``spec``, as a new contiguous tensor of
    :func:`shard_shape`'s shape; where the axes do not divide a dim, the
    last blocks are zero-padded."""
    coords = mesh.coords if coords is None else tuple(coords)
    shape = shard_shape(tuple(tensor.shape), spec, mesh)
    full = tuple(spec) + (None,) * (tensor.dim() - len(spec))
    view = tensor
    for dim, (ax, n) in enumerate(zip(full, shape)):
        if ax is None:
            continue
        start = min(_axis_index(ax, mesh, coords) * n, tensor.shape[dim])
        view = view.narrow(dim, start, min(n, tensor.shape[dim] - start))
    if tuple(view.shape) == shape:
        return view.clone(memory_format=torch.contiguous_format)
    out = torch.zeros(shape, dtype=tensor.dtype, device=tensor.device)
    out[tuple(slice(0, k) for k in view.shape)] = view
    return out


def shard_tree(tree, specs, mesh, coords=None):
    """:func:`local_block` of every leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, coords)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, mesh, coords)
                          for v, s in zip(tree, specs))
    return local_block(tree, specs, mesh, coords)


def gather_leaf(block: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor of a block under ``spec`` on every rank of ``mesh``
    (a rank's view): one all-gather of every rank's block over the world,
    not counted among the step's collectives."""
    from .collectives import all_gather
    full_spec = tuple(spec) + (None,) * (block.dim() - len(spec))
    if all(ax is None for ax in full_spec):
        return block
    parts = all_gather(block.reshape(1, -1), mesh, None, count=False)
    shape = tuple(n * axes_size(ax, mesh)
                  for n, ax in zip(block.shape, full_spec))
    out = torch.empty(shape, dtype=block.dtype, device=block.device)
    for r in range(mesh.size):
        c = mesh.coords_of(r)
        idx = tuple(slice(None) if ax is None else
                    slice(_axis_index(ax, mesh, c) * n,
                          (_axis_index(ax, mesh, c) + 1) * n)
                    for n, ax in zip(block.shape, full_spec))
        out[idx] = parts[r].view(block.shape)
    return out


def gather_tree(tree, specs, mesh):
    """The full leaves of a tree of blocks on every rank of ``mesh`` (a
    rank's view), one leaf at a time over the world; for specs whose axes
    divide their dims, as ``param_pspecs``' do.  Not counted among the
    step's collectives."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    return gather_leaf(tree, specs, mesh)


def train_state_pspecs(state, p_specs):
    """Spec tree of a train state (``train.step.init_train_state``'s):
    AdamW's moments and the gradient compressor's residuals sharded as the
    parameters, ``step`` replicated.  Adafactor's factored moments need
    row and column sums across shards: not on a mesh yet (ROADMAP
    A12h-b)."""
    opt = state["opt"]
    if set(opt) != {"m", "v", "step"}:
        raise NotImplementedError(
            "Adafactor's factored moments across shards are not ported yet "
            "(ROADMAP A12h-b); a mesh larger than 1x1 trains with AdamW")
    out = {"opt": {"m": p_specs, "v": p_specs, "step": ()}}
    if "gc_err" in state:
        out["gc_err"] = p_specs
    return out


def check_shardable(cfg: ModelConfig, mesh, params_tree=None,
                    specs=None) -> None:
    """Raise for what a mesh larger than 1x1 does not run yet
    (``NotImplementedError`` naming ROADMAP A12h-b: a family other than
    ``dense``, kv heads that ``model`` does not divide, sequence-parallel
    attention), and ``ValueError`` for a mesh other than ("data",
    "model") or a tensor-parallel leaf whose ``model`` axis the rules
    dropped (it names the leaf; checked where ``params_tree`` and its
    ``specs`` are given)."""
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(f"sharded execution runs on a (data, model) host "
                         f"mesh, got axes {mesh.axis_names}")
    tp = mesh.shape[TP_AXIS]
    todo = "is not ported yet (ROADMAP A12h-b)"
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: sharded execution of the {cfg.family} family "
            f"{todo}; the dense family runs on a mesh")
    if cfg.n_kv_heads % tp:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_kv_heads} kv heads over model {tp} (GSPMD "
            f"replicates the scores) {todo}")
    if cfg.seq_parallel_attn:
        raise NotImplementedError(
            f"{cfg.name}: seq_parallel_attn on a mesh {todo}")
    if tp == 1 or params_tree is None:
        return
    for names, _, spec in named_specs(params_tree, specs):
        if names and names[-1] in _TP_LEAVES and TP_AXIS not in spec:
            raise ValueError(
                f"{cfg.name}: leaf {'/'.join(names)} cannot run tensor-"
                f"parallel: the rules dropped its model axis (spec {spec}: "
                f"model {tp} does not divide its dims)")
