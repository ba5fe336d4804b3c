"""Collectives of a host mesh over ``torch.distributed``: the port's own
layer under sharded execution of a model step (torch has no GSPMD, so the
collectives XLA would insert are called by hand).

* **Process groups.**  :func:`init_rank` joins one rank of a
  ``launch.mesh.MeshSpec`` to its world (``init_method="file://..."``, so
  concurrent meshes on one host never race for a port) and makes one
  group along each axis for every line of the mesh, every rank making
  every group in one order; the rank keeps its own (its ``data`` group
  holds the ranks of its model index, its ``model`` group those of its
  data index).  :func:`run_ranks` starts one spawned process a rank, each
  with a deadline.
* **The wire follows from the mesh's devices.**  One card a rank: NCCL.
  CPU ranks, or several ranks on one card (NCCL refuses two ranks on one
  GPU): gloo, with each CUDA tensor copied to the host and back around the
  call.  This is the choice of wire, not a fallback: a failed init raises.
* **Collectives by kind**, each adding its bytes to
  :data:`collective_counts` under ``launch/dryrun.py::collective_bytes``'
  conventions: an all-gather counts the gathered block, a reduce-scatter
  its output block, an all-reduce the tensor; and its host-clock seconds,
  the wire's copies included, to :data:`collective_seconds` (a gloo call
  returns when it is done, so that is its time; an NCCL call returns once
  queued).  A call over a group of one rank moves nothing, counts nothing
  and returns its input.
* **Three ``torch.autograd.Function``s**: the FSDP gather (all-gather over
  ``data`` forward, reduce-scatter with a sum backward), Megatron's *f*
  (identity forward, all-reduce over ``model`` backward) and *g*
  (all-reduce over ``model`` forward, identity backward).
* :class:`Parallel` is what one rank's model code reads of the mesh: its
  local head counts, its vocab block, the FSDP gather of a parameter
  tree, *f* and *g*.
"""
from __future__ import annotations

import io
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .sharding import fsdp_dim

__all__ = ["KINDS", "collective_counts", "collective_seconds",
           "reset_counts", "read_counts", "read_seconds",
           "backend_for", "init_rank", "destroy", "all_gather",
           "reduce_scatter", "all_reduce", "barrier", "FSDPGather",
           "CopyToModel", "ReduceFromModel", "Parallel", "run_ranks",
           "RANK_TIMEOUT_S"]

KINDS = ("all-gather", "reduce-scatter", "all-reduce")

#: bytes by collective kind since the last :func:`reset_counts`
collective_counts: dict[str, int] = dict.fromkeys(KINDS, 0)
#: host seconds in counted collectives by kind since :func:`reset_counts`
collective_seconds: dict[str, float] = dict.fromkeys(KINDS, 0.0)

#: the most a spawned mesh may take before its ranks are killed
RANK_TIMEOUT_S = 1800.0

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# all_gather_single / reduce_scatter_single are the names newer torch
# gives these calls (same arguments)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def reset_counts() -> None:
    for k in KINDS:
        collective_counts[k] = 0
        collective_seconds[k] = 0.0


def read_counts() -> dict:
    """The counts by kind and their ``total``."""
    out = dict(collective_counts)
    out["total"] = sum(out.values())
    return out


def read_seconds() -> dict:
    """The seconds by kind and their ``total``."""
    out = dict(collective_seconds)
    out["total"] = sum(out.values())
    return out


def _count(kind: str, t: torch.Tensor, count: bool, t0: float) -> None:
    if count:
        collective_counts[kind] += t.numel() * t.element_size()
        collective_seconds[kind] += time.perf_counter() - t0


def backend_for(devices) -> str:
    """``"nccl"`` when every rank has a card of its own, ``"gloo"`` for CPU
    ranks or ranks that share a card; a mesh mixing CPU and CUDA ranks
    raises ``ValueError``."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"a mesh's ranks must all be CUDA cards or all "
                         f"the CPU, got {sorted(str(d) for d in devs)}")
    if kinds == {"cuda"} and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def init_rank(mesh, rank: int, init_file: str):
    """Join ``rank`` of ``mesh`` to its world through ``init_file`` (a
    path that no earlier world used) and return its view
    (``MeshSpec.at``): its coordinates and its group along each axis.
    The wire is checked by one all-reduce over the world, not counted."""
    backend = backend_for(mesh.devices)
    dev = torch.device(mesh.devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # a host mesh's ranks are processes of one host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=mesh.size, rank=rank)
    mine = {}
    for a, axis in enumerate(mesh.axis_names):
        for r in range(mesh.size):
            c = mesh.coords_of(r)
            if c[a]:
                continue
            ranks = [mesh.rank_of(c[:a] + (i,) + c[a + 1:])
                     for i in range(mesh.sizes[a])]
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[axis] = group
    view = mesh.at(rank, tuple(mine[a] for a in mesh.axis_names))
    # the wire's check, also in a world of one rank
    probe = torch.zeros(1, device=dev if backend == "nccl" else "cpu")
    dist.all_reduce(probe)
    return view


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _group_size(mesh, axis) -> int:
    return mesh.size if axis is None else mesh.shape[axis]


def _group(mesh, axis):
    return None if axis is None else mesh.group(axis)


def _start(t: torch.Tensor) -> float:
    """The host clock at a collective's start.  A CUDA tensor bound for
    gloo waits for its stream first (its host copy would anyway), so the
    time counted is the collective's, not the work queued before it."""
    if t.is_cuda and dist.get_backend() == "gloo":
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the wire takes it: gloo moves host memory, so a CUDA
    tensor goes through a host copy."""
    if t.is_cuda and dist.get_backend() == "gloo":
        return t.to("cpu")
    return t


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0,
               count: bool = True) -> torch.Tensor:
    """The blocks of ``axis``' group concatenated along ``dim``, in rank
    order (contiguous)."""
    n = _group_size(mesh, axis)
    if n == 1:
        return t
    t0 = _start(t)
    x = _to_wire(t.movedim(dim, 0).contiguous())
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _ALL_GATHER(out, x, group=_group(mesh, axis))
    res = out.to(t.device).movedim(0, dim).contiguous()
    _count("all-gather", out, count, t0)
    return res


def reduce_scatter(t: torch.Tensor, mesh, axis: str,
                   dim: int = 0) -> torch.Tensor:
    """The sum over ``axis``' group of ``t``, this rank's block of it
    along ``dim`` (contiguous)."""
    n = _group_size(mesh, axis)
    if n == 1:
        return t
    t0 = _start(t)
    x = _to_wire(t.movedim(dim, 0).contiguous())
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _REDUCE_SCATTER(out, x, op=dist.ReduceOp.SUM, group=_group(mesh, axis))
    res = out.to(t.device).movedim(0, dim).contiguous()
    _count("reduce-scatter", out, True, t0)
    return res


def all_reduce(t: torch.Tensor, mesh, axis: str | None = None,
               op: str = "sum", count: bool = True) -> torch.Tensor:
    """``op`` ("sum" or "max") of ``t`` over ``axis``' group (None: the
    world), as a new tensor."""
    if _group_size(mesh, axis) == 1:
        return t
    t0 = _start(t)
    x = _to_wire(t)
    x = (x.clone(memory_format=torch.contiguous_format) if x is t
         else x.contiguous())
    dist.all_reduce(x, op=_OPS[op], group=_group(mesh, axis))
    res = x.to(t.device)
    _count("all-reduce", t, count, t0)
    return res


def barrier(mesh) -> None:
    """Every rank of ``mesh`` reaches this line before any goes on (an
    all-reduce of one element, not counted)."""
    all_reduce(torch.zeros(1, device=mesh.device), mesh, count=False)


class FSDPGather(torch.autograd.Function):
    """A parameter's block gathered over ``data`` along ``dim`` (forward);
    its gradient summed over ``data`` and scattered back to the block
    (backward)."""

    @staticmethod
    def forward(ctx, block, mesh, dim: int):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(block, mesh, "data", dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.mesh, "data", ctx.dim), None, None


class CopyToModel(torch.autograd.Function):
    """Megatron's *f*: the identity forward; the gradient all-reduced over
    ``model`` backward (each rank's heads or columns gave part of it)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh, "model"), None


class ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: the partial sums of each rank all-reduced over
    ``model`` forward; the gradient passed through backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh, "model")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


class Parallel:
    """One rank's model-side view of a ("data", "model") mesh: ``specs``
    is the parameter spec tree (``sharding.param_pspecs`` of the full
    tree), ``mesh`` the rank's view.  On ``model`` the rank holds
    ``n_heads / tp`` query and ``n_kv_heads / tp`` kv heads, ``d_ff / tp``
    MLP columns and ``vocab / tp`` embedding rows, from its model index
    up."""

    def __init__(self, mesh, specs):
        self.mesh, self.specs = mesh, specs
        self.tp = mesh.shape.get("model", 1)
        self.dp = mesh.shape.get("data", 1)
        self.tp_index = mesh.index("model")

    def local_cfg(self, cfg):
        """``cfg`` at this rank's head counts, ``head_dim`` pinned (a
        config's hd is d_model // n_heads where head_dim is 0)."""
        if self.tp == 1:
            return cfg
        return cfg.with_(n_heads=cfg.n_heads // self.tp,
                         n_kv_heads=cfg.n_kv_heads // self.tp,
                         head_dim=cfg.hd)

    def gather(self, tree, specs):
        """Each leaf of ``tree`` (blocks under ``specs``) through the FSDP
        gather where its spec has ``data``: the leaves the layer code
        reads, still split over ``model``."""
        def one(leaf, spec):
            dim = fsdp_dim(spec)
            if dim is None or self.dp == 1:
                return leaf
            return FSDPGather.apply(leaf, self.mesh, dim)
        return _map(one, tree, specs)

    def gather_top(self, params):
        """The leaves outside the layers (embeddings, final norm),
        gathered."""
        top = {k: v for k, v in params.items() if k not in ("units", "rem")}
        return self.gather(top, {k: self.specs[k] for k in top})

    def gather_unit(self, i: int, unit):
        """Pattern position ``i``'s leaves of one unit (views of the
        stacked blocks), gathered: their specs less the stacked axis."""
        return self.gather(unit, _map(lambda _, s: tuple(s[1:]), unit,
                                      self.specs["units"][i]))

    def gather_rem(self, i: int, prm):
        return self.gather(prm, self.specs["rem"][i])

    def f(self, x):
        return x if self.tp == 1 else CopyToModel.apply(x, self.mesh)

    def g(self, x):
        return x if self.tp == 1 else ReduceFromModel.apply(x, self.mesh)

    def max_model(self, x):
        """The elementwise max over ``model`` of a tensor that takes no
        gradient."""
        return all_reduce(x.detach(), self.mesh, "model", op="max")


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _rank_entry(rank: int, fn, mesh, tmp: str, queue) -> None:
    view = init_rank(mesh, rank, os.path.join(tmp, "rendezvous"))
    try:
        if view.device.type == "cpu":   # the ranks share the host's cores
            torch.set_num_threads(1)
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
        out = fn(view, *args)
        queue.put((rank, _dumps(out)))
    finally:
        destroy()


def run_ranks(fn, mesh, args: tuple = (),
              timeout: float = RANK_TIMEOUT_S) -> list:
    """``fn(view, *args)`` in one spawned process a rank of ``mesh``, each
    joined to the mesh's world first (:func:`init_rank`); returns what each
    rank's ``fn`` returned (through ``torch.save``), by rank.  ``fn``
    must be importable by name.  ``args`` reach the ranks through a file
    (a spawned process is started only once it has read what it was
    handed, so large arguments there would start the ranks one by one).
    A rank that raises ends every rank and raises here; so does the
    deadline ``timeout`` (``TimeoutError``)."""
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    queue = mp.get_context("spawn").SimpleQueue()
    results: dict[int, object] = {}
    try:
        torch.save(tuple(args), os.path.join(tmp, "args.pt"))
        procs = mp.start_processes(
            _rank_entry, args=(fn, mesh, tmp, queue),
            nprocs=mesh.size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout

        def drain():
            while not queue.empty():
                rank, blob = queue.get()
                results[rank] = torch.load(io.BytesIO(blob),
                                           weights_only=False)
        try:
            while not procs.join(timeout=0.2):
                drain()
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"mesh {mesh.sizes}: ranks still running after "
                        f"{timeout:.0f} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        drain()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(mesh.size)]
