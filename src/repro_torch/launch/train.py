"""Train launcher: one device, or FSDP x TP over a host mesh; the
fault-tolerant loop.

The port of ``repro.launch.train``: random weights from seed 0, the
config's optimizer (lr 3e-3, its moment dtype), optional error-bounded
gradient compression, synthetic tokens, checkpoints every 25 steps through
``TrainRuntime``; it prints ``repro``'s ``[train]`` line.  It runs on
``--device`` (default ``cuda:0``; ``cpu`` runs every kernel's plain
version).

``--mesh DxM`` other than 1x1 starts D x M ranks (``torch.multiprocessing``,
``distributed.collectives.run_ranks``), each holding its blocks of the
parameters and optimizer state under ``distributed/sharding.py``'s rules
and its rows of the batch, and running ``make_train_step(..., mesh=...)``:
with ``--device`` every rank on that device (``cpu``: gloo; a card: the
ranks share it over gloo), by default one visible card a rank over NCCL
(fewer cards than D x M raise ``ValueError``).  Rank 0's losses make the
printed line.  A mesh runs the dense family with AdamW; the rest raises
naming ROADMAP A12h-b.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --steps 50 [--mesh 2x2] [--full] [--grad-compress] [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from ..configs import get_config, reduced_config
from ..core.devices import resolve_device
from ..distributed.collectives import RANK_TIMEOUT_S, run_ranks
from ..distributed.sharding import (param_pspecs, shard_tree,
                                    train_state_pspecs)
from ..models import transformer as T
from ..optim import GradCompressor, make_optimizer
from ..train.data import BatchRows, SyntheticTokens
from ..train.runtime import RuntimeConfig, TrainRuntime
from ..train.step import init_train_state, make_train_step
from .mesh import make_host_mesh


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0, on a mesh one card "
                         "a rank; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    try:
        d, m = (int(x) for x in args.mesh.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {args.mesh!r}: want DATAxMODEL, e.g. "
                         "2x2") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {args.mesh!r}: both sizes must be >= 1")
    return args, (d, m)


def _config(args):
    cfg = get_config(args.arch)
    return cfg if args.full else reduced_config(cfg)


def _optimizers(cfg, args):
    opt = make_optimizer(cfg.optimizer, 3e-3,
                         moment_dtype=cfg.opt_state_dtype)
    gc = GradCompressor(1e-2) if args.grad_compress else None
    return opt, gc


def setup(argv=None):
    """Parse ``argv`` and build the one-device run on its device: returns
    (args, params, state, train step, token source, device)."""
    args, shape = _parse(argv)
    if shape != (1, 1):
        raise ValueError(f"setup builds the one-device run; --mesh "
                         f"{args.mesh} runs through main")
    dev = resolve_device(args.device)
    cfg = _config(args)
    params = T.init_params(cfg, 0, device=dev)
    opt, gc = _optimizers(cfg, args)
    state = init_train_state(cfg, params, opt, gc)
    step_fn = make_train_step(cfg, opt, gc)
    src = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    return args, params, state, step_fn, src, dev


def _train_rank(view, a: dict):
    """One rank of a mesh run: its blocks of seed 0's weights, its rows of
    the batch, the runtime's loop; rank 0 returns the metrics."""
    args = argparse.Namespace(**a)
    cfg = _config(args)
    full = T.init_params(cfg, 0, device=view.device)
    specs = param_pspecs(cfg, full, view)
    params = shard_tree(full, specs, view)
    del full
    opt, gc = _optimizers(cfg, args)
    state = init_train_state(cfg, params, opt, gc)
    src = BatchRows(SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch),
                    view.shape["data"], view.index("data"))
    rt = TrainRuntime(cfg=RuntimeConfig(ckpt_dir=args.ckpt_dir,
                                        ckpt_every=25),
                      train_step=make_train_step(cfg, opt, gc, mesh=view),
                      data_source=src, device=view.device, mesh=view,
                      specs=(specs, train_state_pspecs(state, specs)))
    _, _, hist = rt.run(params, state, n_steps=args.steps)
    return hist if view.rank == 0 else None


def _run_mesh(args, shape) -> list:
    if args.device is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        dev = torch.device(args.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        devices = [dev] * (shape[0] * shape[1])
    mesh = make_host_mesh(*shape, devices=devices)
    cfg = _config(args)
    if args.batch % shape[0]:
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"{shape[0]} data ranks")
    # what a mesh does not run raises here, before any rank starts
    make_train_step(cfg, *_optimizers(cfg, args), mesh=mesh.at(0))
    return run_ranks(_train_rank, mesh, args=(vars(args),),
                     timeout=RANK_TIMEOUT_S)[0]


def main(argv=None):
    args, shape = _parse(argv)
    if shape == (1, 1):
        args, params, state, step_fn, src, dev = setup(argv)
        rt = TrainRuntime(cfg=RuntimeConfig(ckpt_dir=args.ckpt_dir,
                                            ckpt_every=25),
                          train_step=step_fn, data_source=src, device=dev)
        params, state, hist = rt.run(params, state, n_steps=args.steps)
    else:
        hist = _run_mesh(args, shape)
    losses = [m_["loss"] for m_ in hist]
    print(f"[train] {args.arch} mesh={args.mesh}: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({np.mean([m_['step_time'] for m_ in hist])*1e3:.0f} ms/step)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
