"""Train launcher: one device, the fault-tolerant loop.

The port of ``repro.launch.train``: random weights from seed 0, the
config's optimizer (lr 3e-3, its moment dtype), optional error-bounded
gradient compression, synthetic tokens, checkpoints every 25 steps through
``TrainRuntime``; it prints ``repro``'s ``[train]`` line.  It runs on
``--device`` (default ``cuda:0``; ``cpu`` runs every kernel's plain
version).  ``--mesh`` takes ``1x1`` only: the sharding rules and the mesh
are ported (``distributed/sharding.py``, ``launch/mesh.py``; the dry run
reads them), but running a step sharded over a mesh, FSDP x TP by hand, is
not (ROADMAP A12h).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --steps 50 [--full] [--grad-compress] [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from ..configs import get_config, reduced_config
from ..core.devices import resolve_device
from ..models import transformer as T
from ..optim import GradCompressor, make_optimizer
from ..train.data import SyntheticTokens
from ..train.runtime import RuntimeConfig, TrainRuntime
from ..train.step import init_train_state, make_train_step


def setup(argv=None):
    """Parse ``argv`` and build the run on its device: returns (args,
    params, state, train step, token source, device)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL (1x1 only)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded execution over a device mesh is "
            "not ported yet (ROADMAP A12h: sharded execution over a host "
            "mesh); the port trains on one device (--mesh 1x1)")
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg)
    params = T.init_params(cfg, 0, device=dev)
    opt = make_optimizer(cfg.optimizer, 3e-3,
                         moment_dtype=cfg.opt_state_dtype)
    gc = GradCompressor(1e-2) if args.grad_compress else None
    state = init_train_state(cfg, params, opt, gc)
    step_fn = make_train_step(cfg, opt, gc)
    src = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    return args, params, state, step_fn, src, dev


def main(argv=None):
    args, params, state, step_fn, src, dev = setup(argv)
    rt = TrainRuntime(cfg=RuntimeConfig(ckpt_dir=args.ckpt_dir,
                                        ckpt_every=25),
                      train_step=step_fn, data_source=src, device=dev)
    params, state, hist = rt.run(params, state, n_steps=args.steps)
    losses = [m_["loss"] for m_ in hist]
    print(f"[train] {args.arch} mesh={args.mesh}: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({np.mean([m_['step_time'] for m_ in hist])*1e3:.0f} ms/step)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
