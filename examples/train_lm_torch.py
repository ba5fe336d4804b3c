"""Train an LM on the PyTorch/CUDA port: any assigned --arch at reduced
size (default) or full config, with checkpoints, restart-after-failure,
and optional error-bounded gradient compression.  The port's counterpart
of ``examples/train_lm.py``, which runs the step under ``jax.jit``.

    PYTHONPATH=src python examples/train_lm_torch.py --arch xlstm-125m \\
        --steps 100 [--full] [--grad-compress] [--fail-at 30] \\
        [--device cuda]
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.devices import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, GradCompressor
from repro_torch.train.data import SyntheticTokens
from repro_torch.train.runtime import RuntimeConfig, TrainRuntime
from repro_torch.train.step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="full assigned config")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (restart demo)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg)
    cfg = cfg.with_(remat=False)
    params = T.init_params(cfg, 0, device=dev)
    opt = AdamW(lr=3e-3)
    gc = GradCompressor(1e-2) if args.grad_compress else None
    state = init_train_state(cfg, params, opt, gc)
    step_fn = make_train_step(cfg, opt, gc)
    src = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)

    rt = TrainRuntime(
        cfg=RuntimeConfig(ckpt_dir=args.ckpt_dir, ckpt_every=25,
                          fail_at_step=args.fail_at),
        train_step=step_fn, data_source=src, device=dev)
    params, state, hist = rt.run(params, state, n_steps=args.steps)
    for m in hist[:: max(1, len(hist) // 10)]:
        print(f"step {m['step']:4d} loss {m['loss']:.4f} "
              f"({m['step_time']*1e3:.0f} ms, restarts={m['restarts']})")
    print(f"final loss {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
