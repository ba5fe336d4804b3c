"""Serve a small LM with batched requests on the PyTorch/CUDA port:
prefill + decode loop, with optional pwrel-compressed KV cache, the decode
step captured as one CUDA graph (``--eager`` runs it op by op).  The port's
counterpart of ``examples/serve_lm.py``, which runs the step under
``jax.jit``.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen3-4b \\
        --batch 4 --prompt-len 32 --gen 16 [--compressed-kv] [--eager] \\
        [--device cuda]

The captured step needs a CUDA device; on ``--device cpu`` pass
``--eager``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import transformer as T
from repro_torch.serving import CapturedDecodeStep, make_decode_step
from repro_torch.serving.kvcache import (compress_prefill_cache,
                                         make_compressed_decode_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--compressed-kv", action="store_true")
    ap.add_argument("--eager", action="store_true",
                    help="run the decode step op by op, not as a CUDA graph")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda" and not args.eager:
        ap.error("the captured decode step needs a CUDA device: pass --eager")

    cfg = reduced_config(get_config(args.arch))
    params = T.init_params(cfg, 0, device=dev)
    max_len = args.prompt_len + args.gen
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (args.batch, args.prompt_len))).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    logits, cache = T.forward_prefill(cfg, params, prompts, max_len=max_len)
    decode = make_decode_step(cfg)
    if args.compressed_kv:
        cache = compress_prefill_cache(cache)
        decode = make_compressed_decode_step(cfg)
        nbytes = sum(x.numel() * x.element_size() for c in cache["units"]
                     for x in c.values())
        print(f"compressed KV cache: {nbytes/2**20:.2f} MiB")
    sync()
    t_prefill = time.perf_counter() - t0

    if args.eager:
        def step(tok, pos):
            return decode(params, {"token": tok, "cache": cache,
                                   "pos": pos})[0]
    else:
        step = CapturedDecodeStep(cfg, decode, params, cache)
    tok = logits.argmax(-1)[:, None]
    outs = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen):
        logits = step(tok, args.prompt_len + i)
        tok = logits.argmax(-1)[:, None]
        outs.append(tok)
    sync()
    t_dec = time.perf_counter() - t0

    gen = torch.cat(outs, 1)
    mode = "eager" if args.eager else "captured"
    print(f"arch {cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"device={dev} step={mode}")
    print(f"prefill {t_prefill*1e3:.0f} ms | "
          f"decode {t_dec/args.gen*1e3:.1f} ms/tok "
          f"({args.batch*args.gen/t_dec:.1f} tok/s)")
    print("generated token ids, request 0:", gen[0].tolist())


if __name__ == "__main__":
    main()
