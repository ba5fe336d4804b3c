"""Multi-pod dry run without JAX: every assigned (architecture x input
shape) cell on the production meshes, from the port's sharding rules and
one run of the cell's step on the ``meta`` device.

The port of ``repro/launch/dryrun.py``, with its CLI and ``VARIANTS``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k [--multi-pod] [--compressed-kv] [--variant V] \\
        [--out out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Per cell it builds the parameters, optimizer state and inputs at full size
on ``meta`` (shapes and dtypes, no storage: it touches no device and
needs no card) and writes one JSON record.

Equal to ``repro``'s (the CPU tests hold them): applicability and skip
reasons; ``model_flops`` (6·N·D train, 2·N·D prefill and decode, N the
active parameters); the partition specs of parameters, optimizer state,
inputs and caches (``distributed/sharding.py``: ``repro``'s rules, specs as
tuples); and, from those trees, the bytes each device holds of each
(``bytes_per_device``: ``params``, ``opt_state``, ``inputs``, ``cache`` and
their sum ``argument``).

The port's own, and labelled so in the record (``repro`` reads them from
an XLA compile that torch has no counterpart for):

* ``counted_flops``: what ``torch.utils.flop_counter.FlopCounterMode``
  counts over one run of the cell's step on ``meta`` at the global batch,
  through the kernels' plain versions (a hand kernel runs on a card, not on
  ``meta``), remat recompute and backward included; the sLSTM's time loop
  runs as one product over its steps, the same products as the loop
  (forward, dR at every step, dh at every step but the first), because the
  loop of 4,096–32,768 steps takes minutes on ``meta``.
  ``useful_flops_ratio`` = ``model_flops / counted_flops``.
* ``collective_bytes`` by kind, one device's bytes a step (each
  collective's output on that device, as ``repro`` sums them from HLO),
  from the sharding rules' own arithmetic.  With ``dp`` the FSDP axes' size,
  ``tp`` the ``model`` axis', a leaf's *block* its bytes under its spec and
  ``passes`` = 1 for prefill and decode, 3 for a remat train step
  (forward, recompute, backward), 2 without remat:

  - all-gather: every weight with an FSDP axis in its spec, gathered over
    those axes (still split over ``model``) for the forward pass and, in a
    remat train step, again for the recompute;
  - reduce-scatter (train): each such weight's gradient, its block;
  - all-reduce (train): the gradient block of every weight without an FSDP
    axis, when dp > 1;
  - all-reduce, each pass, when tp > 1: one row-parallel activation
    (B/dp, S, d) for each attention (self or cross; an RG-LRU or xLSTM
    mixer in its place) and each MLP or MoE output; and inside attention,
    for self-attention with ``seq_parallel_attn`` the f32 max and sum
    stats (B/dp, Hq, S) and one activation (B/dp, S, Hq·hd), otherwise,
    where the kv heads do not split whole over ``model`` (G % tp != 0), the
    f32 scores (B/dp, Hq, S, T), T the keys (2W for a banded window
    layer); a decode step reads a sequence-parallel cache, so each of its
    attention layers pays the stats and one activation.

  Not counted: the MoE dispatch's all-to-all (expert-parallel expert
  weights count as gathered, as every FSDP leaf does), the vocab-parallel
  logits' softmax stats, pipeline or optimizer-state traffic.
* the roofline terms, from one NVIDIA H100 80GB HBM3's data-sheet rates
  (below): ``compute_s`` = counted_flops / chips / 989e12, ``memory_s`` =
  each device's argument bytes read once and its output bytes written once
  (train: parameters and optimizer state; prefill: logits and cache;
  decode: logits; its cache is written in place, one token a layer, not
  counted) over 3.35e12 B/s,
  ``collective_s`` = collective bytes over 450e9 B/s (NVLink, one
  direction), ``bottleneck`` the largest.  No TPU constant is kept.

Left out: ``repro``'s ``temp`` and ``peak`` bytes and its ``hlo_*`` FLOPs
and bytes, which only an XLA compile of the sharded program gives; the
port has no sharded compile to read them from (sharded execution is ROADMAP
A12h).  ``--unroll`` is accepted and changes nothing: the port's layers
are a Python loop, and the counter sees every unit.  It never sets
``XLA_FLAGS`` and imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ALIASES, get_config
from ..configs.shapes import (META, SHAPES, cell_is_applicable, input_specs,
                              skip_reason, step_kind)
from ..distributed.sharding import (TP_AXIS, axes_size, batch_pspecs,
                                    cache_pspecs, dp_axes, map_with_names,
                                    norm_axes, param_pspecs, shard_bytes,
                                    shard_shape, spec_leaves)
from ..kernels import ref
from ..models import attention as A
from ..models import encdec as E
from ..models import transformer as T
from ..models import xlstm as X
from ..optim import make_optimizer
from ..serving import kvcache as KV
from ..serving.step import make_decode_step, make_prefill_step
from ..train.step import init_train_state, make_train_step
from .mesh import make_production_mesh

__all__ = ["VARIANTS", "PEAK_FLOPS", "HBM_BW", "LINK_BW", "DEVICE",
           "model_flops", "abstract_params", "build_cell",
           "collective_bytes", "counted_flops", "run_cell", "main"]

# NVIDIA H100 80GB HBM3 (SXM), NVIDIA's data sheet, at its 700 W limit
DEVICE = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s a card
HBM_BW = 3.35e12             # bytes/s a card
LINK_BW = 450e9              # NVLink bytes/s a card, one direction
_ACT_BYTES = 2               # bf16 activations

# hillclimb variants: config overrides per name (repro's, as they are)
VARIANTS = {
    "baseline": {},
    "seqattn": {"seq_parallel_attn": True},
    "banded": {"banded_local_attn": True},
    "banded+seqattn": {"banded_local_attn": True, "seq_parallel_attn": True},
    "optbf16": {"opt_state_dtype": "bfloat16"},
    "noremat": {"remat": False},
    "adafactor": {"optimizer": "adafactor"},
}


def abstract_params(cfg):
    init = E.init_encdec_params if cfg.family == "audio" else T.init_params
    return init(cfg, device=META)


def model_flops(cfg, shape_name: str) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode counts D = batch tokens."""
    sp = SHAPES[shape_name]
    n = cfg.param_count(active_only=True)
    if sp.kind == "train":
        tokens = sp.global_batch * (sp.seq_len if cfg.family != "audio"
                                    else sp.seq_len // 4 + cfg.encoder.dec_len)
        return 6.0 * n * tokens
    if sp.kind == "prefill":
        tokens = sp.global_batch * (sp.seq_len if cfg.family != "audio"
                                    else sp.seq_len // 4 + cfg.encoder.dec_len)
        return 2.0 * n * tokens
    return 2.0 * n * sp.global_batch     # decode: one token per sequence


def _cell_config(arch: str, variant: str, unroll: bool):
    cfg = get_config(arch)
    if VARIANTS.get(variant):
        cfg = cfg.with_(**VARIANTS[variant])
    if unroll:
        cfg = cfg.with_(scan_layers=False)
    return cfg


def build_cell(cfg, shape_name: str, mesh, compressed_kv: bool = False):
    """The cell's step and its ``meta`` arguments with their spec trees:
    (step, args, specs) where ``specs`` maps "params", "opt_state" (train),
    "batch" and "cache" (decode: the input cache; prefill: the output's,
    filled in by :func:`run_cell`) to spec trees."""
    kind = step_kind(shape_name)
    sp = SHAPES[shape_name]
    batch = input_specs(cfg, shape_name)
    params = abstract_params(cfg)
    specs = {"params": param_pspecs(cfg, params, mesh)}
    if kind == "train":
        opt = make_optimizer(cfg.optimizer, 3e-4,
                             moment_dtype=cfg.opt_state_dtype)
        state = init_train_state(cfg, params, opt)
        if cfg.optimizer == "adafactor":
            dp = dp_axes(mesh)
            dpz = axes_size(dp, mesh)
            dp_spec = (norm_axes(dp),)
            f_specs = map_with_names(
                lambda _, leaf: (dp_spec if leaf.dim() >= 1
                                 and leaf.shape[0] % dpz == 0 else ()),
                state["opt"]["f"])
            specs["opt_state"] = {"f": f_specs, "step": ()}
        else:
            specs["opt_state"] = {"m": specs["params"],
                                  "v": specs["params"], "step": ()}
        fn = make_train_step(cfg, opt)
        args = (params, state, batch)
    elif kind == "prefill":
        fn = make_prefill_step(cfg, max_len=sp.seq_len)
        args = (params, batch)
    else:
        if compressed_kv:
            batch = dict(batch)
            batch["cache"] = KV.compress_prefill_cache(batch["cache"])
            fn = KV.make_compressed_decode_step(cfg)
        else:
            fn = make_decode_step(cfg)
        args = (params, batch)
    specs["batch"] = batch_pspecs(cfg, batch, mesh)
    if "cache" in batch:
        specs["cache"] = specs["batch"]["cache"]
    return fn, args, specs


def _slstm_counted(x, prm, cfg):
    """``xlstm.slstm_full``'s products with its time loop as one product
    over the steps, for counting on ``meta`` (see the module note): step 0
    multiplies the zero state (no dh), steps 1 ... S-1 a state that
    depends on the input.  Its values are not the layer's."""
    B, S, d = x.shape
    wx = (x @ prm["w_gates"]).to(torch.float32)
    r = prm["r_gates"].to(torch.float32)
    h0 = torch.zeros((B, 1, d), dtype=torch.float32, device=x.device)
    h_prev = torch.tanh(wx[:, 1:, :d])
    raw = wx + torch.cat([h0 @ r, h_prev @ r], dim=1) + prm["b_gates"]
    h = torch.sigmoid(raw[..., 3 * d:]) * torch.tanh(raw[..., 2 * d:3 * d])
    last = h[:, -1]
    return X._slstm_out(h.to(x.dtype), prm), (last, last, last, last)


@contextlib.contextmanager
def _counting_forms():
    """The kernels' plain versions where the models call B10 and B11, and
    :func:`_slstm_counted` for the sLSTM, while the block runs."""
    swaps = [(A, "flash_attention_gqa", ref.flash_attention_gqa_ref),
             (KV, "kv_dequant_decode_attention_gqa",
              ref.kv_dequant_decode_attention_gqa_ref),
             (X, "slstm_full", _slstm_counted)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    try:
        for m, name, fn in swaps:
            setattr(m, name, fn)
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def counted_flops(fn, args, kind: str) -> tuple[float, object]:
    """FLOPs that FlopCounterMode counts over one call ``fn(*args)`` on
    ``meta``, and the call's output."""
    counter = FlopCounterMode(display=False)
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    with _counting_forms(), grad, counter:
        out = fn(*args)
    return float(counter.get_total_flops()), out


def _axes_of(spec: tuple) -> set:
    """The mesh axes a spec names."""
    return {a for ax in spec if ax is not None
            for a in (ax if isinstance(ax, tuple) else (ax,))}


def _drop(spec: tuple, axes: set) -> tuple:
    """``spec`` with the mesh axes ``axes`` taken out of every entry."""
    out = []
    for ax in spec:
        names = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        kept = tuple(a for a in names if a not in axes)
        out.append(None if not kept else kept[0] if len(kept) == 1
                   else kept)
    return tuple(out)


def _layer_counts(cfg) -> dict:
    """Layers of each role: self-attention layers by kind ("attn",
    "attn_local"; an encoder-decoder's "enc" and "dec"), cross-attention
    layers, recurrent mixers and MLPs (a decoder-only model's; an
    encoder-decoder's are one a layer, counted by the caller)."""
    if cfg.family == "audio":
        return {"self": [("enc", cfg.encoder.n_layers),
                         ("dec", cfg.n_layers)],
                "cross": cfg.n_layers, "mixers": 0, "mlps": 0}
    kinds = cfg.layer_kinds()
    return {"self": [(k, kinds.count(k)) for k in T.ATTN_KINDS
                     if kinds.count(k)],
            "cross": kinds.count("cross_attn"),
            "mixers": sum(k in T.STATE_KINDS for k in kinds),
            "mlps": sum(T._has_mlp(cfg, k) for k in kinds)}


def collective_bytes(cfg, kind: str, batch: int, seq: int, params,
                     p_specs, mesh, *, src_len: int = 0) -> dict:
    """One device's collective bytes a step, by kind (see the module note).

    ``batch`` and ``seq`` are the global batch and the tokens a pass
    (decode: 1; an encoder-decoder's decoder tokens); ``src_len`` the
    encoder's frames or a VLM's image tokens."""
    dp = dp_axes(mesh)
    dp_size = axes_size(dp, mesh)
    tp_size = mesh.shape[TP_AXIS] if TP_AXIS in mesh.axis_names else 1
    train = kind == "train"
    passes = (3 if cfg.remat else 2) if train else 1
    gathers = 2 if train and cfg.remat else 1
    out = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    fsdp = set(dp)
    for leaf, spec in spec_leaves(params, p_specs):
        names = _axes_of(spec)
        size = leaf.element_size()
        block = size * math.prod(shard_shape(tuple(leaf.shape), spec, mesh))
        if names & fsdp:
            gathered = _drop(spec, fsdp)
            out["all-gather"] += gathers * size * math.prod(
                shard_shape(tuple(leaf.shape), gathered, mesh))
            if train:
                out["reduce-scatter"] += block
        elif train and dp_size > 1:
            out["all-reduce"] += block
    if tp_size == 1:
        out["total"] = sum(out.values())
        return out
    b = batch // dp_size if batch % dp_size == 0 and batch >= dp_size \
        else batch
    d, Hq, hd, G = cfg.d_model, cfg.n_heads, cfg.hd, cfg.n_kv_heads
    roles = _layer_counts(cfg)
    enc_len = src_len if cfg.family == "audio" else 0
    act = 0          # row-parallel activation all-reduces, one pass
    inner = 0        # attention-internal all-reduces, one pass
    decode = kind == "decode"

    def attention(n: int, S: int, Tk: int, self_attn: bool) -> int:
        if decode:
            return n * (2 * b * Hq * 4 + b * Hq * hd * _ACT_BYTES)
        if self_attn and cfg.seq_parallel_attn:
            return n * (2 * b * Hq * S * 4 + b * S * Hq * hd * _ACT_BYTES)
        if G % tp_size:
            return n * b * Hq * S * Tk * 4
        return 0

    for role, n in roles["self"]:
        S = enc_len if role == "enc" else seq
        if decode and role == "enc":
            continue
        W = cfg.sliding_window if role == "attn_local" else 0
        Tk = S
        if W and cfg.banded_local_attn and S % W == 0 and S >= 2 * W:
            Tk = 2 * W
        act += n * b * S * d * _ACT_BYTES
        inner += attention(n, S, Tk, True)
    if roles["cross"]:
        act += roles["cross"] * b * seq * d * _ACT_BYTES
        inner += attention(roles["cross"], seq, src_len, False)
    act += roles["mixers"] * b * seq * d * _ACT_BYTES
    if cfg.family == "audio":
        if not decode:
            act += cfg.encoder.n_layers * b * enc_len * d * _ACT_BYTES
        act += cfg.n_layers * b * seq * d * _ACT_BYTES
    else:
        act += roles["mlps"] * b * seq * d * _ACT_BYTES
    out["all-reduce"] += passes * (act + inner)
    out["total"] = sum(out.values())
    return out


def _flat_specs(tree, specs) -> dict:
    """{path: spec as a list} of a spec tree, paths by dict keys and list
    positions joined with "/"."""
    out = {}

    def walk(t, s, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, (a, b) in enumerate(zip(t, s)):
                walk(a, b, path + (str(i),))
        else:
            out["/".join(path)] = [list(a) if isinstance(a, tuple) else a
                                   for a in s]
    walk(tree, specs, ())
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             compressed_kv: bool = False, unroll: bool = False,
             variant: str = "baseline", verbose: bool = True, *,
             cfg=None, mesh=None) -> dict:
    """One cell's record (see the module note); ``cfg`` and ``mesh`` stand
    in for the arch's config and the production mesh (tests)."""
    cfg = cfg or _cell_config(arch, variant, unroll)
    if not cell_is_applicable(cfg, shape_name):
        return {"arch": arch, "shape": shape_name,
                "skipped": skip_reason(cfg, shape_name)}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    n_chips = math.prod(mesh.shape.values())
    kind = step_kind(shape_name)
    sp = SHAPES[shape_name]
    t0 = time.time()
    fn, args, specs = build_cell(cfg, shape_name, mesh, compressed_kv)
    params, batch = args[0], args[-1]
    inputs = {k: v for k, v in batch.items() if k != "cache"}
    per_dev = {
        "params": shard_bytes(params, specs["params"], mesh),
        "opt_state": (shard_bytes(args[1]["opt"], specs["opt_state"], mesh)
                      if kind == "train" else 0),
        "inputs": shard_bytes(inputs, {k: specs["batch"][k]
                                       for k in inputs}, mesh),
        "cache": (shard_bytes(batch["cache"], specs["cache"], mesh)
                  if "cache" in batch else 0)}
    per_dev["argument"] = sum(per_dev.values())
    t_build = time.time() - t0
    flops, out = counted_flops(fn, args, kind)
    t_count = time.time() - t0 - t_build
    dpz = axes_size(dp_axes(mesh), mesh)
    v_ax = TP_AXIS if cfg.vocab % mesh.shape[TP_AXIS] == 0 else None
    logits_spec = (norm_axes(dp_axes(mesh)) if sp.global_batch % dpz == 0
                   else None, v_ax)
    logits = torch.empty((sp.global_batch, cfg.vocab), dtype=torch.float32,
                         device=META)
    if kind == "train":
        written = per_dev["params"] + per_dev["opt_state"]
    else:
        written = shard_bytes(logits, logits_spec, mesh)
    if kind == "prefill":
        specs["cache"] = cache_pspecs(cfg, out[1], mesh, sp.global_batch)
        written += shard_bytes(out[1], specs["cache"], mesh)
    per_dev["output"] = written
    audio = cfg.family == "audio"
    seq = 1 if kind == "decode" else (cfg.encoder.dec_len if audio
                                      else sp.seq_len)
    src = (sp.seq_len // 4 if audio and kind != "decode" else
           cfg.encoder.n_frames if audio else
           cfg.n_image_tokens if "cross_attn" in cfg.pattern else 0)
    coll = collective_bytes(cfg, kind, sp.global_batch, seq, params,
                            specs["params"], mesh, src_len=src)
    memory_s = (per_dev["argument"] + per_dev["output"]) / HBM_BW
    collective_s = coll["total"] / LINK_BW
    compute_s = flops / n_chips / PEAK_FLOPS
    terms = [("compute", compute_s), ("memory", memory_s),
             ("collective", collective_s)]
    mf = model_flops(cfg, shape_name)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(v) for v in mesh.shape.values()),
        "n_chips": n_chips, "compressed_kv": compressed_kv,
        "variant": variant, "step_kind": kind,
        "model_flops": mf,
        "bytes_per_device": per_dev,
        "pspecs": {name: _flat_specs(tree, specs[name]) for name, tree in (
            ("params", params),
            ("opt_state", args[1]["opt"] if kind == "train" else None),
            ("batch", batch),
            ("cache", batch.get("cache") if kind == "decode"
             else out[1] if kind == "prefill" else None))
            if tree is not None},
        "port": {
            "device": DEVICE, "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
            "link_bw": LINK_BW,
            "counted_flops": flops,
            "useful_flops_ratio": mf / flops,
            "collective_bytes": coll,
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s,
            "bottleneck": max(terms, key=lambda kv: kv[1])[0],
        },
        "t_build_s": round(t_build, 3), "t_count_s": round(t_count, 3),
    }
    if verbose:
        p = rec["port"]
        print(f"[dryrun] {arch} x {shape_name} ({rec['mesh']}"
              f"{' +ckv' if compressed_kv else ''}"
              f"{'' if variant == 'baseline' else ' +' + variant}): "
              f"compute {compute_s * 1e3:.2f}ms memory {memory_s * 1e3:.2f}ms "
              f"collective {collective_s * 1e3:.2f}ms -> {p['bottleneck']} | "
              f"args/dev {per_dev['argument'] / 2**30:.2f}GiB | "
              f"count {t_count:.1f}s", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--compressed-kv", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for repro's CLI; the port counts every "
                         "unit already")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ALIASES:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    results = []
    for arch, shape in cells:
        try:
            results.append(run_cell(arch, shape, multi_pod=args.multi_pod,
                                    compressed_kv=args.compressed_kv,
                                    unroll=args.unroll,
                                    variant=args.variant))
        except Exception as exc:  # lint: disable=typed-errors -- report the cell, keep sweeping
            print(f"[dryrun] {arch} x {shape} FAILED: {exc}", flush=True)
            results.append({"arch": arch, "shape": shape,
                            "error": f"{type(exc).__name__}: {exc}"})
    if args.out:
        with open(args.out, "w") as f:  # lint: disable=fault-coverage -- a report
            json.dump(results, f, indent=1, default=str)
    n_err = sum(1 for r in results if "error" in r)
    print(f"[dryrun] {len(results)} cells, {n_err} failures", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
