"""Sharded execution of the train step (ROADMAP A12h): FSDP x TP by hand
over ``torch.distributed`` on CPU ranks (gloo), held against the port's
one-device step and against ``jax.value_and_grad`` of ``repro``'s loss.

``repro``'s own sharded step fails in this tree
(``tests/test_multidevice.py::test_sharded_train_step_runs``), so the
oracles are the unsharded functions: GSPMD's contract is that a sharded
step computes the step on one device.  Each mesh spawns its ranks once and
runs every case of that mesh in them (:func:`_mesh_cases`); rank 0 sends
back the loss, the gradients gathered whole, and the parameters and AdamW
moments gathered after three steps.

Reduced qwen3-4b (2 layers, d 64, Hq 4, G 2, hd 16, d_ff 128, vocab 256)
at B 8 x S 16, weights from ``repro``'s init carried across with
``interop``; on 1x4 the config is widened to 8 query and 4 kv heads of hd
16, so that model 4 divides the kv heads.  On 2x2 also the dense family's
other two: reduced gemma3-12b (12 layers, 10 of them windowed, logits
soft-capped; remat on) and qwen1.5-32b (qkv biases, no qk-norm).  Bounds,
with the worst of these runs on a CPU container:

* f32 step 0 against the one-device step: loss ``F32_LOSS_RTOL`` relative
  (measured 8.1e-8), gradients ``F32_GRAD_RTOL`` of each leaf's max
  (2.4e-6); against ``repro``: ROADMAP C's 1e-6 and 1e-4.  The
  data-parallel sums meet in another order than one device's.
* f32 after three AdamW steps: each step's loss ``F32_LOSS_RTOL`` and
  gradient norm ten times that; the moments ``F32_MOMENT_RTOL`` of each
  leaf's max (2.0e-4).  Parameters: every element within
  ``F32_PARAM_LR`` · lr of the one-device run (0.12 lr), and each leaf's
  difference within ``F32_UPDATE_RTOL`` of its three updates' norm
  (5.8e-3, qwen1.5's k bias).  Not a fraction of the leaf's max: AdamW
  divides each element's first moment by the root of its own second
  moment, so an element whose gradient sits near ``eps`` (1e-8) moves
  ``lr · g / eps`` and takes a 1e-9 difference in ``g`` as 0.1 lr; the k
  bias's gradient is a near-cancelling sum (softmax does not see a
  constant added to a query's scores; only RoPE keeps the sum from
  zero), so its rounding is a larger share of it.
* bf16 (tensor-parallel partial sums meet in bf16 where one device sums
  in f32): loss ``BF16_LOSS_RTOL`` (3.3e-5) and gradients
  ``BF16_GRAD_RTOL`` (1.5e-2), ROADMAP C's bf16 bounds against ``repro``.

Collective bytes: on the hand-worked case of
``tests/test_torch_dryrun.py`` (2x2, B 4 x S 8, bf16) each rank's counters
equal ``launch/dryrun.py::collective_bytes`` plus the terms it leaves out,
worked out by hand below (:func:`_extra_terms`)."""
import io
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import MeshSpec, make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import Adafactor, AdamW, GradCompressor
from repro_torch.optim.adamw import tree_map
from repro_torch.train.checkpoint import CheckpointManager, flatten
from repro_torch.train.data import BatchRows, SyntheticTokens
from repro_torch.train.runtime import RuntimeConfig, TrainRuntime
from repro_torch.train.step import (init_train_state, make_loss_fn,
                                    make_train_step, make_value_and_grad,
                                    sharded_extra_bytes, value_and_grad)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
B, S, STEPS, LR = 8, 16, 3, 3e-3
F32_LOSS_RTOL = 1e-6
F32_GRAD_RTOL = 1e-5
F32_PARAM_LR = 0.5
F32_UPDATE_RTOL = 2e-2
F32_MOMENT_RTOL = 5e-4
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_RTOL = 4e-2
REPRO_LOSS_RTOL = {"float32": 1e-6, "bfloat16": 1e-3}
REPRO_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 4e-2}
TIMEOUT = 300.0
#: 1x4's config: 8 query and 4 kv heads of hd 16 (G % 4 == 0)
WIDE = {"n_heads": 8, "n_kv_heads": 4}


# -- what each rank runs (importable by name from the spawned ranks) ----------

def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _loads(blob: bytes):
    return torch.load(io.BytesIO(blob), weights_only=False)


def _cfg(over: dict, arch: str = "qwen3-4b"):
    return reduced_config(get_config(arch)).with_(**over)


def _rank_case(view, case: dict) -> dict:
    """One case on this rank: the blocks of the case's weights, the
    sharded loss and gradients of step 0 (gathered), then ``steps``
    AdamW steps (each step's loss, norm and collective bytes), the
    parameters and moments gathered after them."""
    cfg = _cfg(case["cfg"], case["arch"])
    full = _loads(case["params"])
    specs = SH.param_pspecs(cfg, full, view)
    params = SH.shard_tree(full, specs, view)
    out = {"blocks_whole": all(
        torch.equal(a, b) for a, b in zip(
            flatten(SH.gather_tree(params, specs, view)).values(),
            flatten(full).values()))}
    rows = view.index("data")
    dp = view.shape["data"]

    def batch(step):
        toks = case["tokens"][step]
        b = toks.shape[0] // dp
        return {"tokens": torch.from_numpy(toks[rows * b:(rows + 1) * b])
                .long()}

    C.reset_counts()
    loss, grads = make_value_and_grad(cfg, view)(params, batch(0))
    out["counts_grad"] = C.read_counts()
    out["loss0"] = float(loss)
    out["grads0"] = SH.gather_tree(grads, specs, view)
    if case.get("gc"):
        gc = GradCompressor(1e-2)
        err = gc.init(params)
        q, e = gc.roundtrip(tree_map(torch.clone, grads), err,
                            reduce_max=lambda t: C.all_reduce(
                                t, view, None, op="max"))
        out["gc"] = (SH.gather_tree(q, specs, view),
                     SH.gather_tree(e, specs, view))
    opt = AdamW(lr=LR)
    state = init_train_state(cfg, params, opt)
    step_fn = make_train_step(cfg, opt, mesh=view)
    out["steps"] = []
    for i in range(case["steps"]):
        C.reset_counts()
        params, state, m = step_fn(params, state, batch(i))
        out["steps"].append({"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "counts": C.read_counts(),
                             "seconds": C.read_seconds()})
    if case["steps"]:
        sspecs = SH.train_state_pspecs(state, specs)
        out["params"] = SH.gather_tree(params, specs, view)
        out["state"] = SH.gather_tree(state, sspecs, view)
    return out


def _rank_runtime(view, case: dict) -> dict:
    """Two ``TrainRuntime`` runs of the case on this rank's blocks,
    checkpointing every step: one with a failure injected at step 2, one
    without; both gathered after ``steps`` steps."""
    cfg = _cfg(case["cfg"], case["arch"])
    full = _loads(case["params"])
    specs = SH.param_pspecs(cfg, full, view)
    src = BatchRows(SyntheticTokens(vocab=cfg.vocab, seq_len=S,
                                    global_batch=B),
                    view.shape["data"], view.index("data"))
    out = {}
    for label, fail_at in (("restarted", 2), ("uninterrupted", None)):
        params = SH.shard_tree(full, specs, view)
        opt = AdamW(lr=LR)
        state = init_train_state(cfg, params, opt)
        sspecs = SH.train_state_pspecs(state, specs)
        rt = TrainRuntime(
            cfg=RuntimeConfig(ckpt_dir=os.path.join(case["dir"], label),
                              ckpt_every=1, fail_at_step=fail_at),
            train_step=make_train_step(cfg, opt, mesh=view),
            data_source=src, device=CPU, mesh=view, specs=(specs, sspecs))
        params, state, hist = rt.run(params, state, n_steps=case["steps"])
        out[label] = (SH.gather_tree((params, state), (specs, sspecs), view),
                      max(m["restarts"] for m in hist))
    return out


def _mesh_cases(view, cases: list) -> list:
    """Every case of one mesh in one world; rank 0 returns the results,
    the other ranks their collective counts."""
    out = []
    for case in cases:
        fn = _rank_runtime if case.get("runtime") else _rank_case
        res = fn(view, case)
        if view.rank:
            res = {"counts_grad": res.get("counts_grad"),
                   "steps": res.get("steps")}
        out.append(res)
    return out


# -- the parent's side ----------------------------------------------------------

@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models import transformer as JT
    from repro.train import step as JS
    return types.SimpleNamespace(jax=jax, jnp=jnp, get=jget, reduced=jreduced,
                                 T=JT, S=JS)


def _tokens(vocab: int, seed: int, b: int = B, s: int = S) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (b, s)).astype(np.int32)
            for _ in range(STEPS)]


class _Case:
    """One (config, dtype, seed) with its weights from ``repro``'s init,
    its tokens, ``repro``'s step-0 loss and gradients and the port's
    one-device run."""

    def __init__(self, J, over: dict, dtype: str, seed: int,
                 b: int = B, s: int = S, arch: str = "qwen3-4b"):
        self.over, self.dtype, self.arch = over, dtype, arch
        jcfg = J.reduced(J.get(arch)).with_(**over)
        self.cfg = _cfg(over, arch)
        jp = J.T.init_params(jcfg, J.jax.random.PRNGKey(seed),
                             getattr(J.jnp, dtype))
        self.params = lm_params_from_numpy(J.jax.tree.map(np.asarray, jp),
                                           CPU)
        self.tokens = _tokens(jcfg.vocab, seed, b, s)
        self._J, self._jcfg, self._jp = J, jcfg, jp
        self._single = self._repro = None

    def repro(self) -> tuple:
        """``repro``'s step-0 loss and gradients (by checkpoint key)."""
        if self._repro is None:
            J = self._J
            jl, jg = J.jax.value_and_grad(J.S.make_loss_fn(self._jcfg))(
                self._jp, {"tokens": J.jnp.asarray(self.tokens[0])})
            self._repro = (float(jl), {
                "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path): np.array(x, np.float32)
                for path, x in J.jax.tree_util.tree_flatten_with_path(jg)[0]})
        return self._repro

    def spec(self, steps: int = STEPS, **kw) -> dict:
        return dict(cfg=self.over, arch=self.arch,
                    params=_dumps(self.params), tokens=self.tokens,
                    steps=steps, **kw)

    def single(self):
        """The one-device step: step 0's loss and gradients, and each
        step's loss and norm, the parameters and state after STEPS."""
        if self._single is None:
            params = tree_map(torch.clone, self.params)
            loss, grads = value_and_grad(make_loss_fn(self.cfg), params,
                                         {"tokens": torch.from_numpy(
                                             self.tokens[0]).long()})
            opt = AdamW(lr=LR)
            state = init_train_state(self.cfg, params, opt)
            step = make_train_step(self.cfg, opt)
            steps = []
            for i in range(STEPS):
                params, state, m = step(params, state, {
                    "tokens": torch.from_numpy(self.tokens[i]).long()})
                steps.append({k: float(v) for k, v in m.items()})
            self._single = dict(loss0=float(loss), grads0=flatten(grads),
                                steps=steps, params=flatten(params),
                                state=flatten(state))
        return self._single


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def _leaf_err(got: dict, want: dict) -> float:
    """The worst leaf's max|got - want| over its max|want|."""
    worst = 0.0
    for key, w in want.items():
        w = torch.as_tensor(w).float()
        scale = float(w.abs().max()) or 1.0
        worst = max(worst, float((got[key].float() - w).abs().max()) / scale)
    return worst


def _check(case: _Case, res: dict, remat: bool) -> dict:
    """Hold one mesh's result against the one-device step and
    ``repro``; returns the measured errors."""
    one = case.single()
    jloss, jgrads = case.repro()
    f32 = case.dtype == "float32"
    got = flatten(res["grads0"])
    errs = {
        "loss_vs_one": _rel(res["loss0"], one["loss0"]),
        "grad_vs_one": _leaf_err(got, one["grads0"]),
        "loss_vs_repro": _rel(res["loss0"], jloss),
        "grad_vs_repro": _leaf_err(got, jgrads),
    }
    assert res["blocks_whole"]
    assert list(got) == list(one["grads0"])
    loss_tol = F32_LOSS_RTOL if f32 else BF16_LOSS_RTOL
    grad_tol = F32_GRAD_RTOL if f32 else BF16_GRAD_RTOL
    assert errs["loss_vs_one"] <= loss_tol, (remat, errs)
    assert errs["grad_vs_one"] <= grad_tol, (remat, errs)
    assert errs["loss_vs_repro"] <= REPRO_LOSS_RTOL[case.dtype], errs
    assert errs["grad_vs_repro"] <= REPRO_GRAD_RTOL[case.dtype], errs
    for i, (a, b) in enumerate(zip(res["steps"], one["steps"])):
        for key in ("loss", "grad_norm"):
            e = _rel(a[key], b[key])
            errs[f"step{i}_{key}"] = e
            assert e <= loss_tol * (1 if key == "loss" else 10), (i, key, e)
    if f32:
        got_p, init = flatten(res["params"]), flatten(case.params)
        errs["params_lr"] = max(
            float((got_p[k] - w).abs().max()) / LR
            for k, w in one["params"].items())
        errs["update"] = max(
            float((got_p[k] - w).norm() / (w - init[k]).norm())
            for k, w in one["params"].items())
        st = flatten(res["state"])
        errs["moments"] = _leaf_err(
            {k: v for k, v in st.items() if not k.endswith("step")},
            {k: v for k, v in one["state"].items()
             if not k.endswith("step")})
        assert errs["params_lr"] <= F32_PARAM_LR, errs
        assert errs["update"] <= F32_UPDATE_RTOL, errs
        assert errs["moments"] <= F32_MOMENT_RTOL, errs
        assert int(st["opt/step"]) == STEPS
    return errs


def _run(shape: tuple, cases: list) -> list:
    mesh = make_host_mesh(*shape, devices=[CPU] * (shape[0] * shape[1]))
    return C.run_ranks(_mesh_cases, mesh, args=(cases,), timeout=TIMEOUT)


# -- 1. the mesh's layout, 2. blocks ------------------------------------------

def test_rank_coordinates_follow_jax_make_mesh():
    """Rank r sits at the coordinates of device r in ``jax.make_mesh((d,
    m), ("data", "model"))``, for 1x2, 2x1, 2x2 and 4x2 (8 host devices,
    in a subprocess)."""
    pytest.importorskip("jax")
    code = textwrap.dedent("""
        import jax
        from repro_torch.launch.mesh import MeshSpec
        for d, m in ((1, 2), (2, 1), (2, 2), (4, 2)):
            devs = jax.make_mesh((d, m), ("data", "model")).devices
            spec = MeshSpec(("data", "model"), (d, m))
            for i in range(d):
                for j in range(m):
                    r = devs[i, j].id
                    assert spec.coords_of(r) == (i, j), (d, m, r, i, j)
                    assert spec.rank_of((i, j)) == r
        print("LAYOUT OK")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "LAYOUT OK" in out.stdout


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (4, 2)])
def test_blocks_round_trip_every_leaf(shape, monkeypatch):
    """``local_block`` of every leaf of reduced qwen3-4b at every rank's
    coordinates has ``shard_shape``'s shape, and ``gather_tree`` puts the
    blocks back bit for bit.  The world's all-gather is stood in for by
    the blocks of every coordinate, stacked in rank order (the spawned
    meshes below run the real one)."""
    cfg = _cfg({})
    full = T.init_params(cfg, 3, dtype=torch.float32, device=CPU)
    mesh = make_host_mesh(*shape, devices=[CPU] * (shape[0] * shape[1]))
    specs = SH.param_pspecs(cfg, full, mesh)
    views = [mesh.at(r) for r in range(mesh.size)]
    blocks = [SH.shard_tree(full, specs, v) for v in views]
    for names, leaf, spec in SH.named_specs(full, specs):
        for v in views:
            blk = SH.local_block(leaf, spec, mesh, v.coords)
            assert tuple(blk.shape) == SH.shard_shape(tuple(leaf.shape),
                                                      spec, mesh), names
    by_leaf = {}
    for tree in blocks:
        for k, t in flatten(tree).items():
            by_leaf.setdefault(k, []).append(t)
    mine = flatten(blocks[-1])
    ptr = {t.data_ptr(): k for k, t in mine.items()}

    def world_gather(t, mesh_, axis, dim=0, count=True):
        assert axis is None and not count
        return torch.stack([b.reshape(-1) for b in by_leaf[ptr[t.data_ptr()]]])
    monkeypatch.setattr(C, "all_gather", world_gather)
    got = flatten(SH.gather_tree(blocks[-1], specs, views[-1]))
    assert list(got) == list(flatten(full))
    for key, want in flatten(full).items():
        assert torch.equal(got[key], want), key


# -- 3. the sharded step against the oracles; 4. bytes; 5. compression;
# -- 6. checkpoints ------------------------------------------------------------

#: the terms ``collective_bytes`` leaves out, one device, at (b, S, d) =
#: (B/dp, S, d_model) in bf16, L layers, tp > 1, dp > 1:
#: * the vocab-parallel embedding's all-reduce over model of its rows'
#:   lookups: b·S·d·2 bytes, once (outside the checkpointed units);
#: * the vocab-parallel logits' input, all-reduced over model in the
#:   backward (Megatron's f before the tied logits): b·S·d·2, once;
#: * the cross-entropy's max, sum of exponentials and target logit over
#:   model: 3 · b·(S-1) · 4 (f32), once;
#: * q_norm and k_norm's gradients over model (they act on the rank's
#:   heads): their blocks, 2 · L · hd · 4 (f32);
#: * the loss over data and grad_norm over the world: 4 + 4.
#: ``train.step.sharded_extra_bytes`` computes the same terms from the
#: spec tree; the test holds it to these.
#: With remat, ``collective_bytes`` gathers every FSDP leaf twice; the
#: embedding is outside the checkpointed units and is gathered once, so
#: its second gather, (V/tp)·d·2, comes off (ROADMAP C).
def _extra_terms(cfg, b: int, s: int, dp: int, tp: int) -> dict:
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.hd
    act = b * s * d * 2
    extra = {"embedding": act, "logits_input": act,
             "cross_entropy": 3 * b * (s - 1) * 4,
             "qk_norm_over_model": 2 * L * hd * 4,
             "loss": 4, "grad_norm": 4}
    regather = (cfg.vocab // tp) * d * 2 if cfg.remat else 0
    return {"all-reduce": sum(extra.values()), "all-gather": -regather,
            "terms": extra}


def _expected_bytes(cfg, b_global: int, s: int, mesh) -> dict:
    params = D.abstract_params(cfg)
    specs = SH.param_pspecs(cfg, params, mesh)
    want = D.collective_bytes(cfg, "train", b_global, s, params, specs, mesh)
    extra = _extra_terms(cfg, b_global // mesh.shape["data"], s,
                         mesh.shape["data"], mesh.shape["model"])
    want["all-reduce"] += extra["all-reduce"]
    want["all-gather"] += extra["all-gather"]
    want["total"] = sum(want[k] for k in C.KINDS)
    return want


def test_hand_worked_extra_terms():
    """The terms at the dry run's hand-worked case (2x2, B 4 x S 8, bf16,
    d 64, 2 layers, hd 16, vocab 256): 2,048 + 2,048 + 168 + 256 + 8 =
    4,528 bytes of all-reduce; with remat one embedding gather of 128 x
    64 x 2 = 16,384 bytes fewer."""
    cfg = _cfg({})
    got = _extra_terms(cfg, 2, 8, 2, 2)
    assert got["terms"] == {"embedding": 2048, "logits_input": 2048,
                            "cross_entropy": 168, "qk_norm_over_model": 256,
                            "loss": 4, "grad_norm": 4}
    assert got["all-reduce"] == 4528 and got["all-gather"] == 0
    assert _extra_terms(cfg.with_(remat=True), 2, 8, 2, 2)[
        "all-gather"] == -16384
    mesh = make_host_mesh(2, 2, devices=[CPU] * 4)
    for remat in (False, True):
        c = cfg.with_(remat=remat)
        params = D.abstract_params(c)
        port = sharded_extra_bytes(c, 4, 8, params,
                                   SH.param_pspecs(c, params, mesh), mesh)
        hand = _extra_terms(c, 2, 8, 2, 2)
        assert port["terms"] == hand["terms"], remat
        assert (port["all-reduce"], port["all-gather"]) == \
            (hand["all-reduce"], hand["all-gather"]), remat
    hand = {"all-gather": 90_112, "reduce-scatter": 45_056,
            "all-reduce": 1_536 + 16_384 + 4_528}
    want = _expected_bytes(cfg, 4, 8, mesh)
    assert {k: want[k] for k in C.KINDS} == hand


@pytest.fixture(scope="module")
def cases(J):
    return {"f32": _Case(J, {}, "float32", 0),
            "bf16": _Case(J, {}, "bfloat16", 1),
            "wide": _Case(J, WIDE, "float32", 2),
            "bytes": _Case(J, {}, "bfloat16", 4, b=4, s=8),
            "gemma3": _Case(J, {"remat": True}, "float32", 5,
                            arch="gemma3-12b"),
            "qwen1.5": _Case(J, {}, "float32", 6, arch="qwen1.5-32b")}


def test_2x2_step_bytes_compression_and_checkpoints(cases, tmp_path):
    """2x2: f32 with remat off, bf16 with remat on, reduced gemma3-12b in
    f32 with remat on and qwen1.5-32b in f32 against the oracles; each rank's collective bytes at the hand-worked case (bf16,
    B 4 x S 8, remat off and on) equal the dry run's plus the named
    terms, and each kind's host seconds are counted; the gradient compressor's codes and residuals of every leaf
    equal the one-device round trip of the gathered gradient bit for bit;
    a ``TrainRuntime`` run with a failure at step 2 equals the
    uninterrupted one bit for bit, and its last checkpoint holds the same
    files one device writes for the gathered tree and restores on 1x1 and
    1x2 bit for bit."""
    f32, bf16, by = cases["f32"], cases["bf16"], cases["bytes"]
    specs = [f32.spec(gc=True), dict(bf16.spec(), cfg={"remat": True}),
             by.spec(steps=1), dict(by.spec(steps=1), cfg={"remat": True}),
             dict(f32.spec(steps=4), runtime=True, dir=str(tmp_path)),
             cases["gemma3"].spec(), cases["qwen1.5"].spec()]
    res = _run((2, 2), specs)
    errs = [_check(f32, res[0][0], False), _check(bf16, res[0][1], True),
            _check(cases["gemma3"], res[0][5], True),
            _check(cases["qwen1.5"], res[0][6], False)]
    print("2x2 errors", errs)
    mesh = make_host_mesh(2, 2, devices=[CPU] * 4)
    for k, remat in ((2, False), (3, True)):
        want = _expected_bytes(_cfg({"remat": remat}), 4, 8, mesh)
        for r in range(4):
            got = res[r][k]["steps"][0]["counts"]
            assert got == want, (remat, r, got, want)
            secs = res[r][k]["steps"][0]["seconds"]
            assert all(secs[kind] > 0 for kind in C.KINDS), secs
    # compression
    q, e = res[0][0]["gc"]
    grads = tree_map(torch.clone, res[0][0]["grads0"])
    gc = GradCompressor(1e-2)
    wq, we = gc.roundtrip(grads, gc.init(grads))
    for a, b in zip(flatten((q, e)).values(), flatten((wq, we)).values()):
        assert torch.equal(a, b)
    # checkpoints
    (rest, n_restarts), (plain, _) = (res[0][4]["restarted"],
                                      res[0][4]["uninterrupted"])
    assert n_restarts == 1
    for a, b in zip(flatten(rest).values(), flatten(plain).values()):
        assert torch.equal(a, b)
    src = tmp_path / "uninterrupted"
    one = CheckpointManager(str(tmp_path / "one"))
    one.save(3, plain)
    step_dir = src / "step_00000003"
    for name in sorted(os.listdir(one._step_dir(3))):
        assert (step_dir / name).read_bytes() == \
            open(os.path.join(one._step_dir(3), name), "rb").read(), name
    mgr = CheckpointManager(str(src))
    cfg = f32.cfg
    for shape in ((1, 1), (1, 2)):
        m = make_host_mesh(*shape, devices=[CPU] * (shape[0] * shape[1]))
        pspecs = SH.param_pspecs(cfg, plain[0], m)
        st = {"opt": {"m": pspecs, "v": pspecs, "step": ()}}
        for r in range(m.size):
            v = m.at(r)
            template = (SH.shard_tree(plain[0], pspecs, v),
                        SH.shard_tree(plain[1], st, v))
            got, step = mgr.restore(template, device=CPU, mesh=v,
                                    specs=(pspecs, st))
            assert step == 3
            want = (SH.shard_tree(plain[0], pspecs, v),
                    SH.shard_tree(plain[1], st, v))
            for a, b in zip(flatten(got).values(), flatten(want).values()):
                assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(4, 2), (1, 4), (4, 1)],
                         ids=["4x2", "1x4", "4x1"])
def test_sharded_step_matches_one_device_and_repro(cases, shape):
    """4x2 (``repro``'s failing test's mesh), 1x4 (the config widened to 4
    kv heads) and 4x1: step 0's loss and gathered gradients against
    ``jax.value_and_grad`` of ``repro``'s loss and the port's one-device
    step, three AdamW steps' parameters and moments against the
    one-device run; 4x2 also in bf16."""
    case = cases["wide"] if shape == (1, 4) else cases["f32"]
    todo = [case.spec()]
    if shape == (4, 2):
        todo.append(dict(cases["bf16"].spec(), cfg={"remat": True}))
    res = _run(shape, todo)
    errs = [_check(case, res[0][0], False)]
    if shape == (4, 2):
        errs.append(_check(cases["bf16"], res[0][1], True))
    print(shape, "errors", errs)


def test_1x1_through_the_sharded_code_is_the_one_device_step(cases,
                                                             tmp_path):
    """A world of one rank (gloo) through ``make_train_step(...,
    mesh=view)``: three steps bit for bit the one-device step."""
    case = cases["f32"]
    one = case.single()
    mesh = make_host_mesh(1, 1, devices=[CPU])
    view = C.init_rank(mesh, 0, str(tmp_path / "rendezvous"))
    try:
        params = tree_map(torch.clone, case.params)
        opt = AdamW(lr=LR)
        state = init_train_state(case.cfg, params, opt)
        step = make_train_step(case.cfg, opt, mesh=view)
        C.reset_counts()
        for i in range(STEPS):
            params, state, m = step(params, state, {
                "tokens": torch.from_numpy(case.tokens[i]).long()})
            assert float(m["loss"]) == one["steps"][i]["loss"]
            assert float(m["grad_norm"]) == one["steps"][i]["grad_norm"]
        assert C.read_counts()["total"] == 0
    finally:
        C.destroy()
    for key, want in one["params"].items():
        assert torch.equal(flatten(params)[key], want), key


# -- 7. the launcher and what a mesh does not run yet ---------------------------

def test_launch_train_on_a_2x2_cpu_mesh(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import train as launch
    monkeypatch.setattr(launch, "RANK_TIMEOUT_S", TIMEOUT)
    rc = launch.main(["--arch", "qwen3-4b", "--mesh", "2x2", "--device",
                      "cpu", "--steps", "3", "--batch", "4", "--seq", "16",
                      "--ckpt-dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[train] qwen3-4b mesh=2x2: loss " in out and "ms/step" in out
    assert CheckpointManager(str(tmp_path)).steps() == [0, 2]


@pytest.mark.parametrize("arch,over,opt", [
    ("granite-20b", {}, None), ("arctic-480b", {}, None),
    ("mixtral-8x22b", {}, None), ("qwen3-4b", {}, "adafactor"),
    ("qwen3-4b", {"seq_parallel_attn": True}, None)],
    ids=["granite-mqa", "arctic", "mixtral", "adafactor", "seqattn"])
def test_what_a_mesh_does_not_run_yet_raises(arch, over, opt):
    cfg = reduced_config(get_config(arch)).with_(**over)
    opt = Adafactor() if (opt or cfg.optimizer) == "adafactor" else AdamW()
    view = make_host_mesh(1, 2, devices=[CPU] * 2).at(0)
    with pytest.raises(NotImplementedError, match="A12h-b"):
        make_train_step(cfg, opt, mesh=view)


def test_a_tensor_parallel_leaf_the_rules_left_whole_raises():
    cfg = _cfg({"vocab": 255})
    view = make_host_mesh(1, 2, devices=[CPU] * 2).at(0)
    with pytest.raises(ValueError, match="leaf embed"):
        make_train_step(cfg, AdamW(), mesh=view)


def test_a_mesh_needs_its_cards():
    from repro_torch.launch import train as launch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"needs 8 devices, have {n}"):
        launch.main(["--mesh", "2x4"])
    with pytest.raises(ValueError, match="must all be"):
        C.backend_for([CPU, torch.device("cuda", 0)])
    assert C.backend_for([CPU] * 4) == "gloo"
    assert C.backend_for([torch.device("cuda", 0)] * 4) == "gloo"
    assert C.backend_for([torch.device("cuda", i) for i in range(4)]) == \
        "nccl"
    assert MeshSpec(("data", "model"), (4, 2)).coords_of(5) == (2, 1)


# -- 8. on the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_1x1_sharded_step_matches_the_cpu_run(tmp_path):
    """A 1x1 mesh over NCCL on cuda:0 through the sharded step against the
    same step on the CPU: the loss within 1e-5, the parameters within 0.1
    · lr (``test_cuda_train_step_matches_the_cpu_run``'s bound), every
    leaf moved."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    cfg = _cfg({"remat": True})
    toks = SyntheticTokens(vocab=cfg.vocab, seq_len=64,
                           global_batch=2).batch(0)
    runs = []
    for dev in (CPU, torch.device("cuda", 0)):
        params = tree_map(lambda t: t.to(dev), T.init_params(
            cfg, 0, dtype=torch.float32, device=CPU))
        init = {k: t.cpu().clone() for k, t in flatten(params).items()}
        opt = AdamW(lr=LR)
        state = init_train_state(cfg, params, opt)
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if dev.type == "cuda":
            mesh = make_host_mesh(1, 1, devices=[dev])
            view = C.init_rank(mesh, 0, str(tmp_path / "rendezvous"))
            try:
                params, state, m = make_train_step(cfg, opt, mesh=view)(
                    params, state, batch)
            finally:
                C.destroy()
        else:
            params, state, m = make_train_step(cfg, opt)(params, state,
                                                          batch)
        runs.append((flatten(params), m))
    (pc, mc), (pg, mg) = runs
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= \
        1e-5 * float(mc["loss"])
    for key, w in pc.items():
        assert float((pg[key].cpu() - w).abs().max()) <= 0.1 * LR, key
        assert not torch.equal(pg[key].cpu(), init[key]), key
