"""MoE (A12c) and recurrent (A12d) models served by the port, against
the JAX package: reduced mixtral-8x22b (windowed attention, 4 experts
top-2), arctic-480b (4 experts top-2 with the dense residual),
recurrentgemma-2b (7 layers of rglru, rglru, attn_local: 2 units and a
remainder, window 8, so the 16-token prompt wraps the ring) and
xlstm-125m (mlstm, slstm; no attention), ``repro``'s weights carried
across by ``lm_params_from_numpy`` and the same numpy-seeded tokens:
train, prefill, raw and compressed decode, the parameter and cache trees
(paths, shapes, dtypes, at reduced and at full size), the recurrent states
that compression keeps raw, and decode after a captured step's warm-up
equal to the eager step bit for bit (the CUDA graph itself only on a
card: the ``cuda``-marked test).

Tolerances (max|Δlogits| / max|ref| over the steps, measured on a CPU
container, 3 seeds).  In f32 the port computes ``repro``'s function:
train, prefill and raw decode within 1.6e-6, held at 1e-5; compressed
decode, which rounds K/V, P and the attention output to bf16 as
``repro``'s does, within 2.4e-6, held at 1e-5.  In bf16, the dtype served,
the matmuls round in another order than XLA's: within 1.4%, held at 4e-2
(``tests/test_torch_window_slice.py``'s bf16 bound, for the same reason).
That rounding can flip a near-tie of two experts' router probabilities:
at seeds 4 and 5 one (token, layer) of 80 in the training pass takes
another expert than in ``repro``'s layer scan (none against its unrolled
layers), and its batch row's logits then read 7.0% and 6.8% apart.  So
both sides' expert sets are recorded (:class:`Routing`); rows a differing
set has reached are not held to the bound, the share of differing sets is
held at 5%, and in f32 none may differ.  The routing itself is held
exactly in ``tests/test_torch_moe.py``."""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.serving import make_decode_step, make_prefill_step, warm_up
from repro_torch.serving import kvcache as KV

CPU = torch.device("cpu")
ARCHS = ["mixtral-8x22b", "arctic-480b", "recurrentgemma-2b", "xlstm-125m"]
DTYPES = ["float32", "bfloat16"]
B, PROMPT, STEPS = 2, 16, 4
MAX_LEN = PROMPT + STEPS
TOL = {"float32": 1e-5, "bfloat16": 4e-2}
#: attention layers of each full-size model (B10 launches a prefill, B11
#: a compressed decode step)
ATTN_LAYERS = {"mixtral-8x22b": 56, "arctic-480b": 35,
               "recurrentgemma-2b": 8, "xlstm-125m": 0}


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models import transformer as JT
    from repro.serving import kvcache as JKV
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jget,
                                 reduced_config=jreduced, T=JT, KV=JKV)


def _np_tree(J, tree):
    return J.jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request, J):
    """(arch, dtype, JAX cfg, port cfg, JAX params, port params, tokens)."""
    arch, dtype = request.param
    jcfg = J.reduced_config(J.get_config(arch))
    tcfg = reduced_config(get_config(arch))
    jp = J.T.init_params(jcfg, J.jax.random.PRNGKey(3),
                         dtype=getattr(J.jnp, dtype))
    tp = lm_params_from_numpy(_np_tree(J, jp), CPU)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, MAX_LEN)) \
        .astype(np.int32)
    return arch, dtype, jcfg, tcfg, jp, tp, toks


def _tok(toks, lo, hi=None):
    return torch.from_numpy(toks[:, lo:hi]).long()


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


def _paths(J, tree):
    return [(J.jax.tree_util.keystr(p), tuple(x.shape),
             str(x.dtype).split(".")[-1])
            for p, x in J.jax.tree_util.tree_flatten_with_path(tree)[0]]


class Routing:
    """Both sides' expert sets, recorded at every ``moe_layer`` call (the
    port's directly, ``repro``'s inside its layer scan through an ordered
    ``jax.debug.callback``), and the batch rows a differing set has reached
    so far: an MoE layer's expert choice is discrete, so where bf16
    rounding flips a near-tie the two runs part by an expert's output and
    that row, from then on, is not held to the rounding bound."""

    def __init__(self, J, batch: int):
        self.J, self.batch = J, batch
        self.port, self.repro = [], []
        self.tainted = np.zeros(batch, bool)
        self.sets = self.flips = 0

    def __enter__(self):
        from unittest import mock
        J = self.J
        real_t, real_j = T.moe_layer, J.T.moe_layer

        def port(x, prm, cfg):
            xt = x.reshape(-1, x.shape[-1]).float()
            ids = torch.topk(torch.softmax(xt @ prm["router"], -1),
                             cfg.moe.top_k, -1).indices
            self.port.append(ids.sort(-1).values.numpy())
            return real_t(x, prm, cfg)

        def repro(x, prm, cfg):
            xt = x.reshape(-1, x.shape[-1]).astype(J.jnp.float32)
            ids = J.jax.lax.top_k(J.jax.nn.softmax(xt @ prm["router"], -1),
                                  cfg.moe.top_k)[1]
            J.jax.debug.callback(lambda i: self.repro.append(
                np.sort(np.asarray(i), -1)), ids, ordered=True)
            return real_j(x, prm, cfg)
        self._patches = [mock.patch.object(T, "moe_layer", port),
                         mock.patch.object(J.T, "moe_layer", repro)]
        for m in self._patches:
            m.start()
        return self

    def __exit__(self, *exc):
        for m in self._patches:
            m.stop()

    def held(self) -> np.ndarray:
        """Fold the calls recorded since the last ``held()`` into the
        tainted rows; returns the rows still held."""
        self.J.jax.effects_barrier()
        assert len(self.port) == len(self.repro)
        for t, j in zip(self.port, self.repro):
            diff = (t != j).any(-1).reshape(self.batch, -1)
            self.tainted |= diff.any(-1)
            self.sets, self.flips = self.sets + diff.size, \
                self.flips + int(diff.sum())
        self.port.clear()
        self.repro.clear()
        return ~self.tainted


def _rel_rows(got, want, rows) -> float:
    """max|Δ| over the held batch rows, over max|want|."""
    want = np.asarray(want, np.float32)
    d = np.abs(got.float().numpy() - want)[rows]
    return float(d.max(initial=0.0) / np.abs(want).max())


#: expert sets (token, layer) that may differ from ``repro``'s in bf16:
#: measured 1 of 80 at seeds 4 and 5 of the training pass, 0 at seed 3
FLIP_SHARE = 0.05


def _check_routing(routing, dtype):
    if dtype == "float32":
        assert routing.flips == 0
    assert routing.flips <= FLIP_SHARE * max(routing.sets, 1)


def test_train_prefill_and_raw_decode_match_repro(J, model):
    arch, dtype, jcfg, tcfg, jp, tp, toks = model
    jnp = J.jnp
    with Routing(J, B) as routing:
        ref = np.asarray(J.T.forward_train(jcfg, jp, jnp.asarray(toks)))
        got = T.forward_train(tcfg, tp, _tok(toks, 0))
        assert _rel_rows(got, ref, routing.held()) < TOL[dtype]
    with Routing(J, B) as routing:
        jlp, jc = J.T.forward_prefill(jcfg, jp,
                                      jnp.asarray(toks[:, :PROMPT]),
                                      max_len=MAX_LEN)
        tlp, tc = make_prefill_step(tcfg, MAX_LEN)(
            tp, {"tokens": _tok(toks, 0, PROMPT)})
        assert _rel_rows(tlp, jlp, routing.held()) < TOL[dtype]
        assert _paths(J, tc) == _paths(J, jc)
        step = make_decode_step(tcfg)
        for pos in range(PROMPT, MAX_LEN):
            jlg, jc = J.T.forward_decode(jcfg, jp, jnp.asarray(
                toks[:, pos:pos + 1]), jc, pos)
            tlg, tc = step(tp, {"token": _tok(toks, pos, pos + 1),
                                "cache": tc, "pos": pos})
            assert _rel_rows(tlg, jlg, routing.held()) < TOL[dtype], \
                (arch, pos)
    _check_routing(routing, dtype)


@pytest.mark.parametrize("arch,seed", [("mixtral-8x22b", 4),
                                       ("arctic-480b", 5)])
def test_a_flipped_expert_choice_is_seen_and_its_row_set_aside(J, arch,
                                                               seed):
    """At these seeds bf16 rounding flips one near-tie of the training
    pass against ``repro``'s layer scan: ``Routing`` sees the differing
    set, sets its row aside (whose logits then lie past the bound, 7.0%
    and 6.8% on a CPU container) and holds the other row."""
    jcfg = J.reduced_config(J.get_config(arch))
    tcfg = reduced_config(get_config(arch))
    jp = J.T.init_params(jcfg, J.jax.random.PRNGKey(seed),
                         dtype=J.jnp.bfloat16)
    tp = lm_params_from_numpy(_np_tree(J, jp), CPU)
    toks = np.random.default_rng(seed - 3).integers(
        0, jcfg.vocab, (B, MAX_LEN)).astype(np.int32)
    with Routing(J, B) as routing:
        ref = np.asarray(J.T.forward_train(jcfg, jp, J.jnp.asarray(toks)))
        got = T.forward_train(tcfg, tp, _tok(toks, 0))
        held = routing.held()
    assert routing.flips >= 1 and not held.all() and held.any()
    assert _rel_rows(got, ref, held) < TOL["bfloat16"]
    assert _rel_rows(got, ref, ~held) > TOL["bfloat16"]
    _check_routing(routing, "bfloat16")


def test_compressed_decode_matches_repro(J, model):
    arch, dtype, jcfg, tcfg, jp, tp, toks = model
    jnp = J.jnp
    with Routing(J, B) as routing:
        _, jc = J.T.forward_prefill(jcfg, jp, jnp.asarray(toks[:, :PROMPT]),
                                    max_len=MAX_LEN)
        _, tc = T.forward_prefill(tcfg, tp, _tok(toks, 0, PROMPT),
                                  max_len=MAX_LEN)
        jq = J.KV.compress_prefill_cache(jc)
        tq = KV.compress_prefill_cache(tc)
        assert _paths(J, tq) == _paths(J, jq)
        step = KV.make_compressed_decode_step(tcfg)
        for pos in range(PROMPT, MAX_LEN):
            jlg, jq = J.T.forward_decode(jcfg, jp, jnp.asarray(
                toks[:, pos:pos + 1]), jq, pos)
            tlg, tq = step(tp, {"token": _tok(toks, pos, pos + 1),
                                "cache": tq, "pos": pos})
            assert _rel_rows(tlg, jlg, routing.held()) < TOL[dtype], \
                (arch, pos)
    _check_routing(routing, dtype)


def test_params_and_caches_cross_with_repros_paths_and_dtypes(J, model):
    """The port's own init and zero cache have ``repro``'s tree: the same
    paths, shapes and dtypes (the f32 router, mLSTM gate projection and
    states, the conv taps in the model's dtype); carried across, the JAX
    trees keep every dtype."""
    arch, dtype, jcfg, tcfg, jp, tp, _ = model
    tdt = getattr(torch, dtype)
    own = T.init_params(tcfg, 0, dtype=tdt, device=CPU)
    assert _paths(J, own) == _paths(J, jp) == _paths(J, tp)
    jcache = J.T.init_decode_cache(jcfg, B, MAX_LEN,
                                   dtype=getattr(J.jnp, dtype))
    tcache = T.init_decode_cache(tcfg, B, MAX_LEN, tdt, CPU)
    assert _paths(J, tcache) == _paths(J, jcache)
    carried = lm_cache_from_numpy(_np_tree(J, jcache), CPU)
    assert _paths(J, carried) == _paths(J, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_params_on_meta_match_the_jax_tree(J, arch):
    """init_params at full width and depth on the meta device: every
    leaf's path, shape and dtype equal the JAX package's."""
    cfg = get_config(arch)
    tp = T.init_params(cfg, device=torch.device("meta"))
    jshape = J.jax.eval_shape(
        lambda: J.T.init_params(J.get_config(arch), J.jax.random.PRNGKey(0)))
    assert _paths(J, tp) == _paths(J, jshape)


@pytest.mark.parametrize("arch", ARCHS[2:])
def test_compression_keeps_recurrent_states_raw_as_copies(J, arch):
    """An RG-LRU {"h", "conv"}, an mLSTM {"C", "n", "m"} and an sLSTM
    {"h", "c", "n", "m"} entry pass compress_prefill_cache with their
    values and dtypes, as ``repro``'s, as copies: decoding the raw cache
    leaves the compressed one's states as they were."""
    tcfg = reduced_config(get_config(arch))
    tp = T.init_params(tcfg, 0, device=CPU)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (B, MAX_LEN))
    _, cache = T.forward_prefill(tcfg, tp, _tok(toks, 0, PROMPT),
                                 max_len=MAX_LEN)
    q = KV.compress_prefill_cache(cache)
    raw, kept = T.state_leaves(tcfg, cache), T.state_leaves(tcfg, q)
    assert raw and len(raw) == len(kept)
    kinds = {k for k in tcfg.pattern if k in T.STATE_KINDS}
    keys = {"rglru": ["conv", "h"], "mlstm": ["C", "m", "n"],
            "slstm": ["c", "h", "m", "n"]}
    for kind, entry in zip(tcfg.pattern, q["units"]):
        if kind in kinds:
            assert sorted(entry) == keys[kind]
    for a, b in zip(raw, kept):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert a.data_ptr() != b.data_ptr()
    before = [t.clone() for t in kept]
    T.forward_decode(tcfg, tp, _tok(toks, PROMPT, PROMPT + 1), cache, PROMPT)
    assert all(torch.equal(a, b) for a, b in zip(kept, before))
    assert not all(torch.equal(a, b) for a, b in zip(raw, before))
    jcfg = J.reduced_config(J.get_config(arch))
    jc = J.T.init_decode_cache(jcfg, B, MAX_LEN)
    assert _paths(J, J.KV.compress_prefill_cache(jc)) == \
        _paths(J, KV.compress_prefill_cache(
            T.init_decode_cache(tcfg, B, MAX_LEN, device=CPU)))


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_warm_up_equals_the_step_bit_for_bit(arch, compressed):
    """A captured step runs the step once to warm up, then replays it: the
    warm-up must leave the recurrent states as it found them (attention
    entries it writes are rewritten alike), so warm-up then step equals
    the step alone, logits and every cache leaf bit for bit, and the
    states move once a step, in place."""
    cfg = reduced_config(get_config(arch))
    tp = T.init_params(cfg, 0, device=CPU)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, MAX_LEN))
    _, cache = T.forward_prefill(cfg, tp, _tok(toks, 0, PROMPT),
                                 max_len=MAX_LEN)
    decode = make_decode_step(cfg)
    if compressed:
        cache = KV.compress_prefill_cache(cache)
        decode = KV.make_compressed_decode_step(cfg)
    other = _clone(cache)
    states = T.state_leaves(cfg, cache)
    for pos in range(PROMPT, MAX_LEN):
        tok = _tok(toks, pos, pos + 1)
        batch = {"token": tok, "cache": cache, "pos": pos}
        before = [t.clone() for t in states]
        warm_up(cfg, decode, tp, batch)
        assert all(torch.equal(a, b) for a, b in zip(states, before))
        got, out = decode(tp, batch)
        want, other = decode(tp, {"token": tok, "cache": other, "pos": pos})
        assert out is cache and torch.equal(got, want), pos
        assert all(torch.equal(a, b)
                   for a, b in zip(_leaves(cache), _leaves(other)))
    assert [t.data_ptr() for t in T.state_leaves(cfg, cache)] == \
        [t.data_ptr() for t in states]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def test_attention_layers_of_the_full_models():
    """The kernels' launches a full-size run expects: one B10 a prefill
    and one B11 a compressed decode step per attention layer (the
    remainder of recurrentgemma's 26 = 8 x 3 + 2 is two RG-LRU layers)."""
    for arch, n in ATTN_LAYERS.items():
        cfg = get_config(arch)
        assert sum(k in T.ATTN_KINDS for k in cfg.layer_kinds()) == n, arch
    rg = get_config("recurrentgemma-2b")
    assert (rg.n_units, rg.n_remainder) == (8, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_reduced_model_on_the_card_matches_cpu(arch):
    """The reduced model on the card (kernels) against the same weights on
    the CPU (plain versions): prefill and compressed decode within the
    bf16 bound; one B10 a prefill and one B11 a step per attention layer;
    the step captured as a CUDA graph replays bit for bit the eager step
    from a copy of the same cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_dequant_attention as kd
    from repro_torch.serving import CapturedDecodeStep
    cfg = reduced_config(get_config(arch))
    card = torch.device("cuda", 0)
    tp = T.init_params(cfg, 0, device=CPU)
    cp = _to(tp, card)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, MAX_LEN))
    n_attn = sum(k in T.ATTN_KINDS for k in cfg.layer_kinds())
    decode = KV.make_compressed_decode_step(cfg)
    runs = []
    for params, dev in ((tp, CPU), (cp, card)):
        fa.reset_launch_counts()
        kd.reset_launch_counts()
        lp, cache = T.forward_prefill(cfg, params,
                                      _tok(toks, 0, PROMPT).to(dev),
                                      max_len=MAX_LEN)
        qc = KV.compress_prefill_cache(cache)
        spare = _clone(qc)
        out = [lp.cpu()]
        for pos in range(PROMPT, MAX_LEN):
            lg, qc = decode(params, {"token": _tok(toks, pos, pos + 1)
                                     .to(dev), "cache": qc, "pos": pos})
            out.append(lg.cpu())
        runs.append(out)
    assert fa.launch_counts["flash_attention"] == n_attn
    assert kd.launch_counts["kv_dequant_decode_attention"] == n_attn * STEPS
    for a, b in zip(*runs):
        assert float((a - b).abs().max()) < TOL["bfloat16"] * float(
            a.abs().max())
    step = CapturedDecodeStep(cfg, decode, cp, spare)
    for i, pos in enumerate(range(PROMPT, MAX_LEN)):
        got = step(_tok(toks, pos, pos + 1).to(card), pos)
        assert torch.equal(got.cpu(), runs[1][i + 1]), pos
    assert step.launches().get("kv_dequant_decode_attention", 0) == \
        n_attn * STEPS


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)
