"""The two cross-attention models on the port (ROADMAP A12e) against the
JAX package: a reduced llama-3.2-vision-90b (10 layers, 2 units of 4
self-attention and 1 cross-attention layer, GQA 4/2 of hd 16, 8 image
tokens) through ``transformer``'s train, prefill, raw and compressed
decode, and a reduced whisper-large-v3 (2 encoder and 2 decoder layers,
4/2 heads of 16, 16 frames, ``dec_len`` 12) through ``encdec``'s.
``repro``'s weights are carried across by ``lm_params_from_numpy``, the
image embeddings, frames and tokens come from numpy seeds.  A 6-token
prompt and 6 decode steps run to position 11, past the 8 image tokens:
a cross cache is read whole at any pos and bounds none.

Tolerances (of max|ref|).  In f32 the port computes ``repro``'s function:
measured at most 7.0e-7 (vision) and 4.1e-7 (whisper) over train,
prefill, raw decode and the caches on a CPU container, held at 2e-6.
Compressed decode, each package quantizing its own f32 prefill cache,
reads 5.3e-7 where the codes agree; but one code at a rounding tie
(``quantize_kv``'s, ROADMAP queue C: XLA's ``log2`` is not correctly
rounded) puts the logits 6.4e-4 apart at the seed here (2.3e-3 at
another), so it is held at 1e-2, the compressed-decode bound of
``tests/test_torch_serving_slice.py``.  In bf16 whisper's 4 layers
measured at most 0.66%, held at 1e-2, the decoder-only slices' bound.
Vision's 10 layers of bf16 rounding in two frameworks' orders put the two
1.4% to 2.3% apart in train and prefill (3 seeds; 1.65% here, and 2.84% in
compressed decode), and ``repro``'s own bf16 run lies 1.1% to 1.7% from
its f32 run of the same weights, the port's 1.1% to 1.6%: held at 4e-2,
the bound of the deeper bf16 slices (``tests/test_torch_window_slice.py``,
``test_torch_hybrid_slice.py``).  Compressed codes are held to the
measured ``quantize_kv`` tolerance (``tests/test_torch_serving_slice.py``).
The ``cuda`` tests run both models on the card against the CPU and replay
each step as a CUDA graph, bit for bit the eager step; they skip without
a card."""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.serving import kvcache as KV
from repro_torch.serving import make_decode_step, make_prefill_step

CPU = torch.device("cpu")
VLM, AUDIO = "llama-3.2-vision-90b", "whisper-large-v3"
DTYPES = ["float32", "bfloat16"]
B, PROMPT, STEPS = 2, 6, 6
MAX_LEN = PROMPT + STEPS
TOL = {VLM: {"float32": 2e-6, "bfloat16": 4e-2},
       AUDIO: {"float32": 2e-6, "bfloat16": 1e-2}}
# vlm compressed decode from each package's own prefill (see the docstring)
COMPRESSED_TOL = {"float32": 1e-2, "bfloat16": 4e-2}
CODE_DIFF_SHARE = 2e-4         # tests/test_torch_serving_slice.py's


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models import encdec as JE
    from repro.models import transformer as JT
    from repro.serving import kvcache as JKV
    from repro.serving import step as JS
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jget,
                                 reduced_config=jreduced, T=JT, E=JE, KV=JKV,
                                 S=JS)


def _np(J, tree):
    return J.jax.tree.map(np.asarray, tree)


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _tok(toks, lo, hi=None):
    return torch.from_numpy(toks[:, lo:hi]).long()


def _model(J, arch, dt, seed):
    """(JAX cfg, port cfg, JAX params, port params, tokens, JAX source,
    port source): the source is the image embeddings (vlm) or the frames
    (audio), numpy-seeded, equal bit for bit in both packages."""
    jcfg = J.reduced_config(J.get_config(arch))
    tcfg = reduced_config(get_config(arch))
    key, jdt = J.jax.random.PRNGKey(seed), getattr(J.jnp, dt)
    init = J.E.init_encdec_params if arch == AUDIO else J.T.init_params
    jp = init(jcfg, key, jdt)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (B, MAX_LEN)).astype(np.int32)
    n_src = jcfg.encoder.n_frames if arch == AUDIO else jcfg.n_image_tokens
    src = J.jnp.asarray(rng.standard_normal((B, n_src, jcfg.d_model))
                        .astype(np.float32), jdt)
    return (jcfg, tcfg, jp, lm_params_from_numpy(_np(J, jp), CPU), toks, src,
            lm_params_from_numpy(np.asarray(src), CPU))


@pytest.fixture(scope="module", params=DTYPES)
def vlm(request, J):
    return (request.param,) + _model(J, VLM, request.param, 3)


@pytest.fixture(scope="module", params=DTYPES)
def audio(request, J):
    return (request.param,) + _model(J, AUDIO, request.param, 5)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_reduced_configs_are_the_slice_the_tests_name():
    v, a = reduced_config(get_config(VLM)), reduced_config(get_config(AUDIO))
    assert v.pattern == ("attn",) * 4 + ("cross_attn",)
    assert (v.n_layers, v.n_units, v.n_image_tokens, v.hd) == (10, 2, 8, 16)
    assert (a.family, a.n_layers, a.encoder.n_layers) == ("audio", 2, 2)
    assert (a.encoder.n_frames, a.encoder.dec_len, a.act) == (16, 12, "gelu")
    assert MAX_LEN == a.encoder.dec_len and MAX_LEN > v.n_image_tokens
    T.check_supported(v)
    with pytest.raises(ValueError, match="models.encdec"):
        T.check_supported(a)


def test_vlm_train_prefill_and_raw_decode_match_repro(J, vlm):
    dt, jcfg, tcfg, jp, tp, toks, jaux, taux = vlm
    jnp, tol = J.jnp, TOL[VLM][dt]
    want = J.T.forward_train(jcfg, jp, jnp.asarray(toks), jaux)
    assert _rel(T.forward_train(tcfg, tp, _tok(toks, 0), taux), want) < tol
    jlp, jc = J.T.forward_prefill(jcfg, jp, jnp.asarray(toks[:, :PROMPT]),
                                  jaux, max_len=MAX_LEN)
    tlp, tc = make_prefill_step(tcfg, max_len=MAX_LEN)(
        tp, {"tokens": _tok(toks, 0, PROMPT), "aux": taux})
    assert _rel(tlp, jlp) < tol
    cross = tc["units"][4]
    assert tuple(cross["k"].shape) == (2, B, 8, 2, 16)
    for jl, tl in zip(J.jax.tree.leaves(jc), _leaves(tc)):
        assert tuple(tl.shape) == jl.shape
        assert _rel(tl.float(), jl) < tol
    step = make_decode_step(tcfg)
    for pos in range(PROMPT, MAX_LEN):
        jlg, jc = J.T.forward_decode(jcfg, jp, jnp.asarray(
            toks[:, pos:pos + 1]), jc, pos)
        tlg, tc = step(tp, {"token": _tok(toks, pos, pos + 1), "cache": tc,
                            "pos": pos})
        assert _rel(tlg, jlg) < tol, (dt, pos)
    for jl, tl in zip(J.jax.tree.leaves(jc), _leaves(tc)):
        assert _rel(tl.float(), jl) < tol


def test_vlm_compressed_decode_matches_repro(J, vlm):
    """Compressed decode from each package's own prefill, through the
    self-attention and the cross-attention kernels' plain versions, past
    position n_image_tokens."""
    dt, jcfg, tcfg, jp, tp, toks, jaux, taux = vlm
    jnp = J.jnp
    _, jc = J.T.forward_prefill(jcfg, jp, jnp.asarray(toks[:, :PROMPT]),
                                jaux, max_len=MAX_LEN)
    _, tc = T.forward_prefill(tcfg, tp, _tok(toks, 0, PROMPT), taux,
                              max_len=MAX_LEN)
    jq, tq = J.KV.compress_prefill_cache(jc), KV.compress_prefill_cache(tc)
    assert "codes_k" in tq["units"][4] and "k" not in tq["units"][4]
    step = KV.make_compressed_decode_step(tcfg)
    for pos in range(PROMPT, MAX_LEN):
        jlg, jq = J.T.forward_decode(jcfg, jp, jnp.asarray(
            toks[:, pos:pos + 1]), jq, pos)
        tlg, tq = step(tp, {"token": _tok(toks, pos, pos + 1), "cache": tq,
                            "pos": pos})
        assert _rel(tlg, jlg) < COMPRESSED_TOL[dt], (dt, pos)


def test_vlm_compressed_leaves_match_repro(J):
    """Both packages compress the same (JAX, bf16) prefill cache, the
    cross entries among them: sign bytes equal, codes within one in a
    measured share, scales within 1 ulp."""
    jcfg, tcfg, jp, tp, toks, jaux, taux = _model(J, VLM, "bfloat16", 7)
    _, jc = J.T.forward_prefill(jcfg, jp, J.jnp.asarray(toks[:, :PROMPT]),
                                jaux, max_len=MAX_LEN)
    jq = J.KV.compress_prefill_cache(jc)
    tq = KV.compress_prefill_cache(lm_cache_from_numpy(_np(J, jc), CPU))
    n = diff = 0
    for jentry, tentry in zip(jq["units"], tq["units"]):
        assert sorted(jentry) == sorted(tentry)
        for key in jentry:
            j, t = np.asarray(jentry[key]), tentry[key].numpy()
            assert t.dtype == j.dtype and t.shape == j.shape, key
            if key.startswith("signs"):
                np.testing.assert_array_equal(t, j)
            elif key.startswith("codes"):
                d = np.abs(t.astype(np.int64) - j.astype(np.int64))
                assert d.max() <= 1, key
                n, diff = n + d.size, diff + int((d != 0).sum())
            else:
                ulp = np.abs(t.view(np.int32).astype(np.int64)
                             - j.view(np.int32).astype(np.int64))
                assert ulp.max() <= 1, key
    assert tq["units"][4]["codes_k"].shape[2] == jcfg.n_image_tokens
    assert diff <= CODE_DIFF_SHARE * n + 1


@pytest.mark.parametrize("compressed", [False, True])
def test_vlm_decode_past_the_image_tokens(compressed):
    """The cross cache (8 slots) bounds no pos: decode runs to max_len - 1
    with a host int and a device pos alike, and only the self-attention
    cache's length is checked."""
    cfg = reduced_config(get_config(VLM))
    params = T.init_params(cfg, 0, device=CPU)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (B, MAX_LEN))
    aux = torch.from_numpy(rng.standard_normal(
        (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)).bfloat16()
    _, cache = T.forward_prefill(cfg, params, _tok(toks, 0, 2), aux,
                                 max_len=MAX_LEN)
    if compressed:
        cache = KV.compress_prefill_cache(cache)
    for pos in range(2, MAX_LEN):
        assert T.check_decode_pos(cfg, cache, pos) == pos
        p = pos if pos % 2 else torch.tensor(pos, dtype=torch.int32)
        lg, cache = T.forward_decode(cfg, params, _tok(toks, pos, pos + 1),
                                     cache, p)
        assert bool(torch.isfinite(lg).all())
    assert MAX_LEN - 1 > cfg.n_image_tokens
    with pytest.raises(ValueError, match="do not fit"):
        T.check_decode_pos(cfg, cache, MAX_LEN)


def test_vlm_cross_cache_is_sized_by_the_image_tokens():
    cfg = reduced_config(get_config(VLM))
    c = T.init_decode_cache(cfg, B, MAX_LEN, device=CPU)
    assert tuple(c["units"][4]["k"].shape) == (2, B, 8, 2, 16)
    assert tuple(c["units"][0]["k"].shape) == (2, B, MAX_LEN, 2, 16)
    c = T.init_decode_cache(cfg, B, MAX_LEN, device=CPU, n_image_tokens=5)
    assert tuple(c["units"][4]["v"].shape) == (2, B, 5, 2, 16)
    params = T.init_params(cfg, 0, device=CPU)
    aux = torch.zeros((B, 3, cfg.d_model), dtype=torch.bfloat16)
    _, c = T.forward_prefill(cfg, params, torch.zeros((B, 4), dtype=torch.long),
                             aux, max_len=MAX_LEN)
    assert tuple(c["units"][4]["k"].shape) == (2, B, 3, 2, 16)


def test_encdec_train_prefill_and_decode_match_repro(J, audio):
    dt, jcfg, tcfg, jp, tp, toks, jfr, tfr = audio
    jnp, tol = J.jnp, TOL[AUDIO][dt]
    want = J.E.encdec_train(jcfg, jp, jfr, jnp.asarray(toks))
    got = E.encdec_train(tcfg, tp, tfr, _tok(toks, 0))
    assert got.dtype == torch.float32
    assert _rel(got, want) < tol
    jlp, jc = J.E.encdec_prefill(jcfg, jp, jfr, jnp.asarray(toks[:, :PROMPT]),
                                 max_len=MAX_LEN)
    tlp, tc = make_prefill_step(tcfg, max_len=MAX_LEN)(
        tp, {"frames": tfr, "tokens": _tok(toks, 0, PROMPT)})
    assert _rel(tlp, jlp) < tol
    assert sorted(tc) == sorted(jc) == ["k", "v", "xk", "xv"]
    for key in tc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert tc[key].dtype == getattr(torch, dt)
        assert _rel(tc[key].float(), jc[key]) < tol, key
    step = make_decode_step(tcfg)
    for pos in range(PROMPT, MAX_LEN):
        jlg, jc = J.E.encdec_decode(jcfg, jp, jnp.asarray(
            toks[:, pos:pos + 1]), jc, pos)
        tlg, tc = step(tp, {"token": _tok(toks, pos, pos + 1), "cache": tc,
                            "pos": pos})
        assert _rel(tlg, jlg) < tol, (dt, pos)
    for key in tc:
        assert _rel(tc[key].float(), jc[key]) < tol, key


def test_encdec_steps_are_repro_steps(J, audio):
    """The serving factories dispatch the "audio" family to encdec, as
    repro's do: the same functions, bit for bit, a device-tensor pos
    equal to a host int's."""
    dt, jcfg, tcfg, jp, tp, toks, jfr, tfr = audio
    assert J.S.make_prefill_step(jcfg) is not None
    lp, cache = E.encdec_prefill(tcfg, tp, tfr, _tok(toks, 0, PROMPT),
                                 max_len=MAX_LEN)
    lp2, cache2 = make_prefill_step(tcfg, max_len=MAX_LEN)(
        tp, {"frames": tfr, "tokens": _tok(toks, 0, PROMPT)})
    assert torch.equal(lp, lp2)
    step = make_decode_step(tcfg)
    for pos in range(PROMPT, PROMPT + 2):
        tok = _tok(toks, pos, pos + 1)
        a, _ = E.encdec_decode(tcfg, tp, tok, cache, pos)
        b, _ = step(tp, {"token": tok, "cache": cache2,
                         "pos": torch.tensor(pos, dtype=torch.int32)})
        assert torch.equal(a, b)
    for key in cache:
        assert torch.equal(cache[key], cache2[key])


def test_encdec_tree_matches_repro_at_full_size(J):
    """whisper-large-v3's parameter tree built on ``meta``: the same paths,
    shapes and dtypes as repro's, 32 + 32 layers, 1,534,602,240
    parameters (``param_count()`` counts 1,534,558,720)."""
    cfg = get_config(AUDIO)
    tp = E.init_encdec_params(cfg, device=torch.device("meta"))
    jcfg = J.get_config(AUDIO)
    jshape = J.jax.eval_shape(
        lambda: J.E.init_encdec_params(jcfg, J.jax.random.PRNGKey(0)))
    jl = J.jax.tree_util.tree_flatten_with_path(jshape)[0]
    tl = J.jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_, j) in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    assert sum(t.numel() for _, t in tl) == 1_534_602_240
    assert cfg.param_count() == 1_534_558_720


def test_vlm_tree_matches_repro_cut_to_ten_layers(J):
    """llama-3.2-vision-90b at full width cut to 10 of its 100 layers (2
    units of 4 self- and 1 cross-attention layer, as the smoke serves it)
    on ``meta``: repro's tree, 10,657,898,496 parameters
    (``param_count()`` 10,657,890,304)."""
    cfg = get_config(VLM).with_(n_layers=10)
    tp = T.init_params(cfg, device=torch.device("meta"))
    jcfg = J.get_config(VLM).with_(n_layers=10)
    jshape = J.jax.eval_shape(
        lambda: J.T.init_params(jcfg, J.jax.random.PRNGKey(0)))
    jl = J.jax.tree_util.tree_flatten_with_path(jshape)[0]
    tl = J.jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_, j) in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    assert sum(t.numel() for _, t in tl) == 10_657_898_496
    assert cfg.param_count() == 10_657_890_304


def test_encdec_refuses_what_repro_lacks():
    """No compressed encoder-decoder step (repro decodes whisper on raw
    caches), pos within the decoder's cache."""
    cfg = reduced_config(get_config(AUDIO))
    with pytest.raises(ValueError, match="raw caches"):
        KV.make_compressed_decode_step(cfg)
    cache = E.init_encdec_cache(cfg, B, MAX_LEN, 16, device=CPU)
    assert (tuple(cache["k"].shape), tuple(cache["xk"].shape)) == \
        ((2, B, MAX_LEN, 2, 16), (2, B, 16, 2, 16))
    assert E.check_decode_pos(cfg, cache, MAX_LEN - 1) == MAX_LEN - 1
    for bad in (MAX_LEN, -1, 2.5, True):
        with pytest.raises(ValueError):
            E.check_decode_pos(cfg, cache, bad)
    with pytest.raises(ValueError, match="0-d int32"):
        E.decode_pos(cfg, cache, torch.tensor([3]), CPU)
    assert E.state_leaves(cfg, cache) == []


def test_interop_carries_the_cross_models_trees(J):
    """The encdec parameter tree, the image embeddings, and the vlm's
    raw and compressed caches (cross entries included) cross bit for bit,
    dtypes kept, as writable copies."""
    jcfg, tcfg, jp, tp, toks, jaux, taux = _model(J, VLM, "bfloat16", 2)
    np.testing.assert_array_equal(taux.view(torch.int16).numpy(),
                                  np.asarray(jaux).view(np.int16))
    _, jc = J.T.forward_prefill(jcfg, jp, J.jnp.asarray(toks[:, :PROMPT]),
                                jaux, max_len=MAX_LEN)
    for tree in (jc, J.KV.compress_prefill_cache(jc)):
        got = lm_cache_from_numpy(_np(J, tree), CPU)
        for jl, tl in zip(J.jax.tree.leaves(tree), _leaves(got)):
            j = np.asarray(jl)
            if j.dtype.name == "bfloat16":
                assert tl.dtype == torch.bfloat16
                np.testing.assert_array_equal(tl.view(torch.int16).numpy(),
                                              j.view(np.int16))
            else:
                np.testing.assert_array_equal(tl.numpy(), j)
    acfg = J.reduced_config(J.get_config(AUDIO))
    ja = J.E.init_encdec_params(acfg, J.jax.random.PRNGKey(1))
    ta = lm_params_from_numpy(_np(J, ja), CPU)
    assert sorted(ta) == ["dec", "embed", "enc", "enc_norm", "final_norm"]
    for jl, tl in zip(J.jax.tree.leaves(ja), _leaves(ta)):
        assert str(tl.dtype).split(".")[-1] == str(jl.dtype)
        assert tuple(tl.shape) == jl.shape
    ta["embed"] += 1                     # writable, not the JAX buffer
    assert not np.array_equal(ta["embed"].float().numpy(),
                              np.asarray(ja["embed"], np.float32))


# -- on the card --------------------------------------------------------------

def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_cuda_reduced_model_on_the_card_matches_cpu(arch):
    """The reduced model on the card (kernels) against the same weights on
    the CPU (plain versions), within the bf16 bound; B10 once a prefill
    for each self-, cross- and encoder attention layer, B11 once a
    compressed step for each self- and cross-attention layer (whisper
    decodes raw: none); the step captured as a CUDA graph replays bit for
    bit the eager step from a copy of the same cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_dequant_attention as kd
    from repro_torch.serving import CapturedDecodeStep
    cfg = reduced_config(get_config(arch))
    card = torch.device("cuda", 0)
    audio = arch == AUDIO
    tp = (E.init_encdec_params(cfg, 0, device=CPU) if audio
          else T.init_params(cfg, 0, device=CPU))
    cp = _to(tp, card)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, MAX_LEN))
    n_src = cfg.encoder.n_frames if audio else cfg.n_image_tokens
    src = torch.from_numpy(rng.standard_normal((B, n_src, cfg.d_model))
                           .astype(np.float32)).bfloat16()
    if audio:
        n_b10 = cfg.encoder.n_layers + 2 * cfg.n_layers
        n_b11 = 0
        decode = make_decode_step(cfg)
    else:
        n_b10 = n_b11 = cfg.n_layers
        decode = KV.make_compressed_decode_step(cfg)
    prefill = make_prefill_step(cfg, max_len=MAX_LEN)
    runs = []
    for params, dev in ((tp, CPU), (cp, card)):
        fa.reset_launch_counts()
        kd.reset_launch_counts()
        batch = {"tokens": _tok(toks, 0, PROMPT).to(dev),
                 ("frames" if audio else "aux"): src.to(dev)}
        lp, cache = prefill(params, batch)
        if not audio:
            cache = KV.compress_prefill_cache(cache)
        spare = _clone(cache)
        out = [lp.cpu()]
        for pos in range(PROMPT, MAX_LEN):
            lg, cache = decode(params, {"token": _tok(toks, pos, pos + 1)
                                        .to(dev), "cache": cache,
                                        "pos": pos})
            out.append(lg.cpu())
        runs.append(out)
    assert fa.launch_counts["flash_attention"] == n_b10
    assert kd.launch_counts["kv_dequant_decode_attention"] == n_b11 * STEPS
    for a, b in zip(*runs):
        assert float((a - b).abs().max()) < TOL[VLM]["bfloat16"] * float(
            a.abs().max())
    step = CapturedDecodeStep(cfg, decode, cp, spare)
    for i, pos in enumerate(range(PROMPT, MAX_LEN)):
        got = step(_tok(toks, pos, pos + 1).to(card), pos)
        assert torch.equal(got.cpu(), runs[1][i + 1]), pos
    assert step.launches().get("kv_dequant_decode_attention", 0) == \
        n_b11 * STEPS
