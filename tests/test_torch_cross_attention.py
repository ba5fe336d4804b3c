"""Cross-attention on the port (ROADMAP A12e) against the JAX package:
``attention_cross`` from a source (its core B10 over T != S keys) and from
a cached (k, v) pair (a plain softmax), B10's plain version at T != S
against ``repro``'s softmax(q k^T) v, and a compressed cross entry's decode
(B11 over every slot at pos = T - 1) against ``repro``'s
dequantize-then-``attention_cross``.  Layers of the reduced
llama-3.2-vision-90b (GQA 4/2, hd 16, 8 image tokens) and whisper-large-v3
(4/2 heads of 16, 16 frames), and a qk-norm variant of the first; weights from
``repro``'s init carried across by ``lm_params_from_numpy``, inputs from
numpy seeds.

Tolerances (of max|ref|).  In f32 the port computes ``repro``'s function,
its products in another order: measured at most 3.6e-7 (a layer from a
source or a cache) and 6.5e-7 (B10's plain version), and 0 for the
compressed decode (whose K/V, p and output round to bf16 as ``repro``'s
do), over every case here on a CPU container; held at 2e-6.  In bf16 every
case here measured 0 (one layer: the attention cores round the
probabilities to bf16 as ``repro``'s do), held at 1e-2, the decoder-only
slices' bound for what the GEMMs' order may move.  The ``cuda`` tests
hold B10 at T != S on the card to its plain version, f32 within 2e-4 and
bf16 within 2^-8·max|v| plus one bf16 step (``chip_smoke.py``'s bounds);
they skip without a card."""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import attention as A
from repro_torch.serving import kvcache as KV

CPU = torch.device("cpu")
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-6, "bfloat16": 1e-2}
#: (arch, qk_norm): the two models' reduced layers and a qk-norm variant
LAYERS = [("llama-3.2-vision-90b", False), ("whisper-large-v3", False),
          ("llama-3.2-vision-90b", True)]
B, S = 2, 5
#: (S, T, Hq, G, hd): GQA and MHA, T above and below S, ragged T
SHAPES = [(5, 8, 4, 2, 16), (7, 37, 4, 4, 64), (130, 9, 8, 2, 32),
          (3, 150, 6, 3, 128)]


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models import attention as JA
    from repro.models.layers import Param
    from repro.serving import kvcache as JKV
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jget,
                                 reduced_config=jreduced, A=JA, Param=Param,
                                 KV=JKV)


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _layer(J, arch, qk_norm, dt, seed):
    """(JAX cfg, port cfg, JAX params, port params) of one attention
    layer of the reduced ``arch``."""
    jcfg = J.reduced_config(J.get_config(arch)).with_(qk_norm=qk_norm)
    tcfg = reduced_config(get_config(arch)).with_(qk_norm=qk_norm)
    jp = J.A.init_attn_params(J.Param(J.jax.random.PRNGKey(seed)), jcfg,
                              getattr(J.jnp, dt))
    return jcfg, tcfg, jp, lm_params_from_numpy(
        J.jax.tree.map(np.asarray, jp), CPU)


def _pair(J, shape, dt, seed):
    """A numpy-seeded array as (JAX, port) in ``dt``, equal bit for bit."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = J.jnp.asarray(x, getattr(J.jnp, dt))
    return jx, lm_params_from_numpy(np.asarray(jx), CPU)


def _n_src(cfg):
    return cfg.encoder.n_frames if cfg.encoder else cfg.n_image_tokens


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch,qk_norm", LAYERS)
def test_attention_cross_from_a_source_matches_repro(J, arch, qk_norm, dt):
    jcfg, tcfg, jp, tp = _layer(J, arch, qk_norm, dt, 11)
    jx, tx = _pair(J, (B, S, jcfg.d_model), dt, 12)
    jsrc, tsrc = _pair(J, (B, _n_src(jcfg), jcfg.d_model), dt, 13)
    jout, (jk, jv) = J.A.attention_cross(jx, jp, jcfg, kv_src=jsrc)
    tout, (tk, tv) = A.attention_cross(tx, tp, tcfg, kv_src=tsrc)
    assert tout.dtype == getattr(torch, dt)
    assert tuple(tk.shape) == jk.shape == (B, _n_src(jcfg),
                                           jcfg.n_kv_heads, jcfg.hd)
    assert _rel(tout.float(), jout) < TOL[dt]
    assert _rel(tk.float(), jk) < TOL[dt]
    assert _rel(tv.float(), jv) < TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch,qk_norm", LAYERS)
def test_attention_cross_from_a_cache_matches_repro(J, arch, qk_norm, dt):
    """Decode's form: one query row against a cached (k, v) pair, every
    slot attended, the pair handed back as it came."""
    jcfg, tcfg, jp, tp = _layer(J, arch, qk_norm, dt, 21)
    jx, tx = _pair(J, (B, 1, jcfg.d_model), dt, 22)
    kv_shape = (B, _n_src(jcfg), jcfg.n_kv_heads, jcfg.hd)
    jk, tk = _pair(J, kv_shape, dt, 23)
    jv, tv = _pair(J, kv_shape, dt, 24)
    jout, _ = J.A.attention_cross(jx, jp, jcfg, kv_cache=(jk, jv))
    tout, (k, v) = A.attention_cross(tx, tp, tcfg, kv_cache=(tk, tv))
    assert k is tk and v is tv
    assert tout.dtype == getattr(torch, dt)
    assert _rel(tout.float(), jout) < TOL[dt]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_flash_over_another_key_length_matches_repro(J, shape, dt):
    """B10's plain version, and its wrapper on CPU tensors, at T != S:
    ``repro``'s unmasked softmax(q k^T / sqrt(hd)) v in the GQA layout."""
    Sq, T, Hq, G, hd = shape
    cfg = J.reduced_config(J.get_config("llama-3.2-vision-90b")).with_(
        n_heads=Hq, n_kv_heads=G, head_dim=hd)
    jq, tq = _pair(J, (B, Sq, Hq, hd), dt, 31)
    jk, tk = _pair(J, (B, T, G, hd), dt, 32)
    jv, tv = _pair(J, (B, T, G, hd), dt, 33)
    probs = J.jax.nn.softmax(J.A._gqa_scores(jq, jk, cfg), axis=-1)
    want = np.asarray(J.A._gqa_out(probs, jv, cfg), np.float32)
    got = ref.flash_attention_gqa_ref(tq, tk, tv, causal=False)
    assert got.dtype == getattr(torch, dt)
    assert tuple(got.shape) == (B, Sq, Hq, hd)
    assert _rel(got.reshape(B, Sq, -1).float(), want) < TOL[dt]
    assert torch.equal(fa.flash_attention_gqa(tq, tk, tv, causal=False), got)


def test_masks_need_as_many_keys_as_queries():
    """causal and window are the self-attention's diagonal: over T != S
    keys the wrapper refuses them, on the CPU as on the card."""
    q = torch.zeros((1, 4, 2, 16))
    kv = torch.zeros((1, 6, 1, 16))
    with pytest.raises(ValueError, match="causal and window"):
        fa.flash_attention_gqa(q, kv, kv)
    with pytest.raises(ValueError, match="causal and window"):
        fa.flash_attention_gqa(q, kv, kv, causal=False, window=2)
    with pytest.raises(ValueError, match="do not form"):
        fa.flash_attention_gqa(q, kv[:, :0], kv[:, :0], causal=False)
    assert fa.flash_attention_gqa(q, kv, kv, causal=False).shape == q.shape


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch,qk_norm", LAYERS)
def test_compressed_cross_decode_matches_repro(J, arch, qk_norm, dt):
    """A compressed cross entry (repro's codes of the same k/v, carried
    across) decoded through B11's plain version at pos = T - 1 against
    repro's dequantize-to-bf16 then ``attention_cross``."""
    jcfg, tcfg, jp, tp = _layer(J, arch, qk_norm, dt, 41)
    jx, tx = _pair(J, (B, 1, jcfg.d_model), dt, 42)
    kv_shape = (B, _n_src(jcfg), jcfg.n_kv_heads, jcfg.hd)
    jk, _ = _pair(J, kv_shape, "bfloat16", 43)
    jv, _ = _pair(J, kv_shape, "bfloat16", 44)
    jq = {"k": J.KV.quantize_kv(jk), "v": J.KV.quantize_kv(jv)}
    kv = (J.KV.dequantize_kv(jq["k"]), J.KV.dequantize_kv(jq["v"]))
    jout, _ = J.A.attention_cross(jx, jp, jcfg, kv_cache=kv)
    qcache = {f"{f}_{key}": lm_params_from_numpy(np.asarray(jq[key][f]), CPU)
              for key in ("k", "v") for f in ("codes", "signs", "scale")}
    tout = KV.compressed_cross_decode(tx, tp, tcfg, qcache)
    assert tout.dtype == getattr(torch, dt)
    assert _rel(tout.float(), jout) < TOL[dt]


def test_the_last_slot_is_made_once_a_length_and_device():
    a = KV._last_slot(37, CPU)
    assert a is KV._last_slot(37, CPU)
    assert a.dtype == torch.int32 and a.dim() == 0 and int(a) == 36
    assert int(KV._last_slot(8, CPU)) == 7


# -- on the card --------------------------------------------------------------

#: (B, S, T, Hq, G, hd): ragged T over several tiles, GQA and MHA,
#: whisper's hd-64 cross shape, llama-vision's over 576 image tokens
CUDA_SHAPES = [(2, 64, 1500, 20, 20, 64), (1, 300, 77, 8, 1, 128),
               (2, 130, 576, 64, 8, 128), (1, 5, 3, 4, 2, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_flash_over_another_key_length_matches_its_plain_version(
        shape, dt):
    """B10 on the card at T != S (strided slices of one projection, no
    copy) against its plain version: f32 within 2e-4, bf16 within
    2^-8·max|v| plus one bf16 step; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    Bq, Sq, T, Hq, G, hd = shape
    g = torch.Generator(device="cuda:0").manual_seed(sum(shape))
    card = torch.device("cuda", 0)
    q = torch.randn((Bq, Sq, Hq + G, hd), generator=g, device=card)
    kv = torch.randn((Bq, T, 2 * G, hd), generator=g, device=card)
    q, kv = q.to(getattr(torch, dt)), kv.to(getattr(torch, dt))
    q, k, v = q[:, :, :Hq], kv[:, :, :G], kv[:, :, G:]
    before = fa.launch_counts["flash_attention"]
    got = fa.flash_attention_gqa(q, k, v, causal=False).float()
    assert fa.launch_counts["flash_attention"] == before + 1
    want = ref.flash_attention_gqa_ref(q, k, v, causal=False).float()
    diff = (got - want).abs()
    if dt == "float32":
        assert float(diff.max()) <= 2e-4
    else:
        atol = 2.0 ** -8 * float(v.float().abs().max())
        step = 2.0 ** -8 * torch.maximum(got.abs(), want.abs())
        assert bool((diff <= atol + step).all())
