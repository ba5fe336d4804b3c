"""B10 under autograd (ROADMAP A12f): ``FlashAttentionFn`` and its torch
backward ``flash_attention_gqa_bwd``.

The backward is held against autograd through the plain version
(``kernels/ref.py::flash_attention_gqa_ref``) and against ``jax.vjp`` of
``repro``'s attention core (``_gqa_scores``, the causal / window mask as
``attention_full`` builds it, ``jax.nn.softmax``, ``_gqa_out``): causal,
windowed and T != S, rep 1 to 8, hd 64 to 256, in f32 and bf16, from
numpy-seeded inputs.  Measured on a CPU container: f32 within 2.6e-7 of
max|g| of the plain version's autograd and 1.3e-6 of ``repro``'s, held at
2e-6 and 1e-5; bf16 within 5.6e-4 and 1.7e-3 (a bf16 step of one element
here and there: the backward takes each block's keys only, so its f32
sums run in another order), held at one bf16 step of the largest, 2^-7 ·
max|g|.  A fake card (the device check says cuda:0, the launch returns a
detached tensor as the real one does) shows the gradients reaching q, k
and v through the Function; the ``cuda`` tests run it on the card."""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

F32_REF, F32_JAX = 2e-6, 1e-5
BF16_TOL = 2.0 ** -7
#: (B, S, T, Hq, G, hd, causal, window)
CASES = [(2, 64, 64, 8, 8, 64, True, 0), (2, 64, 64, 8, 2, 64, True, 0),
         (1, 96, 96, 8, 1, 128, True, 0), (1, 80, 80, 4, 1, 256, True, 17),
         (2, 48, 30, 8, 2, 64, False, 0), (1, 70, 70, 4, 4, 128, False, 9),
         (1, 64, 64, 16, 2, 128, True, 0), (1, 40, 77, 8, 1, 256, False, 0)]
IDS = ["B{}S{}T{}H{}G{}d{}{}w{}".format(*c[:6], "c" if c[6] else "f", c[7])
       for c in CASES]


def _operands(case, dt: torch.dtype, seed: int = 0):
    """q, k, v, dout numpy-seeded, rounded to ``dt``."""
    B, S, T, Hq, G, hd = case[:6]
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, T, G, hd)).astype(np.float32)
            for _ in range(2))
    return [torch.from_numpy(x).to(dt) for x in (q, k, v, do)]


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def _ref_grads(q, k, v, do, causal, window):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ref.flash_attention_gqa_ref(*leaves, causal, window)
    return torch.autograd.grad(out, leaves, do)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_matches_the_plain_versions_autograd(case, dt):
    causal, window = case[6:]
    q, k, v, do = _operands(case, dt)
    got = fa.flash_attention_gqa_bwd(q, k, v, do, causal=causal,
                                     window=window)
    tol = F32_REF if dt == torch.float32 else BF16_TOL
    for g, want, t in zip(got, _ref_grads(q, k, v, do, causal, window),
                          (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _rel(g, want) <= tol


def test_small_query_blocks_give_the_whole_blocks_gradients(monkeypatch):
    """The query blocks (rows per block from BWD_BLOCK_BYTES) only change
    which keys a block reads: 5-row blocks equal one block within f32
    summation order, with the causal and window key ranges cut."""
    case = (2, 37, 37, 8, 2, 16, True, 6)
    q, k, v, do = _operands(case, torch.float32, seed=3)
    whole = fa.flash_attention_gqa_bwd(q, k, v, do, causal=True, window=6)
    monkeypatch.setattr(fa, "BWD_BLOCK_BYTES", 4 * 2 * 8 * 37 * 5)
    blocks = fa.flash_attention_gqa_bwd(q, k, v, do, causal=True, window=6)
    for a, b in zip(blocks, whole):
        assert _rel(a, b) <= F32_REF


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models import attention as JA
    return types.SimpleNamespace(jax=jax, jnp=jnp, A=JA)


def _jax_core(J, q, k, v, causal: bool, window: int):
    """``repro``'s attention core on (B, S, Hq, hd) / (B, T, G, hd)."""
    B, S, Hq, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    cfg = types.SimpleNamespace(n_kv_heads=G, n_rep=Hq // G)
    scores = J.A._gqa_scores(q, k, cfg)
    if causal or window:
        i = J.jnp.arange(S)[:, None]
        j = J.jnp.arange(T)[None, :]
        mask = (i >= j) if causal else J.jnp.ones((S, T), bool)
        if window:
            mask = mask & (i - j < window)
        scores = J.jnp.where(mask[None, None, None], scores, J.A.NEG_INF)
    probs = J.jax.nn.softmax(scores, axis=-1)
    return J.A._gqa_out(probs, v, cfg).reshape(B, S, Hq, hd)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_matches_jax_grad_of_repros_core(J, case, dt):
    causal, window = case[6:]
    ops = _operands(case, torch.float32)
    jops = [J.jnp.asarray(t.numpy(), getattr(J.jnp, dt)) for t in ops]
    _, vjp = J.jax.vjp(lambda a, b, c: _jax_core(J, a, b, c, causal,
                                                 window), *jops[:3])
    want = vjp(jops[3])
    tops = [torch.from_numpy(np.array(x.astype(J.jnp.float32)))
            .to(getattr(torch, dt)) for x in jops]
    got = fa.flash_attention_gqa_bwd(*tops[:3], tops[3], causal=causal,
                                     window=window)
    tol = F32_JAX if dt == "float32" else BF16_TOL
    for g, w in zip(got, want):
        assert _rel(g, torch.from_numpy(np.array(w.astype(
            J.jnp.float32)))) <= tol


@pytest.fixture
def fake_card(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors: the device check says
    cuda:0 and the "kernel" returns the plain version's output detached,
    a fresh tensor with no grad_fn, as the real launch's ``torch.empty``
    is; each call is recorded."""
    launches = []

    def launch(q, k, v, causal, window, dev):
        launches.append((tuple(q.shape), causal, window, dev))
        return ref.flash_attention_gqa_ref(q, k, v, causal, window).detach()
    monkeypatch.setattr(fa, "_cuda_device",
                        lambda ts, name: torch.device("cuda", 0))
    monkeypatch.setattr(fa, "_launch", launch)
    return launches


@pytest.mark.parametrize("window", [0, 5])
def test_gradients_reach_qkv_through_the_kernel(fake_card, window):
    """The silent cut this Function prevents: the launch's output carries
    no graph of its own, yet q, k and v get the plain version's
    gradients, with one launch (the forward's) and none in the
    backward."""
    case = (2, 24, 24, 8, 2, 32, True, window)
    q, k, v, do = _operands(case, torch.float32, seed=7)
    detached = fa._launch(q, k, v, True, window, torch.device("cuda", 0))
    assert detached.grad_fn is None                    # what a launch gives
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_gqa(*leaves, causal=True, window=window)
    assert out.grad_fn is not None and len(fake_card) == 2
    got = torch.autograd.grad(out, leaves, do)
    assert len(fake_card) == 2
    for g, want in zip(got, _ref_grads(q, k, v, do, True, window)):
        assert _rel(g, want) <= F32_REF


def test_tpu_signature_routes_through_the_function(fake_card):
    """``flash_attention`` (BH, S, hd) under grad goes through the same
    Function, as one kv head per row."""
    rng = np.random.default_rng(2)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((3, 20, 16))
                                    .astype(np.float32)) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*plain, True), plain,
                               do)
    assert len(fake_card) == 1
    for g, w in zip(got, want):
        assert _rel(g, w) <= F32_REF


def test_no_grad_keeps_the_plain_launch(fake_card):
    """Without grad, or with no operand requiring it, the Function
    launches once and its output carries no graph."""
    q, k, v, _ = _operands((1, 16, 16, 4, 2, 16, True, 0), torch.float32)
    out = fa.flash_attention_gqa(q, k, v)
    assert out.grad_fn is None and len(fake_card) == 1
    with torch.no_grad():
        out = fa.flash_attention_gqa(q.requires_grad_(), k, v)
    assert out.grad_fn is None and len(fake_card) == 2


def test_bf16_backward_splits_the_f32_operand():
    """``_split_tf32``: the head holds TF32's 10 mantissa bits, head +
    rest is x exactly."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                         .astype(np.float32)) * 1e3
    head, rest = fa._split_tf32(x)
    assert torch.equal(head + rest, x)
    assert not bool((head.view(torch.int32) & 0x1FFF).any())
    assert float((rest.abs() / x.abs()).max()) <= 2.0 ** -11


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_kernel_under_autograd_matches_the_plain_gradients(dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    dev = torch.device("cuda", 0)
    fa.reset_launch_counts()
    for case in CASES:
        causal, window = case[6:]
        q, k, v, do = (t.to(dev) for t in _operands(case, dt))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention_gqa(*leaves, causal=causal, window=window)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, leaves, do)
        want = _ref_grads(q, k, v, do, causal, window)
        tol = 1e-5 if dt == torch.float32 else BF16_TOL
        for g, w in zip(got, want):
            assert _rel(g, w) <= tol, case
    assert fa.launch_counts["flash_attention"] == len(CASES)
