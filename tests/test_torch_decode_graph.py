"""The decode step with ``pos`` on the device, the form a CUDA graph can
capture (ROADMAP A13): on the CPU a 0-d tensor ``pos`` gives the host-int
decode bit for bit, raw and compressed; the port's decode is held against
``repro``'s ``jax.jit(forward_decode)`` with ``pos`` traced, at the serving
slice's 2e-2·max|ref| bound; B11's in-kernel span rule (a Python model of
``kvdq_partial_kernel``'s arithmetic) covers [0, live) once for every live
in 1..T on a grid fixed from T; and neutral partials drop out of the plain
combine.  The `cuda`-marked cases capture the step on a card: replays equal
the eager step bit for bit, and the launches are the capture's times the
replays."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import kv_dequant_attention as kd
from repro_torch.kernels import ref
from repro_torch.models import transformer as T
from repro_torch.serving import CapturedDecodeStep, make_decode_step
from repro_torch.serving import kvcache as KV

CPU = torch.device("cpu")
LOGIT_RTOL = 2e-2              # tests/test_serving.py's bound between modes
B, S, STEPS = 2, 20, 4


def _tok(toks, lo, hi=None):
    return torch.from_numpy(toks[:, lo:hi]).long()


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


@pytest.fixture(scope="module")
def qwen():
    cfg = reduced_config(get_config("qwen3-4b"))
    params = T.init_params(cfg, 0, device=CPU)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    return cfg, params, toks


@pytest.mark.parametrize("compressed", [False, True])
def test_tensor_pos_equals_host_int_pos_bit_for_bit(qwen, compressed):
    cfg, params, toks = qwen
    _, cache = T.forward_prefill(cfg, params, _tok(toks, 0, S - STEPS),
                                 max_len=S)
    if compressed:
        cache = KV.compress_prefill_cache(cache)
    a, b = cache, _clone(cache)
    for i in range(STEPS):
        pos = S - STEPS + i
        tok = _tok(toks, pos, pos + 1)
        la, a = T.forward_decode(cfg, params, tok, a, pos)
        lb, b = T.forward_decode(cfg, params, tok, b,
                                 torch.tensor(pos, dtype=torch.int32))
        assert torch.equal(la, lb), pos
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)


def test_decode_pos_checks_its_form(qwen):
    cfg, params, toks = qwen
    _, cache = T.forward_prefill(cfg, params, _tok(toks, 0, 8), max_len=12)
    tok = _tok(toks, 8, 9)
    for bad in (torch.tensor(8), torch.tensor([8], dtype=torch.int32), -1,
                8.5):
        with pytest.raises(ValueError, match="pos must be"):
            T.forward_decode(cfg, params, tok, cache, bad)
    with pytest.raises(ValueError, match="do not fit"):
        T.forward_decode(cfg, params, tok, cache, 12)
    with pytest.raises(ValueError, match="CUDA"):
        CapturedDecodeStep(cfg, make_decode_step(cfg), params,
                           cache).capture(tok, 8)


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import types

    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models import transformer as JT
    from repro.serving import kvcache as JKV
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jget,
                                 reduced_config=jreduced, T=JT, KV=JKV)


@pytest.mark.parametrize("arch,dtype", [("qwen3-4b", "bfloat16"),
                                        ("gemma3-12b", "float32")])
@pytest.mark.parametrize("compressed", [False, True])
def test_tensor_pos_decode_matches_repro_jit_with_pos_traced(J, arch, dtype,
                                                             compressed):
    """repro's decode as examples/serve_lm.py runs it (jax.jit over
    forward_decode, pos a traced int32) against the port's with a 0-d
    tensor pos; gemma3's prompt is longer than its window, so its local
    layers' rings have wrapped.  gemma3 runs in f32: over its 12 layers the
    two packages' bf16 roundings alone drift 1.2% to 2.7% apart
    (tests/test_torch_window_slice.py), where f32 leaves the function."""
    jcfg = J.reduced_config(J.get_config(arch))
    tcfg = reduced_config(get_config(arch))
    jp = J.T.init_params(jcfg, J.jax.random.PRNGKey(5),
                         dtype=getattr(J.jnp, dtype))
    tp = lm_params_from_numpy(J.jax.tree.map(np.asarray, jp), CPU)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S)) \
        .astype(np.int32)
    start = S - STEPS - 4
    _, jc = J.T.forward_prefill(jcfg, jp, J.jnp.asarray(toks[:, :start]),
                                max_len=S)
    _, tc = T.forward_prefill(tcfg, tp, _tok(toks, 0, start), max_len=S)
    if compressed:
        jc, tc = J.KV.compress_prefill_cache(jc), KV.compress_prefill_cache(tc)
    decode = J.jax.jit(
        lambda p, tok, c, pos: J.T.forward_decode(jcfg, p, tok, c, pos))
    for pos in range(start, S):
        jlg, jc = decode(jp, J.jnp.asarray(toks[:, pos:pos + 1]), jc,
                         J.jnp.int32(pos))
        tlg, tc = T.forward_decode(tcfg, tp, _tok(toks, pos, pos + 1), tc,
                                   torch.tensor(pos, dtype=torch.int32))
        jlg = np.asarray(jlg)
        err = np.abs(tlg.numpy() - jlg).max()
        assert err < LOGIT_RTOL * np.abs(jlg).max(), (arch, pos, err)


@pytest.mark.parametrize("T_,tile,blocks,slots", [
    (4096, 128, 64, 264), (640, 128, 64, 264), (1100, 128, 64, 264),
    (1000, 128, 2, 264), (300, 16, 4, 5), (4096, 64, 64, 264),
    (1024, 64, 64, 264), (77, 32, 300, 264), (513, 128, 3, 264)])
def test_kernel_spans_cover_the_live_tokens_once_for_every_pos(T_, tile,
                                                               blocks, slots):
    """B11's grid is fixed from T (grid_splits); each block finds live =
    min(T, pos + 1) and its span by splits' rule (kernel_span, the
    kernel's arithmetic): for every live in 1..T the grid's spans cover
    [0, live) exactly once, the live ones are splits' own, and the rest
    are empty."""
    grid = kd.grid_splits(blocks, T_, slots, tile)
    assert 1 <= grid <= max(1, slots // blocks)
    for live in range(1, T_ + 1):
        n_split, span = kd.splits(blocks, live, slots, tile)
        assert n_split <= grid
        cover = np.zeros(live, np.int64)
        for s in range(grid):
            s0, s1 = kd.kernel_span(s, live, max(1, slots // blocks), tile)
            assert (s0, s1 > s0) == (s * span, s < n_split)
            cover[s0:s1] += 1
        assert (cover == 1).all(), (live, cover)


def test_neutral_partials_drop_out_of_the_plain_combine():
    """Partials of a span past the live tokens (m = NEG_INF, l = 0, acc =
    0), as the kernel writes them, leave the combined result bit for bit
    as it was, in any position; with a single live span the combine gives
    that span's acc / l."""
    g = torch.Generator().manual_seed(3)
    m = [torch.randn((6, 4, 1), generator=g) * 3 for _ in range(3)]
    l = [torch.rand((6, 4, 1), generator=g, dtype=torch.float64) + 0.5
         for _ in range(3)]
    acc = [torch.randn((6, 4, 32), generator=g, dtype=torch.float64)
           for _ in range(3)]
    neutral = (torch.full((6, 4, 1), ref.NEG_INF),
               torch.zeros((6, 4, 1), dtype=torch.float64),
               torch.zeros((6, 4, 32), dtype=torch.float64))
    want = ref.kv_combine_ref(m, l, acc)
    for at in (0, 1, 3):
        parts = [list(x) for x in (m, l, acc)]
        for p, n in zip(parts, neutral):
            p.insert(at, n)
            p.append(n)
        assert torch.equal(ref.kv_combine_ref(*parts), want)
    one = ref.kv_combine_ref([m[0], neutral[0]], [l[0], neutral[1]],
                             [acc[0], neutral[2]])
    torch.testing.assert_close(one, acc[0] / l[0], rtol=1e-15, atol=0)
    # no live span at all (pos < 0 read from memory): zeros, not NaN, as
    # the kernel's floor on the denominator gives
    none = ref.kv_combine_ref(*zip(*[neutral] * 2))
    assert torch.equal(none, torch.zeros_like(none))


def test_b11_plain_version_takes_a_tensor_pos():
    g = torch.Generator().manual_seed(4)
    cache = []
    for _ in range(2):
        qz = KV.quantize_kv(torch.randn((3, 50, 1, 32), generator=g))
        cache += [qz[f][:, :, 0] for f in ("codes", "signs", "scale")]
    q = torch.randn((3, 2, 32), generator=g)
    for pos in (0, 17, 49, 80):
        want = kd.kv_dequant_decode_attention(q, *cache, pos)
        got = kd.kv_dequant_decode_attention(
            q, *cache, torch.tensor(pos, dtype=torch.int32))
        assert torch.equal(got, want)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-12b"])
@pytest.mark.parametrize("compressed", [False, True])
def test_cuda_captured_step_equals_eager_bit_for_bit(card, arch, compressed):
    """The reduced model on the card: eager decode and CapturedDecodeStep
    from two copies of one cache, greedy, every step's logits and the
    final caches bit for bit; B11's launches are the capture's times the
    replays (and the Python counts moved only for the warm-up)."""
    from repro_torch.kernels import flash_attention as fa
    cfg = reduced_config(get_config(arch))
    params = T.init_params(cfg, 0, device=card)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, 12))).to(card)
    logits, cache = T.forward_prefill(cfg, params, toks, max_len=S)
    decode = make_decode_step(cfg)
    if compressed:
        cache = KV.compress_prefill_cache(cache)
        decode = KV.make_compressed_decode_step(cfg)
    eager, graphed = cache, _clone(cache)
    step = CapturedDecodeStep(cfg, decode, params, graphed)
    tok = logits.argmax(-1)[:, None]
    tok_e = tok_g = tok
    kd.reset_launch_counts()
    fa.reset_launch_counts()
    for i in range(S - 12):
        le, eager = decode(params, {"token": tok_e, "cache": eager,
                                    "pos": 12 + i})
        lg = step(tok_g, 12 + i)
        assert torch.equal(le, lg), i
        tok_e, tok_g = le.argmax(-1)[:, None], lg.argmax(-1)[:, None]
    for x, y in zip(_leaves(eager), _leaves(graphed)):
        assert torch.equal(x, y)
    n_b11 = cfg.n_layers if compressed else 0
    assert step.recorded["kv_dequant_decode_attention"] == n_b11
    assert step.recorded["flash_attention"] == 0
    assert step.launches()["kv_dequant_decode_attention"] == \
        n_b11 * (S - 12)
    # the eager steps and the warm-up
    assert kd.launch_counts["kv_dequant_decode_attention"] == \
        n_b11 * (S - 12 + 1)


@pytest.mark.cuda
def test_cuda_capture_that_meets_a_host_sync_raises(card):
    """A step that reads pos on the host cannot be captured: the capture
    raises rather than running eagerly."""
    cfg = reduced_config(get_config("qwen3-4b"))
    params = T.init_params(cfg, 0, device=card)
    toks = torch.zeros((B, 4), dtype=torch.long, device=card)
    _, cache = T.forward_prefill(cfg, params, toks, max_len=8)
    decode = make_decode_step(cfg)

    def syncing(p, batch):
        return decode(p, {**batch, "pos": int(batch["pos"])})

    step = CapturedDecodeStep(cfg, syncing, params, cache)
    with pytest.raises(RuntimeError):
        step(toks[:, :1], 4)


def _example(*args):
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    return subprocess.run(
        [sys.executable, os.path.join(root, "examples", "serve_lm_torch.py"),
         "--batch", "2", "--prompt-len", "12", "--gen", "3", *args],
        capture_output=True, text=True, env=env, timeout=600)


def test_example_serves_eagerly_on_the_cpu_and_asks_for_eager():
    out = _example("--device", "cpu", "--eager", "--compressed-kv",
                   "--arch", "gemma3-12b")
    assert out.returncode == 0, out.stderr
    assert "step=eager" in out.stdout and "compressed KV cache" in out.stdout
    assert len(out.stdout.split("request 0:")[1].strip()[1:-1]
               .split(",")) == 4
    refused = _example("--device", "cpu")
    assert refused.returncode == 2 and "--eager" in refused.stderr


@pytest.mark.cuda
def test_cuda_example_serves_with_the_captured_step(card):
    for extra in ((), ("--compressed-kv",)):
        out = _example("--arch", "gemma3-12b", *extra)
        assert out.returncode == 0, out.stderr
        assert "step=captured" in out.stdout
