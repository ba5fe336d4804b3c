"""Recurrent layers (ROADMAP A12d): ``repro_torch.models.recurrent``
(RG-LRU) and ``repro_torch.models.xlstm`` (mLSTM, sLSTM) against
``repro``'s on reduced recurrentgemma-2b and xlstm-125m widths (d 64,
width 64, 4 heads of 16), ``repro``'s weights carried across by
``lm_params_from_numpy`` and the same numpy-seeded activations (B 2, S
20): the full-sequence pass with its final state, one decode step from
``repro``'s state, and, on the port alone, a 12-token prefill followed by
8 decode steps against one 20-token pass.

``rglru_full``'s scan is a doubling scan where ``repro`` runs
``jax.lax.associative_scan``: the two combine in other trees.

Tolerances (measured on a CPU container over 3 seeds, held at about 4x).
In f32 the port computes ``repro``'s function: outputs and states within
1.2e-6·max|ref| (the RG-LRU's final state 2.9e-8), held at 5e-6; prefill
then decode against the longer pass within 1.2e-6, held at 5e-6.  In
bf16, the dtype served, the projections round in another order than
XLA's: outputs 0.27% to 0.77% apart, held at the serving slice's 2e-2;
the f32 states within 1.1e-6, held at 5e-6."""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import recurrent as R
from repro_torch.models import xlstm as X

CPU = torch.device("cpu")
B, S, PROMPT = 2, 20, 12
OUT_TOL = {"float32": 5e-6, "bfloat16": 2e-2}
STATE_TOL = 5e-6
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models import recurrent as JR
    from repro.models import xlstm as JX
    from repro.models.layers import Param
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jget,
                                 reduced_config=jreduced, R=JR, X=JX,
                                 Param=Param)


def _setup(J, arch, init, dtype, seed=0):
    """(JAX cfg, port cfg, JAX params, port params, JAX x, port x)."""
    jcfg = J.reduced_config(J.get_config(arch))
    tcfg = reduced_config(get_config(arch))
    jdt = getattr(J.jnp, dtype)
    jp = init(J.Param(J.jax.random.PRNGKey(seed)), jcfg, dtype=jdt)
    tp = lm_params_from_numpy(J.jax.tree.map(np.asarray, jp), CPU)
    x = J.jnp.asarray(np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)), jdt)
    return jcfg, tcfg, jp, tp, x, _t(x)


def _t(a):
    return lm_cache_from_numpy(np.asarray(a), CPU)


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = want.float().numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_linear_scan_equals_the_sequential_recurrence():
    """The doubling scan against h_t = a_t h_{t-1} + b_t in f64, at
    lengths that are and are not powers of two."""
    g = torch.Generator().manual_seed(0)
    for n in (1, 2, 7, 16, 37):
        a = torch.rand((3, n, 5), generator=g)
        b = torch.randn((3, n, 5), generator=g)
        h, want = torch.zeros((3, 5), dtype=torch.float64), []
        for t in range(n):
            h = a[:, t].double() * h + b[:, t].double()
            want.append(h)
        got = R._linear_scan(a, b)
        assert got.dtype == torch.float32 and got.shape == (3, n, 5)
        assert _rel(got.double(), torch.stack(want, 1)) < 1e-6, n


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_full_and_decode_match_repro(J, dtype):
    jcfg, tcfg, jp, tp, x, tx = _setup(J, "recurrentgemma-2b",
                                       J.R.init_rglru_params, dtype)
    jo, (jh, jc) = J.R.rglru_full(x, jp, jcfg)
    to, (th, tc) = R.rglru_full(tx, tp, tcfg)
    assert to.dtype == tx.dtype and th.dtype == torch.float32
    assert tc.dtype == tx.dtype and tuple(tc.shape) == jc.shape
    assert _rel(to, jo) < OUT_TOL[dtype]
    assert _rel(th, jh) < STATE_TOL
    np.testing.assert_array_equal(tc.float().numpy(),
                                  np.asarray(jc, np.float32))
    x1 = x[:, :1]
    jo1, jh1, jc1 = J.R.rglru_decode(x1, jp, jcfg, jh, jc)
    to1, th1, tc1 = R.rglru_decode(_t(x1), tp, tcfg, _t(jh), _t(jc))
    assert _rel(to1, jo1) < OUT_TOL[dtype]
    assert _rel(th1, jh1) < STATE_TOL
    np.testing.assert_array_equal(tc1.float().numpy(),
                                  np.asarray(jc1, np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_full_with_state_and_decode_match_repro(J, dtype):
    jcfg, tcfg, jp, tp, x, tx = _setup(J, "xlstm-125m",
                                       J.X.init_mlstm_params, dtype)
    jo, js = J.X.mlstm_full(x, jp, jcfg, want_state=True)
    to, ts = X.mlstm_full(tx, tp, tcfg, want_state=True)
    assert sorted(ts) == sorted(js) == ["C", "m", "n"]
    assert _rel(to, jo) < OUT_TOL[dtype]
    for key in ts:
        assert ts[key].dtype == torch.float32
        assert tuple(ts[key].shape) == js[key].shape
        assert _rel(ts[key], js[key]) < STATE_TOL, key
    assert X.mlstm_full(tx, tp, tcfg)[1] is None
    x1 = x[:, :1]
    jout = J.X.mlstm_decode(x1, jp, jcfg, js["C"], js["n"], js["m"])
    tout = X.mlstm_decode(_t(x1), tp, tcfg, *(_t(js[k]) for k in "Cnm"))
    assert _rel(tout[0], jout[0]) < OUT_TOL[dtype]
    for t, j in zip(tout[1:], jout[1:]):
        assert _rel(t, j) < STATE_TOL


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_full_and_decode_match_repro(J, dtype):
    jcfg, tcfg, jp, tp, x, tx = _setup(J, "xlstm-125m",
                                       J.X.init_slstm_params, dtype)
    jo, jc = J.X.slstm_full(x, jp, jcfg)
    to, tc = X.slstm_full(tx, tp, tcfg)
    assert _rel(to, jo) < OUT_TOL[dtype]
    for t, j in zip(tc, jc):
        assert t.dtype == torch.float32 and _rel(t, j) < STATE_TOL
    x1 = x[:, :1]
    jo1, jc1 = J.X.slstm_decode(x1, jp, jcfg, jc)
    to1, tc1 = X.slstm_decode(_t(x1), tp, tcfg, tuple(_t(a) for a in jc))
    assert _rel(to1, jo1) < OUT_TOL[dtype]
    for t, j in zip(tc1, jc1):
        assert _rel(t, j) < STATE_TOL


def _steps(decode, tx, state):
    outs = []
    for t in range(PROMPT, S):
        out, state = decode(tx[:, t:t + 1], state)
        outs.append(out)
    return torch.cat(outs, 1), state


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_prefill_then_decode_equals_one_longer_prefill(J, kind, dtype):
    """The port alone: a prefill of PROMPT tokens, its state, then one
    decode step a token, against one pass over all S tokens: the decoded
    outputs and the last state."""
    arch = "recurrentgemma-2b" if kind == "rglru" else "xlstm-125m"
    init = {"rglru": J.R.init_rglru_params, "mlstm": J.X.init_mlstm_params,
            "slstm": J.X.init_slstm_params}[kind]
    _, cfg, _, prm, _, tx = _setup(J, arch, init, dtype, seed=1)
    if kind == "rglru":
        full, (h, conv) = R.rglru_full(tx, prm, cfg)
        _, st = R.rglru_full(tx[:, :PROMPT], prm, cfg)
        got, st = _steps(lambda x, s: (lambda o, *n: (o, n))(
            *R.rglru_decode(x, prm, cfg, *s)), tx, st)
        want_state = (h, conv)
    elif kind == "mlstm":
        full, fs = X.mlstm_full(tx, prm, cfg, want_state=True)
        _, st = X.mlstm_full(tx[:, :PROMPT], prm, cfg, want_state=True)
        got, st = _steps(lambda x, s: (lambda o, *n: (o, n))(
            *X.mlstm_decode(x, prm, cfg, *s)),
            tx, tuple(st[k] for k in "Cnm"))
        want_state = tuple(fs[k] for k in "Cnm")
    else:
        full, want_state = X.slstm_full(tx, prm, cfg)
        _, st = X.slstm_full(tx[:, :PROMPT], prm, cfg)
        got, st = _steps(lambda x, s: X.slstm_decode(x, prm, cfg, s), tx, st)
    assert _rel(got, full[:, PROMPT:]) < OUT_TOL[dtype]
    for a, b in zip(st, want_state):
        assert a.dtype == b.dtype
        assert _rel(a, b) < (STATE_TOL if a.dtype == torch.float32
                             else OUT_TOL[dtype])


@pytest.mark.parametrize("arch,init,n", [
    ("recurrentgemma-2b", R.init_rglru_params, 8),
    ("xlstm-125m", X.init_mlstm_params, 6),
    ("xlstm-125m", X.init_slstm_params, 5)])
def test_params_stack_over_leading_axes(arch, init, n):
    """Each leaf with the stacking axes first; f32 where ``repro`` keeps
    f32 (Λ, the mLSTM's input/forget projection, the sLSTM's bias)."""
    cfg = reduced_config(get_config(arch))
    flat = init(torch.Generator().manual_seed(0), cfg, device=CPU)
    stacked = init(torch.Generator().manual_seed(0), cfg, device=CPU,
                   lead=(3,))
    assert len(flat) == n and sorted(flat) == sorted(stacked)
    for key, t in flat.items():
        assert stacked[key].shape == (3,) + t.shape, key
        assert stacked[key].dtype == t.dtype, key
    f32 = {k for k, t in flat.items() if t.dtype == torch.float32}
    assert f32 == {"lam", "w_if", "b_gates"} & set(flat)
