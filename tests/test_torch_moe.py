"""MoE (ROADMAP A12c): ``repro_torch.models.moe`` against
``repro.models.moe`` on reduced mixtral-8x22b (8 -> 4 experts, top-2) and
arctic-480b (128 -> 4 experts, top-2, dense residual branch), ``repro``'s
weights carried across by ``lm_params_from_numpy`` and the same
numpy-seeded activations.

The routing is framework-free: which expert slot holds which token is
compared exactly, as the (E, C) table of token ids that ``repro``'s
dispatch buffer holds (read at its ``_constrain`` hook, a no-op on one
device), at ``reduced_config``'s capacity factor 8 (no drops) and at the
production 1.25 with 96 tokens that share one direction, which skews the
routing as real hidden states do: 17 of the 192 choices drop.

Tolerances.  In f32 the port computes ``repro``'s function: measured
1.2e-7 to 2.4e-7·max|ref| on a CPU container (3 seeds, drops included),
held at 1e-6.  In bf16 the expert GEMMs round in another order than
XLA's: measured 0.55% to 0.78%, held at the serving slice's 2e-2."""
import types
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import moe as M
from repro_torch.models.mlp import mlp

CPU = torch.device("cpu")
ARCHS = ["mixtral-8x22b", "arctic-480b"]
TOL = {"float32": 1e-6, "bfloat16": 2e-2}
B, S = 2, 24
DROP_S = 48                    # 96 tokens at capacity factor 1.25


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models import moe as JM
    from repro.models.layers import Param
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jget,
                                 reduced_config=jreduced, M=JM, Param=Param)


def _layer(J, arch, dtype="bfloat16", capacity_factor=None, seq=S, seed=0,
           shared=0.0):
    """(JAX cfg, port cfg, JAX params, port params, JAX x, port x): x
    standard normal rows plus ``shared`` times one common normal row (a
    direction every token has, which skews the routing)."""
    jcfg = J.reduced_config(J.get_config(arch))
    tcfg = reduced_config(get_config(arch))
    if capacity_factor is not None:
        jcfg = jcfg.with_(moe=replace(jcfg.moe,
                                      capacity_factor=capacity_factor))
        tcfg = tcfg.with_(moe=replace(tcfg.moe,
                                      capacity_factor=capacity_factor))
    jdt = getattr(J.jnp, dtype)
    jp = J.M.init_moe_params(J.Param(J.jax.random.PRNGKey(seed + 1)), jcfg,
                             dtype=jdt)
    tp = lm_params_from_numpy(J.jax.tree.map(np.asarray, jp), CPU)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, seq, jcfg.d_model))
    x = J.jnp.asarray(x + shared * rng.standard_normal(jcfg.d_model), jdt)
    return jcfg, tcfg, jp, tp, x, lm_cache_from_numpy(np.asarray(x), CPU)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_repro(J, arch, dtype):
    jcfg, tcfg, jp, tp, x, tx = _layer(J, arch, dtype)
    want = J.M.moe_layer(x, jp, jcfg)
    got = M.moe_layer(tx, tp, tcfg)
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    assert _rel(got, want) < TOL[dtype]


def _repro_table(J, jcfg, jp, x, monkeypatch) -> np.ndarray:
    """The (E, C) token ids of ``repro``'s dispatch buffer (-1: empty),
    its rows matched to the input rows they copy."""
    seen = []

    def hook(a, *spec):
        seen.append(np.asarray(a))
        return a
    monkeypatch.setattr(J.M, "_constrain", hook)
    J.M.moe_layer(x, jp, jcfg)
    E = jcfg.moe.n_experts
    h = next(a for a in seen if a.ndim == 3 and a.shape[0] == E)
    xt = np.asarray(x).reshape(-1, x.shape[-1])
    rows = {r.tobytes(): i for i, r in enumerate(xt)}
    return np.array([[rows.get(r.tobytes(), -1) for r in h[e]]
                     for e in range(E)])


def _port_table(tcfg, tp, tx):
    """The port's (E, C) token ids and its dispatch's keep flags."""
    mc = tcfg.moe
    T_ = tx.shape[0] * tx.shape[1]
    C = M.capacity(T_, mc)
    _, ids = M.route(tx.reshape(T_, -1), tp["router"], mc.top_k)
    order, slot, keep = M.dispatch(ids, mc.n_experts, C)
    token = torch.arange(T_).repeat_interleave(mc.top_k)[order]
    table = torch.full((mc.n_experts * C + 1,), -1, dtype=torch.long)
    table[slot[keep]] = token[keep]
    return table[:-1].reshape(mc.n_experts, C).numpy(), keep


@pytest.mark.parametrize("capacity_factor,seq", [(None, S), (1.25, DROP_S)])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_matches_repro_slot_for_slot(J, arch, capacity_factor, seq,
                                              monkeypatch):
    """Expert ids, ranks within an expert and the kept and dropped
    choices: the port's table equal to ``repro``'s; at capacity factor
    1.25 some choices drop (reduced_config's 8 drops none)."""
    jcfg, tcfg, jp, tp, x, tx = _layer(J, arch, "float32", capacity_factor,
                                       seq, seed=2, shared=1.0)
    want = _repro_table(J, jcfg, jp, x, monkeypatch)
    got, keep = _port_table(tcfg, tp, tx)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if capacity_factor is None:
        assert bool(keep.all())
    else:
        assert not bool(keep.all())
        # the output too, where tokens dropped
        assert _rel(M.moe_layer(tx, tp, tcfg), J.M.moe_layer(x, jp, jcfg)) \
            < TOL["float32"]


@pytest.mark.parametrize("tokens,want", [(1, 4), (8, 4), (16, 5), (96, 30),
                                         (4096, 1280)])
def test_capacity_is_the_fair_share_floored_and_capped(tokens, want):
    mc = get_config("mixtral-8x22b").moe        # 8 experts, cf 1.25
    assert M.capacity(tokens, mc) == min(2 * tokens, want)


def test_dense_residual_adds_the_dense_branch(J):
    """Arctic: the output is the experts' plus ``mlp(x, dense)``, bit for
    bit the two computed apart; a model without the flag has no branch."""
    _, tcfg, _, tp, _, tx = _layer(J, "arctic-480b")
    assert tcfg.moe.dense_residual and "dense" in tp
    assert tp["dense"]["w_in"].shape == (tcfg.d_model, tcfg.moe.dense_d_ff)
    plain = tcfg.with_(moe=replace(tcfg.moe, dense_residual=False))
    experts = M.moe_layer(tx, {k: v for k, v in tp.items() if k != "dense"},
                          plain)
    assert torch.equal(M.moe_layer(tx, tp, tcfg),
                       experts + mlp(tx, tp["dense"], "silu"))
    mix = reduced_config(get_config("mixtral-8x22b"))
    assert "dense" not in M.init_moe_params(torch.Generator().manual_seed(0),
                                            mix, device=CPU)


def test_expert_stacks_init_one_matrix_at_a_time():
    """Leading axes, shapes, dtypes and the fan-in scale of the expert
    stacks (drawn a matrix at a time); the router stays f32."""
    cfg = reduced_config(get_config("mixtral-8x22b"))
    prm = M.init_moe_params(torch.Generator().manual_seed(0), cfg,
                            device=CPU, lead=(3,))
    E, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    assert prm["router"].shape == (3, d, E)
    assert prm["router"].dtype == torch.float32
    for key, shape, fan_in in (("w_in", (d, ff), d), ("w_gate", (d, ff), d),
                               ("w_out", (ff, d), ff)):
        w = prm[key]
        assert w.shape == (3, E) + shape and w.dtype == torch.bfloat16
        std = float(w.float().std())
        # N(0, 1) cut to (-2, 2) has std 0.880
        assert abs(std * fan_in ** 0.5 - 0.880) < 0.05, key
        assert not torch.equal(w[0, 0], w[0, 1])
