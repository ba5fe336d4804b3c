"""The single-group stage compute: ``execute_schedule`` and the engine's
``_stage_fn`` (its scheduled, per-gate kernel and per-gate plain
branches) in the port against the JAX package's (Pallas in interpret
mode) on the same compiled schedule, planes and operands, and against
gate-by-gate dense application.

Tolerance rtol/atol 2e-4, that of ``tests/test_schedule.py``: full f32
on both sides, summed in another order.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as tengine
from repro_torch.core import schedule as tsched
from repro_torch.core.dense_engine import apply_matrix
from repro_torch.kernels import gate_apply as tga

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def jx():
    """The JAX package's side (skips where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import engine, schedule
    from repro.core.dense_engine import apply_matrix
    return jnp, schedule, engine, apply_matrix


def _unitary(rng, K):
    m = rng.standard_normal((K, K)) + 1j * rng.standard_normal((K, K))
    q, r = np.linalg.qr(m)
    return (q * (np.diag(r) / np.abs(np.diag(r)))).astype(np.complex64)


def _diag(rng, K):
    return np.exp(1j * rng.uniform(0, 2 * np.pi, K)).astype(np.complex64)


def _random_plan(seed):
    """The random stage plans of ``tests/test_schedule.py``."""
    r = np.random.default_rng(seed)
    nv = int(r.integers(4, 9))
    plan, gates = [], []
    for _ in range(int(r.integers(1, 7))):
        k = int(r.integers(1, min(4, nv) + 1))
        vq = tuple(int(q) for q in r.choice(nv, size=k, replace=False))
        diag = bool(r.random() < 0.4)
        plan.append((vq, diag))
        gates.append(_diag(r, 2 ** k) if diag else _unitary(r, 2 ** k))
    return tuple(plan), gates, nv


def _plane_mats(gates):
    return [np.stack([g.real, g.imag]).astype(np.float32) for g in gates]


def _amps(seed, nv):
    rng = np.random.default_rng(1000 + seed)
    return (rng.standard_normal(2 ** nv)
            + 1j * rng.standard_normal(2 ** nv)).astype(np.complex64)


def _dense(amps, plan, gates, nv):
    want = torch.from_numpy(amps)
    for (vq, diag), g in zip(plan, gates):
        want = apply_matrix(want, np.diag(g) if diag else g, vq, nv)
    return want.numpy()


def _check_schedule(jx, plan, gates, nv, amps, use_kernel):
    jnp, jsched, _, _ = jx
    js = jsched.compile_schedule(plan, nv)
    ts = tsched.compile_schedule(plan, nv)
    assert [repr(op) for op in js.ops] == [repr(op) for op in ts.ops]
    planes = np.stack([amps.real, amps.imag]).astype(np.float32)
    mats = _plane_mats(gates)
    want = np.asarray(jsched.execute_schedule(
        js, jnp.asarray(planes), [jnp.asarray(m) for m in mats],
        use_kernel=use_kernel, interpret=True))
    buf = torch.from_numpy(planes.copy())
    got = tsched.execute_schedule(ts, buf, [torch.from_numpy(m)
                                            for m in mats],
                                  use_kernel=use_kernel)
    assert got.data_ptr() == buf.data_ptr()     # written into the planes
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dense = _dense(amps, plan, gates, nv)
    np.testing.assert_allclose(got[0].numpy() + 1j * got[1].numpy(), dense,
                               **TOL)
    return ts


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_execute_schedule_matches_repro_on_random_plans(jx, seed,
                                                       use_kernel):
    plan, gates, nv = _random_plan(seed)
    _check_schedule(jx, plan, gates, nv, _amps(seed, nv), use_kernel)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("nv,vq", [(9, (7, 8)), (10, (6, 7, 8)),
                                   (9, (5, 4)), (10, (1, 2))])
def test_mid_gemm_takes_the_kernel_branch_when_inner_is_wide(jx, nv, vq,
                                                             use_kernel):
    """A dense gate on a contiguous axis block that is not minor-most
    compiles to a MidGemmOp; with use_kernel it runs gemm_planes_mid (its
    plain version here) at every inner width, narrow ones included, where
    the JAX package takes its Pallas kernel only for inner >= 128."""
    rng = np.random.default_rng(nv + sum(vq))
    plan = ((vq, False),)
    gates = [_unitary(rng, 2 ** len(vq))]
    sched = _check_schedule(jx, plan, gates, nv, _amps(nv, nv), use_kernel)
    (op,) = sched.ops
    assert isinstance(op, tsched.MidGemmOp)
    assert (op.inner >= 128) == (min(vq) >= 7)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("nv,k", [(9, 7), (10, 7), (9, 3)])
def test_minor_most_diagonal_takes_the_kernel_branch_when_wide(jx, nv, k,
                                                               use_kernel):
    """A diagonal gate on the k minor-most qubits in standard order is a
    minor DiagOp; with K >= 128 it runs diag_apply."""
    rng = np.random.default_rng(nv * k)
    plan = ((tuple(range(k)), True),)
    sched = _check_schedule(jx, plan, [_diag(rng, 2 ** k)], nv,
                            _amps(k, nv), use_kernel)
    (op,) = sched.ops
    assert isinstance(op, tsched.DiagOp) and op.minor
    assert ((1 << op.k) >= 128) == (k >= 7)


# -- the engine's single-group stage function, all three branches ------------

PLANS = [
    ((((0, 2), False), ((1, 0), True), ((5, 6), False), ((3, 5), True),
      ((2, 4, 6), False), ((0, 6), True), ((1, 3), False)), 7),
    ((((0,), False), ((0, 1), True), ((0, 2), True), ((1,), False),
      ((1, 2), True), ((2,), False)), 6),
]


@pytest.mark.parametrize("gate_schedule,use_kernel",
                         [(True, True), (True, False), (False, True),
                          (False, False)])
@pytest.mark.parametrize("which", range(len(PLANS)))
def test_stage_fn_branches_match_repro(jx, which, gate_schedule,
                                       use_kernel):
    jnp, _, jengine, j_apply_matrix = jx
    plan, nv = PLANS[which]
    rng = np.random.default_rng(which)
    gates = [_diag(rng, 2 ** len(vq)) if d else _unitary(rng, 2 ** len(vq))
             for vq, d in plan]
    amps = _amps(which, nv)
    planes = np.stack([amps.real, amps.imag]).astype(np.float32)
    if gate_schedule:
        mats = _plane_mats(gates)
    else:
        mats = [np.asarray(g, np.complex64) for g in gates]
    jfn = jengine._stage_fn(plan, nv, use_kernel, gate_schedule, True)
    want = np.asarray(jfn(jnp.asarray(planes),
                          *[jnp.asarray(m) for m in mats]))
    tfn = tengine._stage_fn(plan, nv, use_kernel, gate_schedule)
    assert tfn is tengine._stage_fn(plan, nv, use_kernel, gate_schedule)
    tga.reset_launch_counts()
    got = tfn(torch.from_numpy(planes.copy()),
              *[torch.from_numpy(m) for m in mats])
    assert sum(tga.launch_counts.values()) == 0     # CPU: plain versions
    assert got.shape == (2, 2 ** nv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dense = np.asarray(jnp.asarray(amps))
    for (vq, d), g in zip(plan, gates):
        dense = np.asarray(j_apply_matrix(jnp.asarray(dense),
                                          jnp.asarray(np.diag(g) if d else g),
                                          vq, nv))
    np.testing.assert_allclose(got[0].numpy() + 1j * got[1].numpy(), dense,
                               **TOL)


@pytest.mark.cuda
def test_cuda_execute_schedule_launches_the_gate_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    dev = torch.device("cuda", 0)
    nv = 12
    rng = np.random.default_rng(3)
    plan = (((0, 1), False), ((10, 11), False), (tuple(range(7)), True),
            ((3, 8), False))
    gates = [_diag(rng, 2 ** len(vq)) if d else _unitary(rng, 2 ** len(vq))
             for vq, d in plan]
    sched = tsched.compile_schedule(plan, nv)
    amps = _amps(0, nv)
    planes = torch.from_numpy(np.stack([amps.real, amps.imag])
                              .astype(np.float32))
    mats = [torch.from_numpy(m) for m in _plane_mats(gates)]
    want = tsched.execute_schedule(sched, planes.clone(), mats,
                                   use_kernel=True)
    tga.reset_launch_counts()
    got = tsched.execute_schedule(sched, planes.to(dev),
                                  [m.to(dev) for m in mats], use_kernel=True)
    torch.cuda.synchronize()
    assert tga.launch_counts["gemm_planes"] == 2
    assert tga.launch_counts["gemm_planes_mid"] == 1
    assert tga.launch_counts["diag_apply"] == 1
    assert tga.launch_counts["gemm_planes_batch"] == 0
    torch.testing.assert_close(got.cpu(), want, **TOL)
