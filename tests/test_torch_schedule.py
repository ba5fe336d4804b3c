"""execute_schedule_batched: the port against the JAX package on the same
compiled schedule, planes and operands (rtol 1e-5, atol 1e-6: full f32 on
both sides, summed in a different order)."""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from repro.core import schedule as jsched
from repro_torch.core import schedule as tsched
from repro_torch.interop import to_device

CPU = torch.device("cpu")

RTOL, ATOL = 1e-5, 1e-6
NV = 7

# hand-made stage plans, each pinned to the op kinds it must compile to
PLANS = {
    "gemm": ((((0, 1), False),), {"GemmOp"}),
    "gemm_bmap": ((((1, 0), False),), {"GemmOp"}),
    "mid_gemm": ((((4, 5), False),), {"MidGemmOp"}),
    "mid_gemm_bmap": ((((5, 4), False),), {"MidGemmOp"}),
    "transpose_gemm": ((((0, 3, 5), False),), {"TransposeOp", "GemmOp"}),
    "diag_minor": ((((0, 1), True),), {"DiagOp"}),
    "diag_block_mid": ((((3, 2), True),), {"DiagOp"}),
    "diag_scattered": ((((0, 4, 6), True),), {"DiagOp"}),
    "mixed": ((((0, 2), False), ((1, 0), True), ((5, 6), False),
               ((3, 5), True), ((2, 4, 6), False), ((0, 6), True),
               ((1, 3), False)),
              {"TransposeOp", "GemmOp", "MidGemmOp", "DiagOp"}),
}


def _unitary(rng, K):
    z = rng.standard_normal((K, K)) + 1j * rng.standard_normal((K, K))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _operands(plan, lanes, seed):
    """Per-lane stage operands as the engine stages them: stacked re/im
    planes of random unitaries (dense) or random phases (diagonal)."""
    rng = np.random.default_rng(seed)
    mats = []
    for vqubits, diag in plan:
        K = 1 << len(vqubits)
        per_lane = []
        for _ in range(lanes):
            u = (np.exp(1j * rng.uniform(0, 2 * np.pi, K)) if diag
                 else _unitary(rng, K))
            per_lane.append(np.stack([u.real, u.imag]))
        mats.append(np.stack(per_lane).astype(np.float32))
    planes = rng.standard_normal((lanes, 2, 1 << NV)).astype(np.float32)
    return planes, mats


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_execute_schedule_batched_matches_repro(name, lanes, use_kernel):
    plan, kinds = PLANS[name]
    js = jsched.compile_schedule(plan, NV)
    ts = tsched.compile_schedule(plan, NV)
    assert [repr(op) for op in js.ops] == [repr(op) for op in ts.ops]
    assert {type(op).__name__ for op in ts.ops} == kinds
    if name == "diag_scattered":
        assert ts.ops[0].block is None
    if name in ("gemm_bmap", "mid_gemm_bmap"):
        assert ts.ops[0].bmap is not None
    if name == "diag_block_mid":
        assert ts.ops[0].block is not None and not ts.ops[0].minor

    planes, mats = _operands(plan, lanes, seed=len(name) + lanes)
    want = np.asarray(jsched.execute_schedule_batched(
        js, jnp.asarray(planes), [jnp.asarray(m) for m in mats],
        use_kernel=use_kernel, interpret=True))
    got = tsched.execute_schedule_batched(
        ts, to_device(planes, CPU), to_device(mats, CPU),
        use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["mixed", "gemm_bmap", "diag_scattered"])
def test_stride0_operands_match_materialised_ones(name):
    """A single-lane wave expands one operand set over W rows with stride
    0; the result equals the materialised broadcast in the JAX package."""
    plan, _ = PLANS[name]
    W = 3
    planes, mats = _operands(plan, W, seed=11)
    one = [m[:1] for m in mats]
    js = jsched.compile_schedule(plan, NV)
    want = np.asarray(jsched.execute_schedule_batched(
        js, jnp.asarray(planes),
        [jnp.broadcast_to(jnp.asarray(m), (W,) + m.shape[1:]) for m in one],
        use_kernel=True, interpret=True))
    tmats = [torch.from_numpy(m).expand((W,) + m.shape[1:]) for m in one]
    assert all(m.stride(0) == 0 for m in tmats)
    got = tsched.execute_schedule_batched(
        tsched.compile_schedule(plan, NV), torch.from_numpy(planes.copy()),
        tmats, use_kernel=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_result_is_written_into_the_donated_planes():
    plan, _ = PLANS["mixed"]
    planes, mats = _operands(plan, 2, seed=3)
    buf = torch.from_numpy(planes.copy())
    out = tsched.execute_schedule_batched(
        tsched.compile_schedule(plan, NV), buf,
        [torch.from_numpy(m) for m in mats], use_kernel=True)
    assert out.data_ptr() == buf.data_ptr()
