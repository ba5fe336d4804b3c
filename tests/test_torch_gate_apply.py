"""gemm_planes_batch: the plain version against the JAX package's Pallas
kernel (interpret mode), the wrapper's dispatch rules, and — on a card —
the CUDA kernel against its plain version.

Tolerance rtol 1e-5, atol 1e-6: both sides are full f32, summed in a
different order.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gate_apply as tga
from repro_torch.kernels.ref import gemm_planes_batch_ref

RTOL, ATOL = 1e-5, 1e-6


def _inputs(L, R, K, broadcast, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, L, R, K)).astype(np.float32)
    u = (rng.standard_normal((1 if broadcast else L, 2, K, K))
         / np.sqrt(K)).astype(np.float32)
    return a, u


def _port_operands(a, u, L, device="cpu"):
    ar = torch.from_numpy(a[0]).to(device)
    ai = torch.from_numpy(a[1]).to(device)
    U = torch.from_numpy(u).to(device)
    if U.shape[0] == 1:
        U = U.expand(L, *U.shape[1:])           # one U, lane stride 0
    return ar, ai, U[:, 0].transpose(1, 2), U[:, 1].transpose(1, 2)


@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("K", [2, 4, 8, 16, 32, 128])
@pytest.mark.parametrize("broadcast", [False, True])
def test_plain_version_matches_pallas_interpret(L, K, broadcast):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.gate_apply import gemm_planes_batch as pallas_gemm

    R = 8 if K == 128 else 24
    a, u = _inputs(L, R, K, broadcast, seed=L * 1000 + K)
    ub = np.broadcast_to(u, (L,) + u.shape[1:])
    bt = np.swapaxes(ub, 2, 3)                  # U^T planes
    jr, ji = pallas_gemm(jnp.asarray(a[0]), jnp.asarray(a[1]),
                         jnp.asarray(bt[:, 0]), jnp.asarray(bt[:, 1]),
                         interpret=True)
    ar, ai, br, bi = _port_operands(a, u, L)
    if broadcast and L > 1:
        assert br.stride(0) == 0
    tr, ti = gemm_planes_batch_ref(ar, ai, br, bi)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL,
                               atol=ATOL)


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    a, u = _inputs(2, 16, 8, True, seed=1)
    ar, ai, br, bi = _port_operands(a, u, 2)
    tga.reset_launch_counts()
    cr, ci = tga.gemm_planes_batch(ar, ai, br, bi)
    rr, ri = gemm_planes_batch_ref(ar, ai, br, bi)
    assert torch.equal(cr, rr) and torch.equal(ci, ri)
    assert tga.launch_counts["gemm_planes_batch"] == 0


def test_a_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """Any device but the CPU goes to the kernel or raises: the plain
    version is not a fallback."""
    def boom(*args):
        raise AssertionError("plain version reached for a device tensor")

    monkeypatch.setattr(tga, "gemm_planes_batch_ref", boom)
    t = torch.empty((1, 4, 4), device="meta")
    b = torch.empty((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tga.gemm_planes_batch(t, t, b, b)


def test_wrapper_rejects_bad_shapes():
    a = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="do not form"):
        tga.gemm_planes_batch(a, a, torch.zeros((2, 4, 4)),
                              torch.zeros((2, 4, 4)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("L,R,K,broadcast", [
    (2, 1 << 17, 32, True), (2, 1 << 18, 16, True), (3, 5, 2, False),
    (1, 7, 4, True), (3, 33, 16, False), (2, 40, 64, True),
    (3, 9, 128, False)])
def test_cuda_kernel_matches_plain_version(cuda_device, L, R, K, broadcast):
    a, u = _inputs(L, R, K, broadcast, seed=K + R)
    ar, ai, br, bi = _port_operands(a, u, L, cuda_device)
    before = tga.launch_counts["gemm_planes_batch"]
    cr, ci = tga.gemm_planes_batch(ar, ai, br, bi)
    rr, ri = gemm_planes_batch_ref(ar, ai, br, bi)
    torch.cuda.synchronize()
    assert tga.launch_counts["gemm_planes_batch"] == before + 1
    torch.testing.assert_close(cr, rr, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(ci, ri, rtol=RTOL, atol=ATOL)
