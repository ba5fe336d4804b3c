"""gemm_planes_mid_batch: the lane-batched left contraction of the wave
path's MidGemmOp, ``C[l, o] = U[l]·A[l, o]`` over (L, O, K, I) re/im
planes, and the f32 pin of the products that stay library calls.

Its plain version against ``repro``'s batched einsum (the JAX package has
no Pallas kernel for it), the wrapper's dispatch and errors, both
executors with ``use_kernel=True`` against ``repro`` on the CPU,
``full_f32_products`` restoring the caller's TF32 flags — and, on a card,
the CUDA kernel against its plain version and row l of an L-lane call bit
for bit the one-lane call on row l's operands.

Tolerance: rtol 1e-5, atol 1e-6 (f32 sums of K <= 128 unit-scale terms
taken in another order).
"""
import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.core import schedule as tsched
from repro_torch.kernels import gate_apply as tga
from repro_torch.kernels import ref

TOL = dict(rtol=1e-5, atol=1e-6)
KS = [2, 4, 16, 32, 64, 128]


@pytest.fixture
def jnp():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    return jnp


def _operands(rng, L, O, K, I, broadcast):
    """Unit-scale A planes (L, O, K, I) and U planes (L, K, K): distinct U
    per lane, or one U at lane stride 0."""
    a = rng.standard_normal((2, L, O, K, I)).astype(np.float32)
    u = (rng.standard_normal((2, 1 if broadcast else L, K, K))
         / np.sqrt(K)).astype(np.float32)
    return a, np.broadcast_to(u, (2, L, K, K))


def _torch(a, u):
    ta = torch.from_numpy(np.ascontiguousarray(a))
    tu = torch.from_numpy(np.array(u[:, :1] if u.strides[1] == 0 else u))
    tu = tu.expand(2, a.shape[1], *tu.shape[2:])    # keeps lane stride 0
    return ta[0], ta[1], tu[0], tu[1]


# -- the plain version against repro's batched einsum ----------------------

@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("O,I", [(1, 256), (64, 8), (3, 2)])
@pytest.mark.parametrize("K", KS)
def test_plain_version_matches_repro_einsum(jnp, K, O, I, broadcast):
    rng = np.random.default_rng(K * 1000 + O * 10 + I + broadcast)
    L = 3
    a, u = _operands(rng, L, O, K, I, broadcast)

    def e(b, x):
        return jnp.einsum("ljk,loki->loji", b, x)
    ja, ju = jnp.asarray(a), jnp.asarray(u)
    jr = np.asarray(e(ju[0], ja[0]) - e(ju[1], ja[1]))
    ji = np.asarray(e(ju[0], ja[1]) + e(ju[1], ja[0]))
    ar, ai, ur, ui = _torch(a, u)
    if broadcast:
        assert ur.stride(0) == 0
    tga.reset_launch_counts()
    cr, ci = tga.gemm_planes_mid_batch(ar, ai, ur, ui)
    assert tga.launch_counts["gemm_planes_mid_batch"] == 0  # CPU: plain
    np.testing.assert_allclose(cr.numpy(), jr, **TOL)
    np.testing.assert_allclose(ci.numpy(), ji, **TOL)
    # lane l is the single-group contraction of lane l's operands
    for lane in range(L):
        sr, si = ref.gemm_planes_mid_ref(ar[lane], ai[lane], ur[lane],
                                         ui[lane])
        torch.testing.assert_close(cr[lane], sr, **TOL)
        torch.testing.assert_close(ci[lane], si, **TOL)


# -- dispatch and errors -----------------------------------------------------

def test_a_non_cpu_non_cuda_tensor_raises(monkeypatch):
    def boom(*args):
        raise AssertionError("plain version reached for a device tensor")

    monkeypatch.setattr(tga, "gemm_planes_mid_batch_ref", boom)
    m = torch.device("meta")
    a4 = torch.empty((2, 1, 4, 8), device=m)
    u3 = torch.empty((2, 4, 4), device=m)
    with pytest.raises(ValueError, match="no kernel for device"):
        tga.gemm_planes_mid_batch(a4, a4, u3, u3)


@pytest.mark.parametrize("shapes", [
    ((2, 1, 4, 8), (2, 1, 4, 8), (2, 8, 8), (2, 8, 8)),    # K of U
    ((2, 1, 4, 8), (2, 1, 4, 9), (2, 4, 4), (2, 4, 4)),    # A planes
    ((2, 1, 4, 8), (2, 1, 4, 8), (3, 4, 4), (3, 4, 4)),    # lanes of U
])
def test_wrapper_rejects_bad_shapes(shapes):
    ar, ai, ur, ui = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match="do not form"):
        tga.gemm_planes_mid_batch(ar, ai, ur, ui)


def test_a_cuda_operand_must_be_float32():
    fake = [types.SimpleNamespace(device=torch.device("cuda", 0),
                                  dtype=dt)
            for dt in (torch.float32, torch.float64)]
    with pytest.raises(TypeError, match="float32"):
        tga._device("gemm_planes_mid_batch", fake)


@pytest.fixture
def on_fake_card(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors: the device check says
    cuda:0 and the launch records its arguments instead of running."""
    calls = []
    monkeypatch.setattr(tga, "_device",
                        lambda name, ts: torch.device("cuda", 0))
    monkeypatch.setattr(torch, "empty",
                        lambda shape, dtype, device: torch.zeros(shape,
                                                                 dtype=dtype))
    monkeypatch.setattr(tga, "_launch",
                        lambda name, dev, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("case,match", [
    ("lane_not_contiguous", "contiguous stack"),
    ("planes_differ", "share their lane stride"),
    ("u_strides_differ", "share their strides"),
    ("k_not_power_of_two", "not a power of two"),
])
def test_wrapper_rejects_layouts_the_kernel_cannot_read(on_fake_card, case,
                                                        match):
    L, O, K, I = 2, 3, 4, 8
    x = torch.zeros((2, L, O, K, I))
    ar, ai = x[0], x[1]
    ur = ui = torch.zeros((L, K, K))
    if case == "lane_not_contiguous":
        ar = torch.zeros((L, O, I, K)).transpose(2, 3)
    elif case == "planes_differ":
        ai = torch.zeros((L, 2, O, K, I))[:, 1]      # lane stride 2 O K I
    elif case == "u_strides_differ":
        ui = torch.zeros((L, K, K)).transpose(1, 2)
    else:
        ar = ai = torch.zeros((L, O, 3, I))
        ur = ui = torch.zeros((L, 3, 3))
    with pytest.raises(ValueError, match=match):
        tga.gemm_planes_mid_batch(ar, ai, ur, ui)
    assert on_fake_card == []


def test_wrapper_passes_lane_strides_and_vec4(on_fake_card):
    """Lane stride of A (16-byte aligned chunks only where I % 4 == 0 and
    the lane stride keeps them aligned) and of U (0 when broadcast)."""
    L, O, K, I = 3, 2, 4, 8
    x = torch.zeros((L, 2, O, K, I))
    u = torch.zeros((1, 2, K, K)).expand(L, 2, K, K)
    tga.gemm_planes_mid_batch(x[:, 0], x[:, 1], u[:, 0], u[:, 1])
    (name, args), = on_fake_card
    assert name == "gemm_planes_mid_batch"
    a_lane, u_lane = args[2], args[5]
    assert a_lane == 2 * O * K * I and u_lane == 0
    assert args[10:15] == (L, O, K, I, 1)
    tga.gemm_planes_mid(x[0, 0], x[0, 1], u[0, 0], u[0, 1])
    name, args = on_fake_card[-1]
    assert name == "gemm_planes_mid"
    assert args[2] == 0 and args[5] == 0 and args[10] == 1


# -- both executors on the CPU against repro -----------------------------------

def _unitary(rng, K):
    q, _ = np.linalg.qr(rng.standard_normal((K, K))
                        + 1j * rng.standard_normal((K, K)))
    return q.astype(np.complex64)


# dense gates whose axes sit together but not minor-most (MidGemmOps,
# narrow and wide inner axes, one in reversed bit order), beside a
# minor-most one and one that needs a transpose first
PLAN = (((9, 10), False), ((4, 5, 6), False), ((1, 2), False),
        ((0, 1), False), ((6, 5), False), ((3, 8), False),
        ((7, 8, 9, 10, 11), False))
NV = 12


@pytest.mark.parametrize("use_kernel", [True, False])
def test_batched_executor_matches_repro(jnp, use_kernel):
    from repro.core import schedule as jsched
    sched = tsched.compile_schedule(PLAN, NV)
    assert sum(isinstance(op, tsched.MidGemmOp) for op in sched.ops) >= 3
    assert {op.inner for op in sched.ops
            if isinstance(op, tsched.MidGemmOp)} & {2, 8}
    rng = np.random.default_rng(5)
    L = 3
    planes = rng.standard_normal((L, 2, 1 << NV)).astype(np.float32)
    planes /= np.linalg.norm(planes, axis=(1, 2), keepdims=True)
    mats = []
    for vq, _ in PLAN:
        us = np.stack([_unitary(rng, 1 << len(vq)) for _ in range(L)])
        mats.append(np.stack([us.real, us.imag], 1).astype(np.float32))
    want = np.asarray(jsched.execute_schedule_batched(
        jsched.compile_schedule(PLAN, NV), jnp.asarray(planes),
        [jnp.asarray(m) for m in mats], use_kernel=False))
    tga.reset_launch_counts()
    got = tsched.execute_schedule_batched(
        sched, torch.from_numpy(planes.copy()),
        [torch.from_numpy(m) for m in mats], use_kernel=use_kernel)
    assert sum(tga.launch_counts.values()) == 0
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_single_group_executor_matches_repro(jnp, use_kernel):
    """execute_schedule runs every MidGemmOp, narrow inner axes included,
    through gemm_planes_mid (its plain version here)."""
    from repro.core import schedule as jsched
    sched = tsched.compile_schedule(PLAN, NV)
    rng = np.random.default_rng(6)
    planes = rng.standard_normal((2, 1 << NV)).astype(np.float32)
    planes /= np.linalg.norm(planes)
    mats = []
    for vq, _ in PLAN:
        u = _unitary(rng, 1 << len(vq))
        mats.append(np.stack([u.real, u.imag]).astype(np.float32))
    want = np.asarray(jsched.execute_schedule(
        jsched.compile_schedule(PLAN, NV), jnp.asarray(planes),
        [jnp.asarray(m) for m in mats], use_kernel=False))
    got = tsched.execute_schedule(
        sched, torch.from_numpy(planes.copy()),
        [torch.from_numpy(m) for m in mats], use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- the f32 pin ---------------------------------------------------------------

_PIN_PROBE = r"""
import json, torch
from repro_torch.core.devices import full_f32_products
m = torch.backends.cuda.matmul
new_api = hasattr(m, "fp32_precision")

def snap():
    out = []
    for f in (lambda: m.allow_tf32,
              lambda: m.fp32_precision if new_api else None,
              torch.get_float32_matmul_precision):
        try:
            out.append(f())
        except RuntimeError:
            out.append("error")
    return out

setters = {
    "default": lambda: None,
    "high": lambda: torch.set_float32_matmul_precision("high"),
    "allow_tf32": lambda: setattr(m, "allow_tf32", True),
    "no_tf32": lambda: setattr(m, "allow_tf32", False),
    "high_then_allow": lambda: (torch.set_float32_matmul_precision("high"),
                                setattr(m, "allow_tf32", True)),
    "new_api_tf32": lambda: new_api and setattr(m, "fp32_precision", "tf32"),
}
rows = []
for name, set_flags in setters.items():
    set_flags()
    before = snap()
    try:
        with full_f32_products(torch.device("cuda", 0)):
            inside = snap()
            raise KeyError(name)
    except KeyError:
        pass
    after = snap()
    with full_f32_products(torch.device("cpu")):
        on_cpu = snap()
    rows.append({"state": name, "before": before, "inside": inside,
                 "after": after, "on_cpu": on_cpu, "new_api": new_api})
print(json.dumps(rows))
"""


def test_full_f32_products_restores_the_callers_flags():
    """From each state a caller can leave the TF32 flags in (the legacy
    and the new API, and a mix of them), the pin turns TF32 off inside
    and restores every flag on exit, here through an exception; on a
    non-CUDA device it touches nothing.  The flags are process-global, so
    the states run in a process of their own."""
    import os
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _PIN_PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rows = json.loads(out.stdout.splitlines()[-1])
    assert len(rows) == 6
    for row in rows:
        assert row["inside"][0] is False, row
        if row["new_api"]:
            assert row["inside"][1] == "ieee", row
        assert row["after"] == row["before"], row
        assert row["on_cpu"] == row["before"], row
    assert next(r for r in rows if r["state"] == "high")["before"][0] is True


# -- on a card: the kernel against its plain version, row invariance ------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda", 0)


def _card(a, u, device):
    ar, ai, ur, ui = _torch(a, u)
    return (ar.to(device), ai.to(device),
            ur[:1].to(device).expand_as(ur) if ur.stride(0) == 0
            else ur.to(device),
            ui[:1].to(device).expand_as(ui) if ui.stride(0) == 0
            else ui.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("L,O,K,I,broadcast", [
    (16, 1, 4, 1 << 16, False), (16, 1024, 32, 8, False),
    (2, 1, 32, 1 << 17, True), (3, 7, 16, 24, False), (5, 3, 2, 1001, True),
    (4, 33, 8, 6, False), (2, 5, 32, 77, False), (3, 64, 128, 8, True),
    (2, 2, 64, 256, False)])
def test_cuda_kernel_matches_plain_version(cuda_device, L, O, K, I,
                                           broadcast):
    rng = np.random.default_rng(L + O + K + I)
    ar, ai, ur, ui = _card(*_operands(rng, L, O, K, I, broadcast),
                           cuda_device)
    before = tga.launch_counts["gemm_planes_mid_batch"]
    cr, ci = tga.gemm_planes_mid_batch(ar, ai, ur, ui)
    torch.cuda.synchronize()
    assert tga.launch_counts["gemm_planes_mid_batch"] == before + 1
    rr, ri = ref.gemm_planes_mid_batch_ref(ar, ai, ur, ui)
    torch.testing.assert_close(cr, rr, **TOL)
    torch.testing.assert_close(ci, ri, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("O,K,I", [(1, 4, 1 << 14), (512, 32, 8),
                                   (4, 16, 96), (8, 128, 8)])
def test_cuda_rows_are_bitwise_invariant_to_the_lane_count(cuda_device, O,
                                                           K, I):
    """Row l of an L-lane call is bit for bit the one-lane call on row l's
    operands, for L in {1, 2, 3, 16}."""
    rng = np.random.default_rng(O * K + I)
    ar, ai, ur, ui = _card(*_operands(rng, 16, O, K, I, False), cuda_device)
    solo = [tga.gemm_planes_mid_batch(ar[l:l + 1].clone(),
                                      ai[l:l + 1].clone(), ur[l:l + 1],
                                      ui[l:l + 1]) for l in range(16)]
    for L in (1, 2, 3, 16):
        cr, ci = tga.gemm_planes_mid_batch(ar[:L], ai[:L], ur[:L], ui[:L])
        for lane in range(L):
            assert torch.equal(cr[lane], solo[lane][0][0])
            assert torch.equal(ci[lane], solo[lane][1][0])
