"""The single-group gate kernels and the standalone packing kernels:
gemm_planes (B6), gemm_planes_mid (B7), diag_apply (B8),
pack_bitmap_tiles / unpack_bitmap_tiles (B9) and pack_codes_tiles /
unpack_codes_tiles (B3/B4 on their own).  Their plain versions against
the JAX package's Pallas kernels (interpret mode), the wrappers' dispatch
rules, and — on a card — each CUDA kernel against its plain version.

Tolerances: the GEMMs within rtol/atol 1e-4 (those of
``tests/test_kernels.py``: f32 accuracy, summed in another order; B6 at
K >= 64 runs split TF32 on the tensor cores, ~3·2^-22 relative a
product), the diagonal multiply within rtol 1e-5, atol 1e-6 (one product
and one sum an element); packing bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import gate_apply as tga
from repro_torch.kernels import pack as tpack
from repro_torch.kernels import ref

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)
DIAG_TOL = dict(rtol=1e-5, atol=1e-6)
ROWS = [1, 8, 24, 33]


def _planes(rng, *shape):
    return rng.standard_normal((2,) + shape).astype(np.float32)


def _phases(rng, K):
    d = np.exp(1j * rng.uniform(0, 2 * np.pi, K)).astype(np.complex64)
    return np.real(d).copy(), np.imag(d).copy()


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture
def jax_kernels():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import gate_apply, pack
    return jnp, gate_apply, pack


# -- plain versions against the Pallas kernels --------------------------------

@pytest.mark.parametrize("R,K", [(8, 8), (32, 16), (256, 64), (512, 128),
                                 (1024, 128), (64, 2), (128, 4)])
def test_gemm_planes_matches_pallas(jax_kernels, R, K):
    jnp, jga, _ = jax_kernels
    rng = np.random.default_rng(R + K)
    ar, ai = _planes(rng, R, K)
    br, bi = _planes(rng, K, K)
    jr, ji = jga.gemm_planes(*map(jnp.asarray, (ar, ai, br, bi)),
                             interpret=True)
    tga.reset_launch_counts()
    tr, ti = tga.gemm_planes(*_t(ar, ai, br, bi))
    assert tga.launch_counts["gemm_planes"] == 0      # CPU: plain version
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **GEMM_TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **GEMM_TOL)


@pytest.mark.parametrize("O,K,I", [(1, 4, 128), (2, 8, 256), (3, 16, 128),
                                   (1, 32, 512), (4, 2, 1024),
                                   (2, 128, 128),
                                   # the CUDA ring body's edges: I not a
                                   # multiple of its slab, O > 1 with I below
                                   # a slab, K = 2 and 32
                                   (1, 32, 300), (2, 2, 1001), (5, 32, 77),
                                   (3, 2, 33), (2, 16, 130)])
def test_gemm_planes_mid_matches_pallas(jax_kernels, O, K, I):
    jnp, jga, _ = jax_kernels
    rng = np.random.default_rng(O * K + I)
    ar, ai = _planes(rng, O, K, I)
    ur, ui = _planes(rng, K, K)
    jr, ji = jga.gemm_planes_mid(*map(jnp.asarray, (ar, ai, ur, ui)),
                                 interpret=True)
    tr, ti = tga.gemm_planes_mid(*_t(ar, ai, ur, ui))
    assert tr.shape == (O, K, I) and tr.dtype == torch.float32
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **GEMM_TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **GEMM_TOL)


@pytest.mark.parametrize("R,K", [(16, 8), (128, 32), (512, 128), (64, 2)])
def test_diag_apply_matches_pallas(jax_kernels, R, K):
    jnp, jga, _ = jax_kernels
    rng = np.random.default_rng(R * K)
    ar, ai = _planes(rng, R, K)
    dr, di = _phases(rng, K)
    jr, ji = jga.diag_apply(*map(jnp.asarray, (ar, ai, dr, di)),
                            interpret=True)
    tr, ti = tga.diag_apply(*_t(ar, ai, dr, di))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **DIAG_TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **DIAG_TOL)


@pytest.mark.parametrize("rows", ROWS)
def test_code_packing_is_bit_equal_to_pallas(jax_kernels, rows):
    jnp, _, jpk = jax_kernels
    rng = np.random.default_rng(rows)
    codes = rng.integers(0, 65536, (rows, 128)).astype(np.int32)
    codes[0, :4] = [0, 65535, 1, 32768]
    jw = np.asarray(jpk.pack_codes_tiles(jnp.asarray(codes), interpret=True))
    tw = tpack.pack_codes_tiles(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(tw, jw)
    back = tpack.unpack_codes_tiles(torch.from_numpy(tw)).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jpk.unpack_codes_tiles(jnp.asarray(jw),
                                                interpret=True)))
    np.testing.assert_array_equal(back, codes)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("dtype", [np.int32, np.bool_])
def test_bitmap_packing_is_bit_equal_to_pallas(jax_kernels, rows, dtype):
    jnp, _, jpk = jax_kernels
    rng = np.random.default_rng(100 + rows)
    bits = (rng.random((rows, 128)) < 0.5).astype(dtype)
    bits[0, :32] = 1                          # a word of all ones: -1
    jw = np.asarray(jpk.pack_bitmap_tiles(jnp.asarray(bits), interpret=True))
    tw = tpack.pack_bitmap_tiles(torch.from_numpy(bits)).numpy()
    assert tw.dtype == np.int32 and tw.shape == (rows, 4)
    np.testing.assert_array_equal(tw, jw)
    assert tw[0, 0] == -1
    jb = np.asarray(jpk.unpack_bitmap_tiles(jnp.asarray(jw), interpret=True))
    tb = tpack.unpack_bitmap_tiles(torch.from_numpy(tw)).numpy()
    assert tb.dtype == np.int32
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tb, bits.astype(np.int32))


# -- dispatch rules -----------------------------------------------------------

def _meta_calls():
    m = torch.device("meta")
    a2 = torch.empty((4, 4), device=m)
    a3 = torch.empty((1, 4, 128), device=m)
    d = torch.empty((4,), device=m)
    i128 = torch.empty((1, 128), dtype=torch.int32, device=m)
    return {
        "gemm_planes": lambda: tga.gemm_planes(a2, a2, a2, a2),
        "gemm_planes_mid": lambda: tga.gemm_planes_mid(a3, a3, a2, a2),
        "diag_apply": lambda: tga.diag_apply(a2, a2, d, d),
        "pack_codes_tiles": lambda: tpack.pack_codes_tiles(i128),
        "unpack_codes_tiles": lambda: tpack.unpack_codes_tiles(
            torch.empty((1, 64), dtype=torch.int32, device=m)),
        "pack_bitmap_tiles": lambda: tpack.pack_bitmap_tiles(i128),
        "unpack_bitmap_tiles": lambda: tpack.unpack_bitmap_tiles(
            torch.empty((1, 4), dtype=torch.int32, device=m)),
    }


@pytest.mark.parametrize("name", sorted(_meta_calls()))
def test_a_non_cpu_tensor_never_takes_the_plain_version(monkeypatch, name):
    """Any device but the CPU goes to the kernel or raises: the plain
    version is not a fallback."""
    def boom(*args):
        raise AssertionError("plain version reached for a device tensor")

    mod = tga if hasattr(tga, f"{name}_ref") else tpack
    monkeypatch.setattr(mod, f"{name}_ref", boom)
    with pytest.raises(ValueError, match="no kernel for device"):
        _meta_calls()[name]()


@pytest.mark.parametrize("mod,name,lib", [
    (tga, "gemm_planes", "gate_apply"), (tga, "gemm_planes_mid",
                                         "gate_apply"),
    (tga, "diag_apply", "gate_apply"), (tpack, "pack_bitmap_tiles", "pack"),
    (tpack, "unpack_codes_tiles", "pack")])
def test_a_failed_build_raises_and_counts_nothing(monkeypatch, mod, name,
                                                  lib):
    def no_build(src):
        raise RuntimeError(f"nvcc failed for csrc/{src}.cu")

    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(mod, "_fns", None)
    before = dict(mod.launch_counts)
    with pytest.raises(RuntimeError, match=f"nvcc failed for csrc/{lib}.cu"):
        mod._launch(name, torch.device("cuda", 0))
    assert mod.launch_counts == before


def test_wrappers_reject_bad_shapes():
    a = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="do not form"):
        tga.gemm_planes(a, a, torch.zeros((4, 4)), torch.zeros((4, 4)))
    with pytest.raises(ValueError, match="do not form"):
        tga.gemm_planes_mid(torch.zeros((1, 4, 8)), torch.zeros((1, 4, 8)),
                            torch.zeros((8, 8)), torch.zeros((8, 8)))
    with pytest.raises(ValueError, match="do not form"):
        tga.diag_apply(a, a, torch.zeros(4), torch.zeros(4))
    with pytest.raises(ValueError, match="want"):
        tpack.pack_bitmap_tiles(torch.zeros((2, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="want"):
        tpack.unpack_codes_tiles(torch.zeros((2, 128), dtype=torch.int32))


# -- on a card: each kernel against its plain version -------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda", 0)


def _counted(mod, name, fn):
    before = mod.launch_counts[name]
    out = fn()
    torch.cuda.synchronize()
    assert mod.launch_counts[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("R,K", [(1 << 20, 4), (1 << 18, 16), (1 << 17, 32),
                                 (1 << 15, 128), (7, 2), (33, 8), (5, 64),
                                 (1 << 16, 64), (1000, 128), (77, 64),
                                 (3, 128)])
def test_cuda_gemm_planes_matches_plain_version(cuda_device, R, K):
    rng = np.random.default_rng(K + R)
    ar, ai = _t(*_planes(rng, R, K))
    u = _planes(rng, K, K) / np.float32(np.sqrt(K))
    U = torch.from_numpy(u)
    ar, ai, U = ar.to(cuda_device), ai.to(cuda_device), U.to(cuda_device)
    br, bi = U[0].T, U[1].T                        # U^T as strided views
    cr, ci = _counted(tga, "gemm_planes",
                      lambda: tga.gemm_planes(ar, ai, br, bi))
    rr, ri = ref.gemm_planes_ref(ar, ai, br, bi)
    torch.testing.assert_close(cr, rr, **GEMM_TOL)
    torch.testing.assert_close(ci, ri, **GEMM_TOL)


# B1 and B6 at K <= 32 run the ring body: f32 FMAs in the order of the
# plain version's products, held to B1's tolerance
RING_TOL = dict(rtol=1e-5, atol=1e-6)
RING_KS = [2, 4, 8, 16, 32]


def _card_normals(rng, device, offset, *shape):
    """f32 normals of ``shape`` on the card, ``offset`` floats into their
    buffer (1: off 16-byte alignment, the kernel's 4-byte copy path)."""
    n = int(np.prod(shape))
    buf = torch.from_numpy(rng.standard_normal(n + offset)
                           .astype(np.float32)).to(device)
    return buf[offset:].reshape(shape)


def _ring_rows(K, R):
    """None: R*K past 2^22 by a ragged tile, so that every block of the
    persistent grid walks several tiles of the ring."""
    return (1 << 22) // K + 3 if R is None else R


@pytest.mark.cuda
@pytest.mark.parametrize("K", RING_KS)
@pytest.mark.parametrize("L,R,broadcast,offset", [
    (3, None, True, 0), (2, 1001, False, 1), (1, 777, True, 0),
    (3, 1001, False, 0)])
def test_cuda_gemm_planes_batch_ring_matches_plain_version(
        cuda_device, K, L, R, broadcast, offset):
    """B1's ring body: one to three lanes, B per lane or at lane stride 0,
    R*K not a multiple of the tile (nor of 4 at K = 2, R = 1001), planes
    aligned or one float off."""
    from repro_torch.kernels.ref import gemm_planes_batch_ref
    R = _ring_rows(K, R)
    rng = np.random.default_rng(K * 10 + L)
    x = _card_normals(rng, cuda_device, offset, L, 2, R, K)
    ar, ai = x[:, 0], x[:, 1]                     # lane stride 2RK
    u = torch.from_numpy(_planes(rng, 1 if broadcast else L, K, K)
                         / np.float32(np.sqrt(K))).to(cuda_device)
    U = u.expand(2, L, K, K) if broadcast else u  # lane stride 0
    br, bi = U[0].transpose(1, 2), U[1].transpose(1, 2)
    cr, ci = _counted(tga, "gemm_planes_batch",
                      lambda: tga.gemm_planes_batch(ar, ai, br, bi))
    rr, ri = gemm_planes_batch_ref(ar, ai, br, bi)
    torch.testing.assert_close(cr, rr, **RING_TOL)
    torch.testing.assert_close(ci, ri, **RING_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("K", RING_KS)
@pytest.mark.parametrize("R,offset", [(None, 0), (1001, 1), (None, 1)])
def test_cuda_gemm_planes_ring_matches_plain_version(cuda_device, K, R,
                                                     offset):
    """B6 at K <= 32 is B1's ring body with one lane."""
    R = _ring_rows(K, R)
    rng = np.random.default_rng(K + R)
    ar, ai = _card_normals(rng, cuda_device, offset, 2, R, K)
    U = torch.from_numpy(_planes(rng, K, K) / np.float32(np.sqrt(K))) \
        .to(cuda_device)
    br, bi = U[0].T, U[1].T
    cr, ci = _counted(tga, "gemm_planes",
                      lambda: tga.gemm_planes(ar, ai, br, bi))
    rr, ri = ref.gemm_planes_ref(ar, ai, br, bi)
    torch.testing.assert_close(cr, rr, **RING_TOL)
    torch.testing.assert_close(ci, ri, **RING_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("O,K,I,offset", [
    (1, 4, 1 << 20, 0), (1, 32, 1 << 17, 0), (3, 16, 128, 0),
    (2, 2, 160, 0), (2, 64, 256, 0), (1, 128, 384, 0),
    # the ring body (K <= 32): I ragged against its slab, O > 1 with I
    # below a slab, planes one float off 16-byte alignment
    (1, 32, 300, 0), (2, 2, 1001, 1), (5, 32, 77, 0), (3, 2, 33, 1),
    (2, 16, 130, 1), (3, 8, (1 << 18) + 3, 0), (2, 32, 4096, 1)])
def test_cuda_gemm_planes_mid_matches_plain_version(cuda_device, O, K, I,
                                                    offset):
    rng = np.random.default_rng(O + K + I)
    x = _card_normals(rng, cuda_device, offset, 2, O, K, I)
    ar, ai = x[0], x[1]
    ur, ui = (t.to(cuda_device)
              for t in _t(*(_planes(rng, K, K) / np.float32(np.sqrt(K)))))
    cr, ci = _counted(tga, "gemm_planes_mid",
                      lambda: tga.gemm_planes_mid(ar, ai, ur, ui))
    rr, ri = ref.gemm_planes_mid_ref(ar, ai, ur, ui)
    torch.testing.assert_close(cr, rr, **GEMM_TOL)
    torch.testing.assert_close(ci, ri, **GEMM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("R,K", [(1 << 20, 4), (1 << 17, 32), (1 << 15, 128),
                                 (3, 2), (5, 1)])
def test_cuda_diag_apply_matches_plain_version(cuda_device, R, K):
    rng = np.random.default_rng(R + K)
    ar, ai = (t.to(cuda_device) for t in _t(*_planes(rng, R, K)))
    dr, di = (t.to(cuda_device) for t in _t(*_phases(rng, K)))
    cr, ci = _counted(tga, "diag_apply",
                      lambda: tga.diag_apply(ar, ai, dr, di))
    rr, ri = ref.diag_apply_ref(ar, ai, dr, di)
    torch.testing.assert_close(cr, rr, **DIAG_TOL)
    torch.testing.assert_close(ci, ri, **DIAG_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ROWS + [1 << 15])
def test_cuda_packing_kernels_are_bit_equal(cuda_device, rows):
    rng = np.random.default_rng(rows)
    codes = torch.from_numpy(
        rng.integers(0, 65536, (rows, 128)).astype(np.int32)).to(cuda_device)
    words = _counted(tpack, "pack_codes_tiles",
                     lambda: tpack.pack_codes_tiles(codes))
    assert torch.equal(words, ref.pack_codes_tiles_ref(codes))
    back = _counted(tpack, "unpack_codes_tiles",
                    lambda: tpack.unpack_codes_tiles(words))
    assert torch.equal(back, codes)
    bits = torch.from_numpy(rng.random((rows, 128)) < 0.5).to(cuda_device)
    for b in (bits, bits.to(torch.int32)):
        signs = _counted(tpack, "pack_bitmap_tiles",
                         lambda: tpack.pack_bitmap_tiles(b))
        assert torch.equal(signs, ref.pack_bitmap_tiles_ref(b))
    out = _counted(tpack, "unpack_bitmap_tiles",
                   lambda: tpack.unpack_bitmap_tiles(signs))
    assert torch.equal(out, ref.unpack_bitmap_tiles_ref(signs))
    assert torch.equal(out, bits.to(torch.int32))
