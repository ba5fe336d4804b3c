"""Stage gate schedule: transpose-minimizing compilation of a fused plan.

The naive per-gate stage compute (``EngineConfig.gate_schedule=False`` in
the JAX package; not ported yet) brackets *every* fused unitary with a
full-group transpose pair:

    transpose(perm_i) -> GEMM -> transpose(perm_i^-1)      # per gate i

i.e. up to two HBM passes over the 2^(b+m) group array per gate beyond the
arithmetic itself.  This module compiles the stage's gate list into a
minimal permutation plan instead, exploiting three facts:

1. **Layouts compose.** Between gate i and gate i+1 the array only needs
   to move from gate i's layout to gate i+1's layout — one transpose
   (``perm_i^-1 ∘ perm_{i+1}``), not two.  The single inverse permutation
   back to the canonical layout is emitted once, at the end of the stage.
2. **The major axes are free.** A GEMM only requires the gate's k qubit
   axes minor-most (qubit 0's axis last); the remaining axes can sit in
   *any* order.  Keeping them in their current order means consecutive
   gates on identical qubit sets — and many overlapping sets — need no
   transpose at all.
3. **Diagonal unitaries are layout-invariant.** A diagonal gate is an
   elementwise multiply; in any bit-permuted layout it runs as a
   broadcast multiply against a (2,)*k diagonal tensor placed on the
   gate's current axis positions — never a transpose of the group array.

The compiled :class:`StageSchedule` is a pure function of the stage plan
``((vqubits, diag), ...)`` and ``nv`` — cached with ``lru_cache`` the same
way the engine caches its jitted stage functions — and executes on the
planes-resident representation: a ``(2, 2^nv)`` f32 stack of re/im planes
per row (see ``kernels/gate_apply.py``).

The compiler is framework-free and identical to the JAX package's, op for
op.  Execution is torch: :func:`execute_schedule_batched` runs every
``GemmOp`` through the hand-written ``gemm_planes_batch`` kernel (its plain
version on CPU tensors), ``MidGemmOp`` as ``torch.einsum``, and
``DiagOp``/``TransposeOp`` as broadcasts and ``permute``.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

__all__ = ["TransposeOp", "GemmOp", "MidGemmOp", "DiagOp", "StageSchedule",
           "compile_schedule", "execute_schedule_batched", "gate_perm"]


@dataclass(frozen=True)
class TransposeOp:
    """Permute the (2,)*nv group tensor axes (one full HBM pass)."""

    perm: tuple[int, ...]


@dataclass(frozen=True)
class GemmOp:
    """Apply dense unitary ``mats[idx]`` (stacked (2, K, K) planes of U)
    to the minor-most K = 2^k amplitudes: C = A @ U^T on re/im planes
    (the transpose folds into the contraction).

    ``bmap`` (when set) is a compile-time index-bit permutation applied to
    U's rows and columns — gates whose qubit axes sit minor-most but in a
    different bit order (a CX stored target-first, say) run without any
    group transpose by permuting the tiny K x K operand instead.
    """

    idx: int
    k: int
    bmap: tuple[int, ...] | None = None


@dataclass(frozen=True)
class MidGemmOp:
    """Apply dense unitary ``mats[idx]`` to a *contiguous* axis block that
    is not minor-most — C[o] = U @ A[o] over (outer, K, inner) planes —
    so gates whose qubit axes already sit together (QFT's recurring
    top-qubit unitaries live at the *major* end) apply with zero
    transposes.  ``bmap`` as in :class:`GemmOp`."""

    idx: int
    k: int
    outer: int
    inner: int
    bmap: tuple[int, ...] | None = None


@dataclass(frozen=True)
class DiagOp:
    """Elementwise multiply by diagonal ``mats[idx]`` ((2, K) planes) in
    the *current* layout — never a transpose.

    When the gate's axes are contiguous in the layout, ``block`` holds
    ``(p, dmap)``: reshape to (outer, K, inner), select diagonal entries
    through the compile-time bit permutation ``dmap`` (identity = None),
    and broadcast along clean axes.  Otherwise ``shape``/``dperm``
    describe the general nv-axis broadcast of the (2,)*k diagonal tensor.
    ``minor`` marks the layout where the gate qubits are already
    minor-most in standard order, so the Pallas ``diag_apply`` row kernel
    applies directly.
    """

    idx: int
    k: int
    minor: bool
    block: tuple[int, tuple[int, ...] | None] | None
    shape: tuple[int, ...]
    dperm: tuple[int, ...]


@dataclass(frozen=True)
class StageSchedule:
    """Compiled op list for one stage + its transpose accounting.

    ``n_transposes`` counts the full-group transposes the schedule
    executes per group; ``n_transposes_naive`` counts what the per-gate
    path would execute for the same plan (a forward + inverse pair per
    gate whose qubits are not already minor-most).
    """

    nv: int
    ops: tuple
    n_transposes: int
    n_transposes_naive: int


def gate_perm(vqubits: tuple[int, ...], nv: int) -> tuple[int, ...]:
    """The per-gate path's canonical transpose: gate axes minor-most
    (qubit 0's axis last), remaining axes ascending."""
    axes = [nv - 1 - q for q in vqubits]
    rest = [a for a in range(nv) if a not in axes]
    return tuple(rest + [axes[j] for j in range(len(axes) - 1, -1, -1)])


def _contiguous_block(vqubits: tuple[int, ...], nv: int,
                      layout: tuple[int, ...]):
    """``(p, bmap)`` if the gate's axes occupy one contiguous run of the
    layout (any bit order), else None.  ``bmap`` is the compile-time
    K-index bit permutation matching the run's actual order (None =
    already canonical)."""
    k = len(vqubits)
    pos = sorted(layout.index(nv - 1 - q) for q in vqubits)
    if pos != list(range(pos[0], pos[0] + k)):
        return None
    p = pos[0]
    sub = layout[p:p + k]
    wbits = [nv - 1 - sub[k - 1 - j] for j in range(k)]  # qubit on bit j
    if wbits == list(vqubits):
        return p, None
    bmap = tuple(
        sum((((r >> j) & 1) << vqubits.index(wbits[j])) for j in range(k))
        for r in range(1 << k))
    return p, bmap


def _diag_op(idx: int, vqubits: tuple[int, ...], nv: int,
             layout: tuple[int, ...]) -> DiagOp:
    k = len(vqubits)
    axes = [nv - 1 - q for q in vqubits]          # canonical axis of bit j
    pos = [layout.index(a) for a in axes]         # its current position
    minor = pos == [nv - 1 - j for j in range(k)]
    block = _contiguous_block(vqubits, nv, layout)
    # general scattered-axis broadcast fallback
    order = sorted(range(k), key=lambda j: pos[j])
    dperm = tuple(k - 1 - j for j in order)
    shape = [1] * nv
    for p in pos:
        shape[p] = 2
    return DiagOp(idx, k, minor, block, tuple(shape), dperm)


@lru_cache(maxsize=1024)
def compile_schedule(plan: tuple[tuple[tuple[int, ...], bool], ...],
                     nv: int) -> StageSchedule:
    """Compile a stage plan into a transpose-minimizing op sequence.

    Args:
        plan: per fused gate, ``(vqubits, is_diagonal)`` — the same tuple
            the engine caches its stage functions on.
        nv: virtual bits of the group array (b + m).
    """
    ident = tuple(range(nv))
    layout: tuple[int, ...] = ident        # position a holds canonical axis
    ops: list = []
    n_transposes = 0
    n_naive = 0
    for idx, (vqubits, diag) in enumerate(plan):
        if gate_perm(vqubits, nv) != ident:
            n_naive += 2                   # per-gate forward + inverse pair
        if diag:
            ops.append(_diag_op(idx, vqubits, nv, layout))
            continue
        k = len(vqubits)
        tail = [nv - 1 - q for q in reversed(vqubits)]
        # gate axes already contiguous in the current layout (any bit
        # order) -> no group transpose: a bit-order mismatch permutes the
        # tiny K x K operand instead, then minor-most runs as A @ U^T and
        # anywhere else as the batched middle contraction U @ A[o]
        block = _contiguous_block(vqubits, nv, layout)
        if block is not None:
            p, bmap = block
            if p == nv - k:
                ops.append(GemmOp(idx, k, bmap=bmap))
            else:
                ops.append(MidGemmOp(idx, k, outer=1 << p,
                                     inner=1 << (nv - p - k), bmap=bmap))
            continue
        head = [a for a in layout if a not in set(tail)]
        target = tuple(head + tail)
        ops.append(TransposeOp(tuple(layout.index(a) for a in target)))
        n_transposes += 1
        layout = target
        ops.append(GemmOp(idx, k))
    if layout != ident:
        ops.append(TransposeOp(tuple(layout.index(a) for a in ident)))
        n_transposes += 1
    return StageSchedule(nv=nv, ops=tuple(ops), n_transposes=n_transposes,
                         n_transposes_naive=n_naive)


def _op_mat_batch(mat: torch.Tensor, bmap: tuple[int, ...] | None):
    """(L, 2, K, K) stacked per-lane U planes -> (br, bi) of shape
    (L, K, K), bit-permuted when needed.  A lane-broadcast operand (lane
    stride 0) is permuted once and stays a stride-0 view."""
    lanes = mat.shape[0]
    if bmap is not None:
        base = mat[:1] if mat.stride(0) == 0 else mat
        idx = torch.as_tensor(bmap, device=mat.device)
        base = base[:, :, idx][:, :, :, idx]
        mat = base.expand((lanes,) + tuple(base.shape[1:]))
    return mat[:, 0], mat[:, 1]


def _rows(x: torch.Tensor, lanes: int, K: int) -> torch.Tensor:
    """(L, R, K) view of a lane-major tensor with contiguous (R, K) rows —
    the layout the GEMM kernel reads (copies only when the current layout
    is not already row-contiguous, e.g. right after a TransposeOp)."""
    x = x.reshape(lanes, -1, K)
    if x.stride(2) != 1 or (x.shape[1] > 1 and x.stride(1) != K):
        x = x.contiguous()
    return x


def execute_schedule_batched(sched: StageSchedule, planes: torch.Tensor,
                             mats, *, use_kernel: bool) -> torch.Tensor:
    """Run a compiled schedule over an (L, 2, 2^nv) f32 plane stack.

    ``mats[i]`` is ``(L, 2, K, K)`` stacked re/im of gate i's U for dense
    gates, ``(L, 2, K)`` of its diagonal for diagonal gates; lane ``l``'s
    unitaries apply to lane ``l``'s planes.  Operands may be stride-0
    views over the lane axis.  ``use_kernel`` selects the
    ``gemm_planes_batch`` kernel for every ``GemmOp`` over plain torch
    products.

    The result is written back into ``planes`` (the buffer the JAX
    package donates) and returned.
    """
    nv = sched.nv
    lanes = planes.shape[0]
    shape = (lanes,) + (2,) * nv
    ar = planes[:, 0].reshape(shape)
    ai = planes[:, 1].reshape(shape)
    for op in sched.ops:
        if isinstance(op, TransposeOp):
            perm = (0,) + tuple(a + 1 for a in op.perm)
            ar = ar.permute(perm)
            ai = ai.permute(perm)
        elif isinstance(op, GemmOp):
            K = 1 << op.k
            br, bi = _op_mat_batch(mats[op.idx], op.bmap)
            br, bi = br.transpose(1, 2), bi.transpose(1, 2)   # U -> U^T
            a2r, a2i = _rows(ar, lanes, K), _rows(ai, lanes, K)
            if use_kernel:
                from ..kernels.gate_apply import gemm_planes_batch
                cr, ci = gemm_planes_batch(a2r, a2i, br, bi)
            else:
                cr = a2r @ br - a2i @ bi                      # lane-batched
                ci = a2r @ bi + a2i @ br
            ar, ai = cr.reshape(shape), ci.reshape(shape)
        elif isinstance(op, MidGemmOp):
            K = 1 << op.k
            br, bi = _op_mat_batch(mats[op.idx], op.bmap)
            a3r = ar.reshape(lanes, op.outer, K, op.inner)
            a3i = ai.reshape(lanes, op.outer, K, op.inner)

            def e(b, a):
                return torch.einsum("ljk,loki->loji", b, a)
            cr = e(br, a3r) - e(bi, a3i)
            ci = e(br, a3i) + e(bi, a3r)
            ar, ai = cr.reshape(shape), ci.reshape(shape)
        else:                                   # DiagOp
            dr, di = mats[op.idx][:, 0], mats[op.idx][:, 1]   # (L, K)
            K = 1 << op.k
            if op.block is not None:
                p, dmap = op.block
                if dmap is not None:
                    sel = torch.as_tensor(dmap, device=dr.device)
                    dr, di = dr[:, sel], di[:, sel]
                if p == nv - op.k:
                    a2r = ar.reshape(lanes, -1, K)
                    a2i = ai.reshape(lanes, -1, K)
                    db_r, db_i = dr[:, None, :], di[:, None, :]
                else:
                    inner = 1 << (nv - p - op.k)
                    a2r = ar.reshape(lanes, -1, K, inner)
                    a2i = ai.reshape(lanes, -1, K, inner)
                    db_r, db_i = dr[:, None, :, None], di[:, None, :, None]
                cr = a2r * db_r - a2i * db_i
                ci = a2r * db_i + a2i * db_r
                ar, ai = cr.reshape(shape), ci.reshape(shape)
            else:
                d2 = (2,) * op.k
                perm = (0,) + tuple(a + 1 for a in op.dperm)
                dshape = (lanes,) + op.shape
                dr = dr.reshape((lanes,) + d2).permute(perm).reshape(dshape)
                di = di.reshape((lanes,) + d2).permute(perm).reshape(dshape)
                ar, ai = ar * dr - ai * di, ar * di + ai * dr
    planes[:, 0].copy_(ar.reshape(lanes, -1))
    planes[:, 1].copy_(ai.reshape(lanes, -1))
    return planes
