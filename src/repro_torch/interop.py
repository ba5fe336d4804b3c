"""Carry circuits, states, operands and LM trees across from the JAX package.

What crosses packages is the circuit, the state (or its re/im planes), the
gate operands, and an LM's parameter and cache trees.  This module takes
them as plain numpy arrays and tuples — it never imports the JAX package —
so a caller holding a ``repro`` object flattens it first, e.g.::

    gates = [(g.name, g.qubits, g.matrix, g.params) for g in rc.gates]
    tc = circuit_from_gates(rc.n_qubits, gates)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams))

A :class:`~repro_torch.core.circuit.Parameter` placeholder is passed as
``("param", name)``, so the tuples stay free of either package's types.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from .core.circuit import Circuit, Gate, Parameter
from .core.devices import resolve_device

__all__ = ["circuit_from_gates", "to_device", "lm_params_from_numpy",
           "lm_cache_from_numpy", "train_state_from_numpy"]


def _param(p):
    if isinstance(p, tuple) and len(p) == 2 and p[0] == "param":
        return Parameter(str(p[1]))
    if hasattr(p, "name") and not isinstance(p, (int, float, np.number)):
        return Parameter(str(p.name))      # a foreign Parameter object
    return float(p)


def circuit_from_gates(n_qubits: int,
                       gates: Iterable[Sequence]) -> Circuit:
    """A port :class:`Circuit` from ``(name, qubits, matrix, params)``
    tuples: ``matrix`` is a numpy array (None while the gate is
    parameterized or a stochastic channel), ``params`` a tuple of floats
    or ``("param", name)`` placeholders."""
    out = []
    for name, qubits, matrix, params in gates:
        mat = None if matrix is None else np.array(matrix,
                                                   dtype=np.complex128)
        out.append(Gate(str(name), tuple(int(q) for q in qubits), mat,
                        tuple(_param(p) for p in params)))
    return Circuit(int(n_qubits), out)


def to_device(arrays, device=None, dtype: torch.dtype | None = None):
    """numpy array(s) -> tensor(s) on ``device`` (default ``cuda:0``).

    Accepts one array or a (nested) list/tuple of arrays and keeps the
    structure; ``dtype`` converts on the way (e.g. ``torch.float32`` for
    planes and operands).
    """
    dev = resolve_device(device)
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(to_device(a, dev, dtype) for a in arrays)
    t = torch.from_numpy(np.ascontiguousarray(arrays))
    return t.to(device=dev, dtype=dtype if dtype is not None else t.dtype)


def _leaf_from_numpy(a, dev: torch.device) -> torch.Tensor:
    """One numpy leaf -> a tensor of the same dtype on ``dev`` (a copy).

    bfloat16 leaves are ``ml_dtypes`` arrays, which is what ``np.asarray``
    of a JAX bfloat16 array gives; they are recognised by the dtype's name
    (``ml_dtypes`` is not imported) and carried bit for bit.
    """
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _tree_from_numpy(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_from_numpy(v, dev) for v in tree)
    return _leaf_from_numpy(tree, dev)


def lm_params_from_numpy(tree, device=None):
    """The JAX package's LM parameter tree (``repro.models.transformer.
    init_params``, or ``repro.models.encdec.init_encdec_params``'s
    ``{"embed", "enc", "dec", "enc_norm", "final_norm"}``), its leaves
    already numpy arrays, as the port's tree of tensors on ``device``
    (default ``cuda:0``): the same dicts, lists and tuples, dtypes kept
    (bf16 weights and expert stacks; f32 norms, MoE routers, mLSTM gate
    projections, RG-LRU Λ and sLSTM biases).  A single array comes across
    the same way: the image embeddings ``aux`` of a VLM or the frames of
    an encoder-decoder, bf16 bit for bit."""
    return _tree_from_numpy(tree, resolve_device(device))


def lm_cache_from_numpy(tree, device=None):
    """The JAX package's decode cache (raw bf16 k/v, or the compressed
    uint8 codes and signs with f32 scales, cross-attention entries of the
    image tokens among them; an encoder-decoder's ``{"k", "v", "xk",
    "xv"}``; recurrent states, f32 but for the RG-LRU's conv taps in the
    model's dtype), its leaves already numpy arrays, as the port's tree of
    writable tensors on ``device`` (default ``cuda:0``), dtypes kept."""
    return _tree_from_numpy(tree, resolve_device(device))


def train_state_from_numpy(tree, device=None):
    """The JAX package's train state (``repro.train.step.init_train_state``
    or a stepped one: ``{"opt": {"m", "v", "step"} or {"f", "step"},
    "gc_err": ...}``), its leaves already numpy arrays, as the port's tree
    of writable tensors on ``device`` (default ``cuda:0``): moments in
    their dtype (bf16 bit for bit), Adafactor's f32 factors, the f32
    residuals, and ``step`` a 0-d int32 tensor."""
    return _tree_from_numpy(tree, resolve_device(device))
