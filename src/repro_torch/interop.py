"""Carry circuits, states and operands across from the JAX package.

The port has no trained weights: what crosses packages is the circuit, the
state (or its re/im planes) and the gate operands.  This module takes them
as plain numpy arrays and tuples — it never imports the JAX package — so a
caller holding a ``repro`` object flattens it first, e.g.::

    gates = [(g.name, g.qubits, g.matrix, g.params) for g in rc.gates]
    tc = circuit_from_gates(rc.n_qubits, gates)

A :class:`~repro_torch.core.circuit.Parameter` placeholder is passed as
``("param", name)``, so the tuples stay free of either package's types.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from .core.circuit import Circuit, Gate, Parameter
from .core.devices import resolve_device

__all__ = ["circuit_from_gates", "to_device"]


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
