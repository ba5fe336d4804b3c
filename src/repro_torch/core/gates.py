"""Quantum gate library.

Conventions
-----------
* Qubits are little-endian: qubit 0 is the least-significant bit of the
  state-vector index.
* A ``k``-qubit gate acting on qubits ``(q_0, ..., q_{k-1})`` has a
  ``2^k x 2^k`` unitary whose row/column index ``m`` decomposes as
  ``m = sum_j bit_j << j`` where ``bit_j`` is the basis value of ``q_j``.
  I.e. the *first* qubit in the tuple is the least-significant bit of the
  matrix index.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = [
    "I2", "X", "Y", "Z", "H", "S", "SDG", "T", "TDG", "SX",
    "rx", "ry", "rz", "u3", "phase", "cx", "cz", "cp", "swap",
    "rzz", "rxx", "crz", "GATE_FACTORIES", "is_unitary", "controlled",
]

_SQ2 = 1.0 / math.sqrt(2.0)

I2 = np.eye(2, dtype=np.complex128)
X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)
H = np.array([[_SQ2, _SQ2], [_SQ2, -_SQ2]], dtype=np.complex128)
S = np.array([[1, 0], [0, 1j]], dtype=np.complex128)
SDG = S.conj().T
T = np.array([[1, 0], [0, np.exp(1j * math.pi / 4)]], dtype=np.complex128)
TDG = T.conj().T
SX = 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]], dtype=np.complex128)


def rx(theta: float) -> np.ndarray:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=np.complex128)


def ry(theta: float) -> np.ndarray:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=np.complex128)


def rz(theta: float) -> np.ndarray:
    e = np.exp(-0.5j * theta)
    return np.array([[e, 0], [0, np.conj(e)]], dtype=np.complex128)


def phase(lam: float) -> np.ndarray:
    return np.array([[1, 0], [0, np.exp(1j * lam)]], dtype=np.complex128)


def u3(theta: float, phi: float, lam: float) -> np.ndarray:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array(
        [
            [c, -np.exp(1j * lam) * s],
            [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c],
        ],
        dtype=np.complex128,
    )


def _two_qubit(u00: np.ndarray, u11: np.ndarray) -> np.ndarray:
    """Controlled-gate builder: control is the SECOND qubit in the tuple
    (bit 1 of the matrix index), target the first (bit 0)."""
    out = np.zeros((4, 4), dtype=np.complex128)
    out[:2, :2] = u00
    out[2:, 2:] = u11
    return out


def controlled(u: np.ndarray) -> np.ndarray:
    """Controlled-U with (target, control) qubit order (control = bit 1)."""
    return _two_qubit(I2, u)


# (target, control) order: index bit0 = target, bit1 = control.
def cx() -> np.ndarray:
    return controlled(X)


def cz() -> np.ndarray:
    return controlled(Z)


def cp(lam: float) -> np.ndarray:
    return controlled(phase(lam))


def crz(theta: float) -> np.ndarray:
    return controlled(rz(theta))


def swap() -> np.ndarray:
    out = np.eye(4, dtype=np.complex128)
    out[[1, 2]] = out[[2, 1]]
    return out


def rzz(theta: float) -> np.ndarray:
    """exp(-i theta/2 Z (x) Z) — diagonal two-qubit gate."""
    e = np.exp(-0.5j * theta)
    ec = np.conj(e)
    return np.diag([e, ec, ec, e]).astype(np.complex128)


def rxx(theta: float) -> np.ndarray:
    c, s = math.cos(theta / 2), -1j * math.sin(theta / 2)
    out = np.eye(4, dtype=np.complex128) * c
    out[0, 3] = out[1, 2] = out[2, 1] = out[3, 0] = s
    return out


# name -> callable(*params) returning the matrix; fixed gates wrapped in lambdas
GATE_FACTORIES = {
    "i": lambda: I2, "x": lambda: X, "y": lambda: Y, "z": lambda: Z,
    "h": lambda: H, "s": lambda: S, "sdg": lambda: SDG, "t": lambda: T,
    "tdg": lambda: TDG, "sx": lambda: SX,
    "rx": rx, "ry": ry, "rz": rz, "p": phase, "u3": u3,
    "cx": cx, "cz": cz, "cp": cp, "crz": crz, "swap": swap,
    "rzz": rzz, "rxx": rxx,
}


def is_unitary(m: np.ndarray, atol: float = 1e-10) -> bool:
    return bool(np.allclose(m @ m.conj().T, np.eye(m.shape[0]), atol=atol))
