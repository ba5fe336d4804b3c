"""Circuit IR: a flat list of Gate ops over n qubits (little-endian).

Circuits may be *parameterized*: any gate angle can be a
:class:`Parameter` placeholder instead of a float.  A parameterized gate
defers its matrix (``matrix is None``) until :meth:`Gate.bind` /
:meth:`Circuit.bind` substitutes concrete values — the structural fields
(name, qubits) are always present, so partitioning and scheduling work on
the unbound template while the numeric unitaries are produced per binding
(the :class:`~repro_torch.core.simulator.Simulator` session exploits this to
re-run e.g. a QAOA ansatz at many angles without re-partitioning).

Circuits may also be *stochastic*: a gate whose name is in
:data:`CHANNEL_FACTORIES` is a sampled Pauli channel — a placeholder
(``matrix is None``, like a parameterized gate) whose concrete unitary is
drawn per noise trajectory by :meth:`Gate.realize` from the channel's
outcome table.  Structure (name, qubits) is fixed, so partitioning,
fusion, and scheduling are shared across every trajectory of a batch;
only the matrices differ per lane (``Simulator.run(trajectories=K)``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

import numpy as np

from . import gates as G

__all__ = ["Parameter", "Gate", "Circuit", "CHANNEL_FACTORIES"]


def _depolarizing(p: float):
    """Uniform 1-qubit depolarizing: I with prob 1-p, X/Y/Z with p/3 each."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"depolarizing probability {p} outside [0, 1]")
    return ((1.0 - p, "i"), (p / 3.0, "x"), (p / 3.0, "y"), (p / 3.0, "z"))


def _bitflip(p: float):
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"bit-flip probability {p} outside [0, 1]")
    return ((1.0 - p, "i"), (p, "x"))


def _phaseflip(p: float):
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"phase-flip probability {p} outside [0, 1]")
    return ((1.0 - p, "i"), (p, "z"))


#: stochastic Pauli channels: name -> callable(*params) returning the
#: outcome table ``((probability, gate_name), ...)``.  A gate with one of
#: these names is a per-trajectory placeholder resolved by Gate.realize.
CHANNEL_FACTORIES = {
    "depol": _depolarizing,
    "bitflip": _bitflip,
    "phaseflip": _phaseflip,
}


@dataclass(frozen=True)
class Parameter:
    """A named placeholder for a gate angle, resolved at bind time."""

    name: str

    def __repr__(self) -> str:
        return f"Parameter({self.name!r})"


def _resolve(params: tuple, values: Mapping[str, float]) -> tuple[float, ...]:
    out = []
    for p in params:
        if isinstance(p, Parameter):
            if p.name not in values:
                raise KeyError(f"no value bound for parameter {p.name!r}")
            out.append(float(values[p.name]))
        else:
            out.append(float(p))
    return tuple(out)


@dataclass(frozen=True)
class Gate:
    """One gate application.

    ``qubits`` is the target tuple; ``qubits[0]`` maps to the least-significant
    bit of the matrix index (see gates.py conventions).  ``matrix`` is None
    while any entry of ``params`` is a :class:`Parameter` placeholder.
    """

    name: str
    qubits: tuple[int, ...]
    matrix: np.ndarray | None
    params: tuple = ()

    def __post_init__(self):
        k = len(self.qubits)
        assert len(set(self.qubits)) == k, f"duplicate qubits in {self.name}"
        if self.is_stochastic:
            assert self.matrix is None, self.name
            assert k == 1, f"channel {self.name} must act on one qubit"
            assert not self.is_parameterized, \
                f"channel {self.name} probabilities must be concrete"
        elif self.is_parameterized:
            assert self.matrix is None, self.name
        else:
            assert self.matrix is not None and \
                self.matrix.shape == (2 ** k, 2 ** k), \
                (self.name, None if self.matrix is None else self.matrix.shape)

    @property
    def support(self) -> frozenset[int]:
        return frozenset(self.qubits)

    @property
    def is_parameterized(self) -> bool:
        return any(isinstance(p, Parameter) for p in self.params)

    @property
    def is_stochastic(self) -> bool:
        """True for a sampled Pauli channel (resolved by :meth:`realize`)."""
        return self.name in CHANNEL_FACTORIES

    @property
    def free_parameters(self) -> frozenset[str]:
        return frozenset(p.name for p in self.params
                         if isinstance(p, Parameter))

    def outcomes(self) -> tuple[tuple[float, str], ...]:
        """A channel's ``((probability, gate_name), ...)`` outcome table."""
        if not self.is_stochastic:
            raise ValueError(f"gate {self.name!r} is not a channel")
        return CHANNEL_FACTORIES[self.name](*self.params)

    def realize(self, rng: np.random.Generator) -> "Gate":
        """Draw one concrete realization of a stochastic channel.

        Deterministic given the rng state: the engine's trajectory lanes
        and the dense oracle (:meth:`Circuit.realize`) consume the same
        stream in circuit order, so equal seeds reproduce equal gates.
        Non-stochastic gates return themselves (no draw is consumed).
        """
        if not self.is_stochastic:
            return self
        table = self.outcomes()
        u = float(rng.random())
        acc = 0.0
        picked = table[-1][1]
        for prob, name in table:
            acc += prob
            if u < acc:
                picked = name
                break
        mat = np.asarray(G.GATE_FACTORIES[picked](), dtype=np.complex128)
        return Gate(picked, self.qubits, mat, ())

    def bind(self, values: Mapping[str, float]) -> "Gate":
        """Substitute parameter values; returns a concrete gate."""
        if not self.is_parameterized:
            return self
        params = _resolve(self.params, values)
        mat = np.asarray(G.GATE_FACTORIES[self.name](*params),
                         dtype=np.complex128)
        return Gate(self.name, self.qubits, mat, params)


@dataclass
class Circuit:
    """An ordered gate list over ``n_qubits`` qubits (builder API below)."""
    n_qubits: int
    gates: list[Gate] = field(default_factory=list)

    # -- builder API ---------------------------------------------------------
    def append(self, name: str, qubits: Sequence[int], *params) -> "Circuit":
        for q in qubits:
            if not 0 <= q < self.n_qubits:
                raise ValueError(f"qubit {q} out of range for n={self.n_qubits}")
        if any(isinstance(p, Parameter) for p in params):
            if name not in G.GATE_FACTORIES:     # fail at append, not bind
                raise KeyError(f"unknown gate {name!r}")
            self.gates.append(Gate(name, tuple(qubits), None, tuple(params)))
            return self
        mat = np.asarray(G.GATE_FACTORIES[name](*params), dtype=np.complex128)
        self.gates.append(Gate(name, tuple(qubits), mat,
                               tuple(float(p) for p in params)))
        return self

    def h(self, q):            return self.append("h", [q])
    def x(self, q):            return self.append("x", [q])
    def y(self, q):            return self.append("y", [q])
    def z(self, q):            return self.append("z", [q])
    def s(self, q):            return self.append("s", [q])
    def t(self, q):            return self.append("t", [q])
    def sdg(self, q):          return self.append("sdg", [q])
    def tdg(self, q):          return self.append("tdg", [q])
    def rx(self, th, q):       return self.append("rx", [q], th)
    def ry(self, th, q):       return self.append("ry", [q], th)
    def rz(self, th, q):       return self.append("rz", [q], th)
    def p(self, lam, q):       return self.append("p", [q], lam)
    def u3(self, th, ph, lam, q): return self.append("u3", [q], th, ph, lam)
    # two-qubit: (target, control) order in the stored tuple
    # stochastic Pauli channels (sampled per trajectory at bind time)
    def append_channel(self, name: str, qubits: Sequence[int],
                       *params) -> "Circuit":
        if name not in CHANNEL_FACTORIES:
            raise KeyError(f"unknown channel {name!r}; "
                           f"have {sorted(CHANNEL_FACTORIES)}")
        for q in qubits:
            if not 0 <= q < self.n_qubits:
                raise ValueError(f"qubit {q} out of range for n={self.n_qubits}")
        gate = Gate(name, tuple(qubits), None,
                    tuple(float(p) for p in params))
        gate.outcomes()               # fail on bad probabilities at append
        self.gates.append(gate)
        return self

    def depolarize(self, p, q):  return self.append_channel("depol", [q], p)
    def bitflip(self, p, q):     return self.append_channel("bitflip", [q], p)
    def phaseflip(self, p, q):   return self.append_channel("phaseflip", [q], p)

    def cx(self, c, t):        return self.append("cx", [t, c])
    def cz(self, c, t):        return self.append("cz", [t, c])
    def cp(self, lam, c, t):   return self.append("cp", [t, c], lam)
    def crz(self, th, c, t):   return self.append("crz", [t, c], th)
    def swap(self, a, b_):     return self.append("swap", [a, b_])
    def rzz(self, th, a, b_):  return self.append("rzz", [a, b_], th)
    def rxx(self, th, a, b_):  return self.append("rxx", [a, b_], th)

    # -- parameter binding ---------------------------------------------------
    @property
    def free_parameters(self) -> frozenset[str]:
        """Names of all unbound :class:`Parameter` placeholders."""
        out: set[str] = set()
        for g in self.gates:
            if g.is_parameterized:
                out |= g.free_parameters
        return frozenset(out)

    @property
    def is_parameterized(self) -> bool:
        return any(g.is_parameterized for g in self.gates)

    @property
    def is_stochastic(self) -> bool:
        """True when the circuit contains sampled Pauli channels."""
        return any(g.is_stochastic for g in self.gates)

    def realize(self, rng) -> "Circuit":
        """Draw one concrete noise trajectory: every stochastic channel
        is replaced by a sampled Pauli gate, in circuit order, consuming
        ``rng`` (a seed int or :class:`numpy.random.Generator`).  The
        engine's trajectory lanes use the same stream/order, so the dense
        oracle ``simulate_dense(circuit.realize(seed))`` reproduces lane
        ``seed`` of a batch exactly.
        """
        if isinstance(rng, (int, np.integer)):
            rng = np.random.default_rng(int(rng))
        return Circuit(self.n_qubits,
                       [g.realize(rng) if g.is_stochastic else g
                        for g in self.gates])

    def bind(self, values: Mapping[str, float]) -> "Circuit":
        """Return a concrete circuit with every placeholder substituted.

        ``values`` must cover :attr:`free_parameters`; unknown names raise
        (a typo silently leaving a parameter unbound is the failure mode
        this guards against).
        """
        unknown = set(values) - self.free_parameters
        if unknown:
            raise KeyError(f"unknown parameter(s) {sorted(unknown)}; "
                           f"circuit has {sorted(self.free_parameters)}")
        return Circuit(self.n_qubits, [g.bind(values) for g in self.gates])

    # -- properties ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.gates)

    def __iter__(self) -> Iterable[Gate]:
        return iter(self.gates)

    def qubit_histogram(self) -> dict[int, int]:
        hist: dict[int, int] = {}
        for g in self.gates:
            for q in g.qubits:
                hist[q] = hist.get(q, 0) + 1
        return hist

    def depth(self) -> int:
        """Logical depth (greedy ASAP scheduling)."""
        level = [0] * self.n_qubits
        d = 0
        for g in self.gates:
            lv = max(level[q] for q in g.qubits) + 1
            for q in g.qubits:
                level[q] = lv
            d = max(d, lv)
        return d
