"""NWQBench-style benchmark circuits (paper §5.1).

Eight circuits: cat_state, cc, ising, qft, bv, qsvm, ghz_state, qaoa —
the suite BMQSIM is evaluated on, re-implemented from their standard
definitions (QASMBench / NWQBench).  Plus a random-circuit generator
for property tests.
"""
from __future__ import annotations

import math

import numpy as np

from .circuit import Circuit, Parameter

__all__ = ["build_circuit", "CIRCUIT_BUILDERS", "random_circuit",
           "maxcut_edges", "maxcut_cost_fn", "qaoa_template",
           "with_depolarizing", "zsum_cost_fn"]


def cat_state(n: int) -> Circuit:
    """|0..0> + |1..1> via H + CX chain."""
    qc = Circuit(n)
    qc.h(0)
    for q in range(n - 1):
        qc.cx(q, q + 1)
    return qc


def ghz_state(n: int) -> Circuit:
    """GHZ via H + CX star (control fixed at qubit 0)."""
    qc = Circuit(n)
    qc.h(0)
    for q in range(1, n):
        qc.cx(0, q)
    return qc


def bv(n: int, secret: int | None = None) -> Circuit:
    """Bernstein–Vazirani with an n-1 bit secret and ancilla at qubit n-1."""
    qc = Circuit(n)
    if secret is None:
        rng = np.random.default_rng(n)  # deterministic per size
        secret = int(rng.integers(1, 2 ** (n - 1)))
    anc = n - 1
    qc.x(anc)
    for q in range(n):
        qc.h(q)
    for q in range(n - 1):
        if (secret >> q) & 1:
            qc.cx(q, anc)
    for q in range(n - 1):
        qc.h(q)
    return qc


def cc(n: int) -> Circuit:
    """Counterfeit-coin finding (QASMBench `cc`): query superposition over
    n-1 coin qubits, balance oracle onto the ancilla, then interference."""
    qc = Circuit(n)
    anc = n - 1
    rng = np.random.default_rng(7 * n + 1)
    fake = int(rng.integers(0, n - 1))
    for q in range(n - 1):
        qc.h(q)
    # oracle: flip ancilla controlled on each weighed coin, fake coin marked
    for q in range(n - 1):
        qc.cx(q, anc)
    qc.h(anc)
    qc.cx(fake, anc)
    qc.h(anc)
    for q in range(n - 1):
        qc.cx(q, anc)
    for q in range(n - 1):
        qc.h(q)
    return qc


def ising(n: int, layers: int = 2) -> Circuit:
    """Trotterized transverse-field Ising evolution on a 1-D chain."""
    qc = Circuit(n)
    rng = np.random.default_rng(13 * n + layers)
    for q in range(n):
        qc.h(q)
    for _ in range(layers):
        jj = float(rng.uniform(0.2, 1.0))
        hh = float(rng.uniform(0.2, 1.0))
        for q in range(n - 1):
            qc.rzz(2.0 * jj * 0.1, q, q + 1)
        for q in range(n):
            qc.rx(2.0 * hh * 0.1, q)
    return qc


def qft(n: int, swaps: bool = True) -> Circuit:
    """Quantum Fourier transform (the paper's stage-count example)."""
    qc = Circuit(n)
    for q in range(n - 1, -1, -1):
        qc.h(q)
        for j in range(q - 1, -1, -1):
            qc.cp(math.pi / (2 ** (q - j)), j, q)
    if swaps:
        for q in range(n // 2):
            qc.swap(q, n - 1 - q)
    return qc


def qsvm(n: int, reps: int = 2) -> Circuit:
    """ZZ-feature-map kernel circuit (QSVM): U(x) then U(x')^dagger."""
    rng = np.random.default_rng(17 * n + reps)
    x1 = rng.uniform(0, 2 * math.pi, size=n)
    x2 = rng.uniform(0, 2 * math.pi, size=n)

    qc = Circuit(n)

    def feature_map(x: np.ndarray, inverse: bool) -> None:
        ops: list[tuple] = []
        for _ in range(reps):
            for q in range(n):
                ops.append(("h", q))
                ops.append(("p", 2.0 * float(x[q]), q))
            for q in range(n - 1):
                ang = 2.0 * float((math.pi - x[q]) * (math.pi - x[q + 1])) / math.pi
                ops.append(("cx", q, q + 1))
                ops.append(("p", ang, q + 1))
                ops.append(("cx", q, q + 1))
        if inverse:
            for op in reversed(ops):
                if op[0] == "h":
                    qc.h(op[1])
                elif op[0] == "p":
                    qc.p(-op[1], op[2])
                else:
                    qc.cx(op[1], op[2])
        else:
            for op in ops:
                if op[0] == "h":
                    qc.h(op[1])
                elif op[0] == "p":
                    qc.p(op[1], op[2])
                else:
                    qc.cx(op[1], op[2])

    feature_map(x1, inverse=False)
    feature_map(x2, inverse=True)
    return qc


def qaoa(n: int, layers: int = 2) -> Circuit:
    """QAOA MaxCut with fixed pseudo-random angles on the same graph as
    :func:`qaoa_template` (score it with
    ``maxcut_cost_fn(maxcut_edges(n))``)."""
    rng = np.random.default_rng(23 * n + layers)
    edges = maxcut_edges(n)

    qc = Circuit(n)
    for q in range(n):
        qc.h(q)
    for _ in range(layers):
        gamma = float(rng.uniform(0.1, math.pi))
        beta = float(rng.uniform(0.1, math.pi))
        for (a, b_) in sorted(edges):
            qc.rzz(gamma, a, b_)
        for q in range(n):
            qc.rx(2.0 * beta, q)
    return qc


def maxcut_edges(n: int, seed: int | None = None) -> list[tuple[int, int]]:
    """Deterministic pseudo-random 3-regular-ish MaxCut graph on n nodes
    (ring backbone + chords) — the graph behind :func:`qaoa_template`
    and :func:`qaoa`."""
    if n < 2:
        raise ValueError(f"MaxCut needs >= 2 nodes, got {n}")
    rng = np.random.default_rng(29 * n + 5 if seed is None else seed)
    edges: set[tuple[int, int]] = set()
    for q in range(n):
        if q != (q + 1) % n:
            edges.add((min(q, (q + 1) % n), max(q, (q + 1) % n)))
    # chord target capped at C(n,2): small graphs saturate every pair
    target = min(n + max(1, n // 2), n * (n - 1) // 2)
    while len(edges) < target:
        a, b_ = rng.integers(0, n, size=2)
        if a != b_:
            edges.add((min(int(a), int(b_)), max(int(a), int(b_))))
    return sorted(edges)


def maxcut_cost_fn(edges: list[tuple[int, int]]):
    """Vectorized diagonal MaxCut observable: cut size per basis index.

    Returns ``diag_fn(indices) -> values`` suitable for
    :meth:`SimResult.expectation` / :func:`measure.expect_diagonal`.
    """
    def diag_fn(idx):
        idx = np.asarray(idx, dtype=np.int64)
        acc = np.zeros(idx.shape, dtype=np.float64)
        for (a, b_) in edges:
            acc += ((idx >> a) & 1) ^ ((idx >> b_) & 1)
        return acc
    return diag_fn


def qaoa_template(n: int, layers: int = 1) -> Circuit:
    """Parameterized QAOA MaxCut ansatz over :func:`maxcut_edges`.

    Layer ``l`` exposes :class:`Parameter` placeholders ``gamma{l}`` (cost
    angle) and ``beta{l}`` (mixer angle); bind or pass them per run::

        sim = Simulator(qaoa_template(18, layers=1), cfg)
        r = sim.run(params={"gamma0": 0.8, "beta0": 0.4})
    """
    edges = maxcut_edges(n)
    qc = Circuit(n)
    for q in range(n):
        qc.h(q)
    for layer in range(layers):
        gamma = Parameter(f"gamma{layer}")
        beta = Parameter(f"beta{layer}")
        for (a, b_) in edges:
            qc.rzz(gamma, a, b_)
        for q in range(n):
            qc.rx(beta, q)
    return qc


def with_depolarizing(circuit: Circuit, p: float) -> Circuit:
    """Standard stochastic noise model: a 1-qubit depolarizing channel
    (probability ``p``) after every gate, on each of the gate's qubits.

    The result is a *stochastic* circuit — run it with
    ``Simulator.run(trajectories=K)`` / :meth:`Simulator.run_batch`,
    which draw per-trajectory Pauli realizations at bind time and share
    the partition/schedules across all lanes.
    """
    noisy = Circuit(circuit.n_qubits)
    for g in circuit.gates:
        noisy.gates.append(g)
        for q in g.qubits:
            noisy.depolarize(p, q)
    return noisy


def zsum_cost_fn(n: int):
    """Vectorized diagonal ``<sum_i Z_i>`` observable (trajectory tests:
    a product state's value degrades as ``n * (1 - 4p/3)`` per layer of
    depolarizing noise)."""
    def diag_fn(idx):
        idx = np.asarray(idx, dtype=np.int64)
        pop = np.zeros(idx.shape, dtype=np.int64)
        for k in range(n):
            pop += (idx >> k) & 1
        return (n - 2 * pop).astype(np.float64)
    return diag_fn


CIRCUIT_BUILDERS = {
    "cat_state": cat_state,
    "cc": cc,
    "ising": ising,
    "qft": qft,
    "bv": bv,
    "qsvm": qsvm,
    "ghz_state": ghz_state,
    "qaoa": qaoa,
}


def build_circuit(name: str, n_qubits: int, **kwargs) -> Circuit:
    """Instantiate a named benchmark circuit from :data:`CIRCUIT_BUILDERS`."""
    if name not in CIRCUIT_BUILDERS:
        raise KeyError(f"unknown circuit {name!r}; have {sorted(CIRCUIT_BUILDERS)}")
    return CIRCUIT_BUILDERS[name](n_qubits, **kwargs)


def random_circuit(n: int, n_gates: int, seed: int = 0,
                   two_qubit_frac: float = 0.35) -> Circuit:
    """Random circuit over the full gate library (property tests)."""
    rng = np.random.default_rng(seed)
    qc = Circuit(n)
    one_q = ["h", "x", "y", "z", "s", "t", "sdg", "tdg"]
    one_q_param = ["rx", "ry", "rz", "p"]
    two_q = ["cx", "cz", "swap"]
    two_q_param = ["cp", "crz", "rzz", "rxx"]
    for _ in range(n_gates):
        if n >= 2 and rng.random() < two_qubit_frac:
            a, b_ = map(int, rng.choice(n, size=2, replace=False))
            if rng.random() < 0.5:
                qc.append(str(rng.choice(two_q)), [a, b_])
            else:
                qc.append(str(rng.choice(two_q_param)), [a, b_],
                          float(rng.uniform(0, 2 * math.pi)))
        else:
            q = int(rng.integers(0, n))
            if rng.random() < 0.5:
                qc.append(str(rng.choice(one_q)), [q])
            else:
                if rng.random() < 0.25:
                    qc.append("u3", [q], *rng.uniform(0, 2 * math.pi, size=3))
                else:
                    qc.append(str(rng.choice(one_q_param)), [q],
                              float(rng.uniform(0, 2 * math.pi)))
    return qc
