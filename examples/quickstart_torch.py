"""Quickstart on the PyTorch/CUDA port: a compressed simulation session in
~20 lines.  The port's counterpart of ``examples/quickstart.py``.

The session never materializes the 2^n state: samples, expectation
values, and single amplitudes stream straight from the compressed
block store (`statevector()` is the explicit opt-out, used here only to
score fidelity against the dense reference at this small n).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]

``--device cpu`` runs every kernel's plain version on the CPU.
"""
import argparse

import torch

from repro_torch import (EngineConfig, Simulator, build_circuit, fidelity,
                         simulate_dense)
from repro_torch.core.devices import resolve_device


def run_device(name: str) -> torch.device:
    """``--device`` as a torch device; a bare ``cuda`` is ``cuda:0``, which
    must exist."""
    return resolve_device(None if name == "cuda" else name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = run_device(args.device)

    qc = build_circuit("qft", 14)                    # 14-qubit QFT
    cfg = EngineConfig(local_bits=8,                 # SV block = 256 amps
                       inner_size=2,                 # Algorithm 1 threshold
                       b_r=1e-3,                     # point-wise rel. bound
                       devices=[dev])
    with Simulator(qc, cfg) as sim:
        result = sim.run()
        stats = sim.stats

        counts = result.sample(1024)                 # streamed readout
        amp0 = result.amplitudes([0])[0]             # one block decoded
        state = result.statevector()                 # opt-in: 2^14 is tiny

    ideal = simulate_dense(qc, device=dev)
    print(f"circuit            : qft, n=14, {stats.n_gates} gates")
    print(f"stages (Alg. 1)    : {stats.n_stages} "
          f"(vs {stats.n_gates} per-gate compressions in SC19-Sim)")
    print(f"fidelity           : {fidelity(ideal, state):.6f}")
    print(f"peak memory        : {stats.peak_total_bytes/2**20:.2f} MiB "
          f"(standard: {stats.standard_bytes/2**20:.1f} MiB, "
          f"{stats.memory_reduction:.1f}x less)")
    print(f"readout            : {len(counts)} distinct outcomes in 1024 "
          f"shots, |<0|psi>| = {abs(amp0):.6f}")


if __name__ == "__main__":
    main()
