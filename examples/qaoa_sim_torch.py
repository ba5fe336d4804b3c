"""End-to-end driver (the paper's workload) on the PyTorch/CUDA port: a
QAOA MaxCut angle sweep on ONE simulation session.  The port's counterpart
of ``examples/qaoa_sim.py``.

The ansatz is a parameterized template — `gamma0`/`beta0` are bound per
`run()`, so the circuit partition, the compiled stage functions, and the
transpose-minimizing schedules are built once and reused across every
point of the sweep (`SimStats.n_stagefn_compiles` stops growing after the
first run).  Energies and samples stream from the compressed store; the
2^n state never materializes.

    PYTHONPATH=src python examples/qaoa_sim_torch.py [--qubits 18] \\
        [--ram-mb 8] [--device cuda]

``--device cpu`` runs every kernel's plain version on the CPU.
"""
import argparse

import torch

from repro_torch import (EngineConfig, Simulator, maxcut_cost_fn,
                         maxcut_edges, qaoa_template)
from repro_torch.core.devices import resolve_device


def run_device(name: str) -> torch.device:
    """``--device`` as a torch device; a bare ``cuda`` is ``cuda:0``, which
    must exist."""
    return resolve_device(None if name == "cuda" else name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--qubits", type=int, default=18)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--block-bits", type=int, default=12)
    ap.add_argument("--sweep", type=int, default=3,
                    help="number of (gamma, beta) points to evaluate")
    ap.add_argument("--ram-mb", type=float, default=None,
                    help="primary-tier budget; overflow spills to disk")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n = args.qubits
    template = qaoa_template(n, layers=args.layers)
    cost = maxcut_cost_fn(maxcut_edges(n))
    cfg = EngineConfig(
        local_bits=args.block_bits, inner_size=2, b_r=1e-3,
        pipeline_depth=2,
        ram_budget_bytes=(int(args.ram_mb * 2 ** 20)
                          if args.ram_mb else None),
        devices=[run_device(args.device)])

    with Simulator(template, cfg) as sim:
        print(f"qaoa n={n}: {len(template.gates)} gates, free params "
              f"{sorted(template.free_parameters)}")
        best = None
        for i in range(args.sweep):
            frac = (i + 1) / (args.sweep + 1)
            params = {}
            for l in range(args.layers):
                params[f"gamma{l}"] = 0.9 * frac
                params[f"beta{l}"] = 0.45 * frac
            result = sim.run(params=params)
            energy = result.expectation(cost)     # streamed, no 2^n array
            compiles = sim.stats.n_stagefn_compiles
            print(f"  run {i + 1}: gamma={params['gamma0']:.3f} "
                  f"beta={params['beta0']:.3f} -> <cut> = {energy:.4f} "
                  f"(stage-fn compiles so far: {compiles})")
            if best is None or energy > best[0]:
                best = (energy, params)

        stats = sim.stats
        assert stats.n_runs == args.sweep
        print(f"sweep of {stats.n_runs} runs compiled "
              f"{stats.n_stagefn_compiles} stage fns once, then scored "
              f"{stats.n_stagefn_cache_hits} cache hits")
        print(f"peak memory {stats.peak_total_bytes/2**20:.1f} MiB "
              f"(standard {stats.standard_bytes/2**20:.1f} MiB, "
              f"{stats.memory_reduction:.1f}x reduction); "
              f"spills={stats.n_spills}")
        print(f"phase times: decompress {stats.t_decompress:.2f}s "
              f"compute {stats.t_compute:.2f}s fetch {stats.t_fetch:.2f}s "
              f"compress {stats.t_compress:.2f}s total {stats.t_total:.2f}s")

        # the last run's handle is live: sample the best-energy angles'
        # state straight from the compressed store (peak extra memory =
        # one decoded block)
        result = sim.run(params=best[1])
        counts = result.sample(1024, seed=0)
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:5]
        print(f"best angles gamma={best[1]['gamma0']:.3f} "
              f"beta={best[1]['beta0']:.3f}; top-5 sampled cuts:",
              [(format(k, f"0{n}b"), v) for k, v in top])


if __name__ == "__main__":
    main()
