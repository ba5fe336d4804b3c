"""Simulation service launcher: plan-admission scheduling + continuous
lane batching over a structure-keyed session pool.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --jobs qft:12x4,ising:12x2 --memory-budget 8 --shots 128 \
        [--device cuda|cpu]

Submits the ``--jobs`` workload to an in-process
:class:`~repro_torch.core.service.SimService` — every request is priced at its
:class:`~repro_torch.core.plan.ExecutionPlan`'s predicted peak RAM and
admitted/queued/rejected against the global ``--memory-budget``;
co-admitted requests sharing a circuit *structure* merge into one
``run_batch`` lane stack (cold compile once per structure, warm cache
after) — then drains the scheduler round by round and prints per-job
admission decisions, per-round batch dispatches, and the service stats
line.  See docs/SERVING.md for the operator guide.

Workload spec: ``name:qubits[xCOUNT]``, comma-separated, e.g.
``qft:12x4,ising:12x2,ghz_state:10`` (circuit names from
``repro_torch.core.library.CIRCUIT_BUILDERS``).  The port of
``repro.launch.serve``: sessions run on ``--device`` (default ``cuda``,
i.e. ``cuda:0``; ``cpu`` runs every kernel's plain version).
"""
import argparse

import torch

from ..core import EngineConfig, SimService, build_circuit, with_depolarizing
from ..core.library import CIRCUIT_BUILDERS


def parse_workload(spec: str) -> list[tuple[str, int]]:
    """``"qft:12x4,ising:10"`` -> ``[("qft", 12) x4, ("ising", 10)]``."""
    jobs: list[tuple[str, int]] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        try:
            name, rest = item.split(":", 1)
            if "x" in rest:
                qubits_s, count_s = rest.split("x", 1)
                qubits, count = int(qubits_s), int(count_s)
            else:
                qubits, count = int(rest), 1
        except ValueError:
            raise SystemExit(
                f"bad job spec {item!r} (want name:qubits[xCOUNT])")
        if name not in CIRCUIT_BUILDERS:
            raise SystemExit(
                f"unknown circuit {name!r} (have: "
                f"{', '.join(sorted(CIRCUIT_BUILDERS))})")
        if qubits < 1 or count < 1:
            raise SystemExit(f"bad job spec {item!r}: non-positive size")
        jobs.extend([(name, qubits)] * count)
    if not jobs:
        raise SystemExit("empty --jobs workload")
    return jobs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="in-process quantum-sim service: plan admission + "
                    "continuous lane batching")
    ap.add_argument("--jobs", default="qft:12x4,ising:12x2",
                    help="workload: name:qubits[xCOUNT],... "
                         "(default qft:12x4,ising:12x2)")
    ap.add_argument("--memory-budget", type=float, default=64.0,
                    metavar="MIB",
                    help="global admission budget in MiB (default 64): the "
                         "sum of admitted plans' predicted peak RAM never "
                         "exceeds it")
    ap.add_argument("--block-bits", type=int, default=None,
                    help="SV block size 2^b per session (default: the "
                         "planner auto-tunes under the budget)")
    ap.add_argument("--shots", type=int, default=None,
                    help="sample counts per job (streamed readout)")
    ap.add_argument("--noise", type=float, default=None, metavar="P",
                    help="wrap every circuit with depolarizing channels "
                         "(jobs become seeded noise-trajectory lanes)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base trajectory seed (job i draws seed+i)")
    ap.add_argument("--max-sessions", type=int, default=8,
                    help="session-pool size (LRU eviction past it)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the sessions' device: cuda (cuda:0, the "
                         "default) or cpu")
    ap.add_argument("--interleave", action="store_true",
                    help="submit round-robin across structures instead of "
                         "spec order (more realistic mixed traffic)")
    args = ap.parse_args(argv)

    budget = int(args.memory_budget * 2 ** 20)
    workload = parse_workload(args.jobs)
    if args.interleave:
        by_name: dict[tuple[str, int], list[tuple[str, int]]] = {}
        for item in workload:
            by_name.setdefault(item, []).append(item)
        workload, queues = [], list(by_name.values())
        while queues:
            queues = [q for q in queues if q]
            workload.extend(q.pop(0) for q in queues)

    # cuda: the default device, cuda:0, which must exist
    devices = [torch.device("cpu")] if args.device == "cpu" else None
    config = EngineConfig(local_bits=args.block_bits, devices=devices)
    print(f"[serve] budget {args.memory_budget:g} MiB, "
          f"block-bits {args.block_bits if args.block_bits else 'auto'}, "
          f"session pool <= {args.max_sessions}, "
          f"{len(workload)} job(s): {args.jobs}")

    circuits: dict[tuple[str, int], object] = {}
    with SimService(budget, config=config,
                    max_sessions=args.max_sessions) as svc:
        jobs = []
        for i, (name, qubits) in enumerate(workload):
            key = (name, qubits)
            if key not in circuits:
                qc = build_circuit(name, qubits)
                if args.noise:
                    qc = with_depolarizing(qc, args.noise)
                circuits[key] = qc
            job = svc.submit(circuits[key], seed=args.seed + i,
                             shots=args.shots)
            jobs.append((f"{name}-{qubits}", job))
            peak = job.peak_ram_bytes / 2 ** 20
            print(f"[serve] job {job.job_id:3d} submit {name}-{qubits:<3d}"
                  f" {job.state:8s} {'cold' if job.cold else 'warm'}"
                  f"  peak {peak:.2f} MiB"
                  f"  reserved {svc.reserved_bytes / 2 ** 20:.2f} MiB")

        rnd = 0
        while True:
            done = svc.step()
            if not done:
                break
            rnd += 1
            label = next(lbl for lbl, j in jobs
                         if j.job_id == done[0].job_id)
            print(f"[serve] round {rnd}: {label} x{len(done)} lane(s) "
                  f"merged into one run_batch")
            for job in done:
                lbl = next(lbl for lbl, j in jobs if j.job_id == job.job_id)
                line = (f"[serve] job {job.job_id:3d} {job.state:6s} "
                        f"{lbl:<9s} width {job.merge_width}  "
                        f"wait {job.wait_s:.2f}s  "
                        f"latency {job.latency_s:.2f}s")
                if job.error:
                    line += f"  error {job.error}"
                print(line)

        n_failed = svc.stats.n_failed
        print(f"[serve] stats: {svc.stats.summary()}")
        if args.shots:
            for lbl, job in jobs[:1]:
                if job.state == "done" and "counts" in job.result:
                    top = sorted(job.result["counts"].items(),
                                 key=lambda kv: -kv[1])[:3]
                    pretty = ", ".join(f"{k:#x}:{v}" for k, v in top)
                    print(f"[serve] job {job.job_id} top counts: {pretty}")
    return 1 if n_failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
