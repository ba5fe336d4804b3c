"""Quantum-simulation launcher (the paper's own workload at scale):
BMQSIM session over one or several devices with a RAM budget + disk
tier, plus compressed-store readout — the 2^n state is never
materialized.

    PYTHONPATH=src python -m repro_torch.launch.qsim --circuit qft \
        --qubits 20 [--device cuda|cpu] [--devices 4] \
        [--noise 0.02 --trajectories 8 | --batch 4] [--block-bits 14] [--memory-budget 64] [--explain] [--ram-mb 64] \
        [--shots 1024] [--expect zsum] [--save ck.bmq | --resume ck.bmq] \
        [--checkpoint-every 2] [--inject store.spill_read:ioerror:hit=3] \
        [--disk-budget 256] [--no-guardrails]

``--block-bits`` defaults to **auto**: the planner picks
``(local_bits, inner_size, pipeline_depth)`` under ``--memory-budget``
(MiB) when given.  ``--explain`` prints the compiled
:class:`~repro_torch.core.plan.ExecutionPlan` — stage layouts, predicted
working set and boundary traffic — and exits without executing a stage.
``--verify`` instead runs the plan through the static verifier
(:mod:`repro_torch.analysis.plan_check`) and exits nonzero on any error
finding — also without executing a stage.

The PyTorch port of ``repro.launch.qsim``: the run's device is
``--device`` (default ``cuda``, i.e. ``cuda:0``, which must exist; ``cpu``
runs every kernel's plain version).  ``--devices D`` runs on D device
slots, where ``repro`` makes D virtual host devices: with ``--device cpu``
D slots on the CPU, with ``--device cuda`` the first D visible cards,
``cuda:0`` repeated where there are fewer (a line says how many physical
devices back the slots).  A batched run lane-shards over the slots, a
single run block-shards its groups and prints the exchange ledger.
"""
import argparse
import contextlib

import torch

from ..core import (EngineConfig, Simulator, build_circuit,
                    with_depolarizing, zsum_cost_fn)
from ..core.faults import INJECTION_POINTS, inject_faults
from ..core.planner import estimate_bytes_per_amp
from ..distributed.lanes import visible_devices
from ..errors import ResumableError


def _device_slots(device: str, n: int) -> list | None:
    """The run's device list for ``--device`` and ``--devices n``: n slots
    on the CPU, or the first n visible cards with ``cuda:0`` repeated
    where there are fewer; None (``cuda:0``, which must exist) for one
    card."""
    if device == "cpu":
        return [torch.device("cpu")] * n
    if n == 1:
        return None
    cards = visible_devices()[:n]
    return cards + [cards[0]] * (n - len(cards))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--circuit", default="qft")
    ap.add_argument("--qubits", type=int, default=18)
    ap.add_argument("--block-bits", type=int, default=None,
                    help="b: SV block = 2^b amplitudes (default: auto — "
                         "the planner chooses under --memory-budget)")
    ap.add_argument("--inner-size", type=int, default=None,
                    help="Algorithm 1 stage threshold (default: auto)")
    ap.add_argument("--b-r", type=float, default=1e-3)
    ap.add_argument("--memory-budget", type=float, default=None,
                    metavar="MIB",
                    help="working-set budget the planner tunes "
                         "(local_bits, inner_size, pipeline_depth) "
                         "against; also the store's RAM backstop")
    ap.add_argument("--explain", action="store_true",
                    help="print the compiled ExecutionPlan (stage "
                         "layouts, predicted working set/traffic) and "
                         "exit without executing")
    ap.add_argument("--verify", action="store_true",
                    help="compile the plan and run the static verifier "
                         "(layout chain, gate tiling, schedule identity, "
                         "byte predictions) against the circuit, then "
                         "exit without executing; nonzero on any error "
                         "finding")
    ap.add_argument("--ram-mb", type=float, default=None)
    ap.add_argument("--pipeline-depth", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the run's device: cuda (cuda:0, the default; "
                         "it must exist) or cpu (every kernel's plain "
                         "version)")
    ap.add_argument("--devices", type=int, default=None, metavar="D",
                    help="run on D device slots: lanes shard across "
                         "them when batched, SV block groups shard "
                         "across them otherwise (only encoded wire "
                         "crosses); the first D cards of --device cuda, "
                         "cuda:0 repeated where there are fewer, or D "
                         "slots of --device cpu")
    ap.add_argument("--codec-backend", default="host",
                    choices=("host", "device"),
                    help="where the lossy codec runs; 'device' ships only "
                         "the compressed wire across the host-device "
                         "boundary (§4.3)")
    ap.add_argument("--use-kernel", dest="use_kernel", action="store_true",
                    default=True,
                    help="apply gates via the hand-written plane kernels "
                         "(default; --no-kernel for plain torch "
                         "products)")
    ap.add_argument("--no-kernel", dest="use_kernel", action="store_false")
    ap.add_argument("--no-schedule", dest="gate_schedule",
                    action="store_false", default=True,
                    help="disable the transpose-minimizing stage schedule "
                         "and run the per-gate transpose/apply/inverse "
                         "path (for comparison)")
    ap.add_argument("--noise", type=float, default=None, metavar="P",
                    help="insert a depolarizing Pauli channel with "
                         "probability P after every gate (stochastic "
                         "circuit; needs --trajectories)")
    ap.add_argument("--trajectories", type=int, default=None, metavar="K",
                    help="sample K noise trajectories as ONE lane-batched "
                         "run; --expect reports the trajectory average")
    ap.add_argument("--batch", type=int, default=None, metavar="K",
                    help="run K identical lanes of a deterministic "
                         "circuit through the batched engine (one "
                         "stage call per wave covers all lanes)")
    ap.add_argument("--noise-seed", type=int, default=0,
                    help="base trajectory seed (lane j draws with "
                         "seed+j)")
    ap.add_argument("--shots", type=int, default=0,
                    help="sample N bitstrings from the compressed final "
                         "state (streamed; prints the top-5 outcomes)")
    ap.add_argument("--expect", default=None, choices=("zsum",),
                    help="streamed diagonal expectation value: 'zsum' = "
                         "<sum_i Z_i>")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="checkpoint the compressed final state to PATH")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                    help="with --save: also snapshot the store to PATH "
                         "every K stages DURING the run, so a crash is "
                         "resumable from the last completed checkpoint "
                         "(and a detected blob corruption auto-replays "
                         "in-process)")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="read a saved checkpoint out (readout flags "
                         "still apply); a PARTIAL mid-run checkpoint is "
                         "finished first (pass the same --circuit/"
                         "--qubits it was launched with)")
    ap.add_argument("--inject", action="append", default=None,
                    metavar="SPEC",
                    help="deterministic fault injection for resilience "
                         "drills: 'point:kind[:hit=N[,M]][:p=F]"
                         "[:times=K]' with kind in ioerror|corrupt|crash"
                         " and point one of "
                         + "|".join(sorted(INJECTION_POINTS))
                         + "; repeatable")
    ap.add_argument("--inject-seed", type=int, default=0,
                    help="seed for probabilistic injection draws and "
                         "corruption positions")
    ap.add_argument("--disk-budget", type=float, default=None,
                    metavar="MIB",
                    help="byte budget for the spill tier; overflowing it "
                         "aborts at a stage boundary with an emergency "
                         "checkpoint (the pressure ladder's final rung)")
    ap.add_argument("--no-guardrails", action="store_true",
                    help="disable block checksums and the memory-"
                         "pressure monitor (benchmark baseline)")
    args = ap.parse_args(argv)

    if args.devices is not None and args.devices < 1:
        ap.error("--devices needs a positive device count")
    # cuda: the default device, cuda:0, which must exist
    devices = _device_slots(args.device, args.devices or 1)
    if args.devices and args.devices > 1:
        physical = list(dict.fromkeys(devices))
        print(f"[qsim] {args.devices} device slots on {len(physical)} "
              f"physical device(s): {', '.join(map(str, physical))}")

    lanes = args.trajectories or args.batch
    if args.trajectories and args.batch:
        ap.error("--trajectories and --batch are exclusive (both set "
                 "the lane count)")
    if args.noise is not None and not args.trajectories:
        ap.error("--noise makes the circuit stochastic; pass "
                 "--trajectories K to sample it")
    if lanes and (args.save or args.resume):
        ap.error("checkpointing a batched run is not supported; drop "
                 "--save/--resume or the batch flags")
    if args.checkpoint_every and not (args.save or args.resume):
        ap.error("--checkpoint-every needs --save PATH (the checkpoint "
                 "file to roll forward; with --resume it rolls that "
                 "checkpoint forward)")

    inject_ctx = (inject_faults(args.inject, seed=args.inject_seed)
                  if args.inject else contextlib.nullcontext())
    if args.inject:
        print(f"[qsim] injecting faults (seed {args.inject_seed}): "
              + "; ".join(args.inject))

    batch = None                       # BatchResult of a lane-batched run
    if args.resume:
        if args.explain or args.verify:
            ap.error("--explain/--verify need a circuit to compile; they "
                     "cannot be combined with --resume (a checkpoint is "
                     "a finished state, not a plan)")
        try:
            sim = Simulator.resume(args.resume)
            result = sim.result()
        except ValueError as e:
            if "partial checkpoint" not in str(e):
                raise
            # mid-run checkpoint: rebuild the circuit and finish the run
            qc = build_circuit(args.circuit, args.qubits)
            sim = Simulator.resume(args.resume, circuit=qc,
                                   config=EngineConfig(devices=devices))
            print(f"[qsim] partial checkpoint "
                  f"({sim._start_stage}/{sim._engine.partition.n_stages} "
                  f"stages done); finishing the run")
            with inject_ctx:
                result = sim.run(checkpoint_path=args.resume
                                 if args.checkpoint_every else None,
                                 checkpoint_every=args.checkpoint_every)
        n = result.n_qubits
        print(f"[qsim] resumed {args.resume}: n={n}, "
              f"local_bits={result.local_bits}")
    else:
        n = args.qubits
        qc = build_circuit(args.circuit, n)
        if args.noise is not None:
            qc = with_depolarizing(qc, args.noise)
        cfg = EngineConfig(
            local_bits=args.block_bits, inner_size=args.inner_size,
            b_r=args.b_r, pipeline_depth=args.pipeline_depth,
            codec_backend=args.codec_backend,
            use_kernel=args.use_kernel, gate_schedule=args.gate_schedule,
            devices=devices,
            batch=lanes or 1,
            memory_budget_bytes=(int(args.memory_budget * 2 ** 20)
                                 if args.memory_budget else None),
            ram_budget_bytes=(int(args.ram_mb * 2 ** 20)
                              if args.ram_mb else None),
            disk_budget_bytes=(int(args.disk_budget * 2 ** 20)
                               if args.disk_budget else None),
            integrity_checks=not args.no_guardrails,
            pressure_monitor=not args.no_guardrails)
        sim = Simulator(qc, cfg)
        if args.verify:
            from ..analysis.plan_check import verify_plan
            plan = sim.compile(verify=False)   # verify_plan prints below
            findings = verify_plan(plan, sim.circuit)
            for f in findings:
                print(f.render())
            errors = sum(f.severity == "error" for f in findings)
            print(f"[qsim] plan {plan.fingerprint[:12]}: "
                  f"{plan.n_stages} stage(s) verified, {errors} error(s), "
                  f"{len(findings) - errors} warning(s); no stage executed")
            sim.close()
            return 1 if errors else 0
        if args.explain:
            print(sim.compile().describe())
            rcfg = sim.config
            if rcfg.pressure_monitor:
                bpa = estimate_bytes_per_amp(rcfg.b_r, rcfg.compression)
                ladder = ("shrink_window -> wave_depth_1 -> "
                          "proactive_spill"
                          + (" -> abort+emergency-checkpoint"
                             if args.disk_budget else ""))
                print(f"[qsim] resilience: checksums="
                      f"{'on' if rcfg.integrity_checks else 'off'} "
                      f"io_retries={rcfg.io_retries}; pressure ladder "
                      f"armed at >{rcfg.pressure_headroom:g}x predicted "
                      f"{bpa:.2f} B/amp: {ladder}")
            else:
                print("[qsim] resilience: guardrails off "
                      "(--no-guardrails)")
            sim.close()
            return 0
        rcfg = sim.config
        if args.block_bits is None:
            print(f"[qsim] planned: local_bits={rcfg.local_bits} "
                  f"inner_size={rcfg.inner_size} "
                  f"pipeline_depth={rcfg.pipeline_depth}"
                  + (f" under {args.memory_budget:g} MiB budget"
                     if args.memory_budget else " (no budget: heuristic)"))
        try:
            with inject_ctx:
                if lanes:
                    batch = sim.run(trajectories=lanes,
                                    seed=args.noise_seed)
                    result = batch[0]  # readout flags stream lane 0
                else:
                    result = sim.run(
                        checkpoint_path=(args.save
                                         if args.checkpoint_every
                                         else None),
                        checkpoint_every=args.checkpoint_every)
        except ResumableError as e:
            print(f"[qsim] run failed but is resumable: {e}")
            print(f"[qsim] continue with: qsim --circuit {args.circuit} "
                  f"--qubits {n} --resume {e.resume_path}")
            sim.close()
            return 1
        stats = sim.stats
        if lanes:
            kind = "trajectories" if args.trajectories else "lanes"
            print(f"[qsim] batched run: {lanes} {kind} in "
                  f"{stats.n_batch_chunks} sub-batch(es)"
                  + (f", depolarizing p={args.noise:g}"
                     if args.noise is not None else ""))
        print(f"[qsim] {args.circuit} n={n}: {stats.n_gates} gates, "
              f"{stats.n_stages} stages, {stats.n_fused_unitaries} fused")
        print(f"[qsim] peak {stats.peak_total_bytes/2**20:.1f} MiB "
              f"({stats.memory_reduction:.1f}x less than standard), "
              f"spills={stats.n_spills}")
        print(f"[qsim] total {stats.t_total:.2f}s "
              f"(decomp {stats.t_decompress:.2f}"
              f" compute {stats.t_compute:.2f} fetch {stats.t_fetch:.2f}"
              f" comp {stats.t_compress:.2f})")
        print(f"[qsim] group transposes: {stats.n_transposes_scheduled} "
              f"scheduled vs {stats.n_transposes_naive} per-gate")
        print(f"[qsim] boundary traffic ({args.codec_backend} codec): "
              f"{stats.h2d_bytes/2**20:.2f} MiB h2d, "
              f"{stats.d2h_bytes/2**20:.2f} MiB d2h "
              f"over {stats.n_stages} stages")
        if args.devices and args.devices > 1:
            print(f"[qsim] device exchange ({args.devices} devices): "
                  f"{stats.exchange_bytes/2**20:.2f} MiB encoded wire "
                  f"over {stats.n_exchanged_blocks} block hand-off(s)")
        if (stats.n_io_retries or stats.n_replays
                or stats.n_corruptions_detected or stats.n_pressure_events):
            print(f"[qsim] resilience: io_retries={stats.n_io_retries} "
                  f"replays={stats.n_replays} corruptions_detected="
                  f"{stats.n_corruptions_detected} pressure_rungs="
                  f"{','.join(stats.pressure_rungs) or 'none'}")

    # readout streams the compressed store — one decoded block at a time
    if args.shots:
        counts = result.sample(args.shots, seed=0)
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:5]
        print(f"[qsim] top-5 of {args.shots} shots: "
              + ", ".join(f"|{k:0{n}b}>x{v}" for k, v in top))
    if args.expect == "zsum":
        if batch is None:
            val = result.expectation(zsum_cost_fn(n))
            print(f"[qsim] <sum Z_i> = {val:.6f}")
        else:
            vals = batch.expectations(zsum_cost_fn(n))
            print(f"[qsim] <sum Z_i> = {vals.mean():.6f} "
                  f"(avg over {len(vals)} lanes, "
                  f"std {vals.std():.6f})")
    if args.save:
        result.save(args.save)
        print(f"[qsim] checkpoint -> {args.save}")
    sim.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
