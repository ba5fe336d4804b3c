"""BMQSIM reproduction: compressed, staged state-vector simulation in PyTorch.

Reproduces "Overcoming Memory Constraints in Quantum Circuit Simulation
with a High-Fidelity Compression Framework": a full-state simulator that
holds the state as lossy-compressed SV blocks (point-wise relative error
control, §4.3), partitions the circuit into stages that each touch few
global qubits (§4.1), and pipelines decode/compute/encode per group (§4.2)
over a two-level RAM/disk store (§4.4).

PyTorch/CUDA port of the JAX package ``repro`` (which stays the
reference): the same layout and names, plain PyTorch around hand-written
Hopper kernels.  Entry points run on ``cuda:0`` unless the caller asks for
the CPU (``EngineConfig(devices=[torch.device("cpu")])``), where every
kernel runs its plain PyTorch version.

Public API — the names of ``repro`` that this port has so far:

    Circuits     build_circuit, random_circuit, qaoa_template, Circuit,
                 Gate, Parameter; noise channels via Circuit.depolarize /
                 with_depolarizing (sampled Pauli trajectories)
    Sessions     Simulator, SimResult, EngineConfig, SimStats; batched
                 execution via Simulator.run_batch / run(trajectories=K)
                 -> BatchResult (per-lane views + trajectory averages)
    Planning     ExecutionPlan (Simulator.compile), StagePlan,
                 PlanPredictions
    Service      SimService: plan-admission scheduling + continuous lane
                 batching over a structure-keyed session pool;
                 ServiceStats, Job, VirtualClock
    One-shot     simulate_bmqsim (compat wrapper), simulate_dense
    Metrics      fidelity, max_pointwise_rel_error
    Compression  PwRelParams, compress_complex_block,
                 decompress_complex_block, BlockSegments, BlockStore
    Resilience   inject_faults / FaultSpec, typed failures,
                 PressureMonitor

Both codec backends run: ``codec_backend="host"`` and the device-resident
codec ``codec_backend="device"``, and both stage computes: the scheduled
wave path (default) and the per-gate path (``gate_schedule=False``), as
does the ``per_gate=True`` baseline; batched runs and noise trajectories
run on the scheduled path.  The command lines are ``python -m
repro_torch.launch.qsim``, ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``.
Several devices run too (``EngineConfig(devices=[...])`` or
``mesh_shape=D``): a batch lane-sharded, a single state block-sharded
with its exchange ledger.  The LM serving path
(``repro_torch.models.transformer``, ``repro_torch.serving``, reached by
module path) runs the decoder-only models on the compressed KV cache:
attention layers, full and sliding-window, with dense or MoE
feed-forwards, and the recurrent RG-LRU, mLSTM and sLSTM layers; the
training path (``repro_torch.train``, ``repro_torch.optim``) trains them
on one device, with checkpoints and restarts.

Quickstart::

    from repro_torch import EngineConfig, Simulator, build_circuit

    with Simulator(build_circuit("qft", 14),
                   EngineConfig(local_bits=8)) as sim:
        result = sim.run()
        counts = result.sample(1024)        # streams the compressed store
        amp0 = result.amplitudes([0])[0]
"""
from .compression import (  # noqa: F401
    BlockSegments, BlockStore, CompressedBlock, PwRelParams,
    compress_complex_block, decompress_complex_block,
)
from .core import (  # noqa: F401
    BatchResult, BMQSimEngine, Circuit, EngineConfig, ExecutionPlan,
    FaultInjector, FaultSpec, Gate, InjectedCrash, Job, Parameter,
    PlanPredictions, PressureMonitor, ServiceStats, SimResult, SimService,
    SimStats, Simulator, StagePlan, VirtualClock, build_circuit, fidelity,
    inject_faults, max_pointwise_rel_error, maxcut_cost_fn, maxcut_edges,
    qaoa_template, random_circuit, simulate_bmqsim, simulate_dense,
    with_depolarizing, zsum_cost_fn,
)
from .errors import (  # noqa: F401
    BlockCorruptionError, CheckpointError, MemoryPressureError,
    ResumableError, StoreIOError,
)

__all__ = [
    # circuits
    "Circuit", "Gate", "Parameter", "build_circuit", "random_circuit",
    "qaoa_template", "maxcut_edges", "maxcut_cost_fn",
    # sessions
    "Simulator", "SimResult", "BatchResult", "EngineConfig", "SimStats",
    # service tier
    "SimService", "ServiceStats", "Job", "VirtualClock",
    # noise trajectories
    "with_depolarizing", "zsum_cost_fn",
    # planning
    "ExecutionPlan", "StagePlan", "PlanPredictions",
    # one-shot + internals kept public
    "simulate_bmqsim", "BMQSimEngine", "simulate_dense",
    # metrics
    "fidelity", "max_pointwise_rel_error",
    # compression
    "PwRelParams", "CompressedBlock", "compress_complex_block",
    "decompress_complex_block", "BlockSegments", "BlockStore",
    # resilience
    "FaultSpec", "FaultInjector", "InjectedCrash", "inject_faults",
    "PressureMonitor", "StoreIOError", "BlockCorruptionError",
    "CheckpointError", "ResumableError", "MemoryPressureError",
]

__version__ = "0.4.0"
