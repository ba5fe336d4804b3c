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
                 Gate, Parameter
    Sessions     Simulator, SimResult, EngineConfig, SimStats
    Planning     ExecutionPlan (Simulator.compile), StagePlan,
                 PlanPredictions
    One-shot     simulate_bmqsim (compat wrapper), simulate_dense
    Metrics      fidelity, max_pointwise_rel_error
    Compression  PwRelParams, compress_complex_block,
                 decompress_complex_block, BlockSegments, BlockStore
    Resilience   inject_faults / FaultSpec, typed failures,
                 PressureMonitor

Not ported yet (they raise ``NotImplementedError``): the device codec
(``codec_backend="device"``), batched runs (``Simulator.run_batch``,
``run(trajectories=K)``), several devices or a mesh, and the per-gate path
(``gate_schedule=False``).  ``SimService`` and the noise-channel helpers
are not exported yet.

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
    BMQSimEngine, Circuit, EngineConfig, ExecutionPlan, FaultInjector,
    FaultSpec, Gate, InjectedCrash, Parameter, PlanPredictions,
    PressureMonitor, SimResult, SimStats, Simulator, StagePlan,
    build_circuit, fidelity, inject_faults, max_pointwise_rel_error,
    maxcut_cost_fn, maxcut_edges, qaoa_template, random_circuit,
    simulate_bmqsim, simulate_dense, zsum_cost_fn,
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
    "Simulator", "SimResult", "EngineConfig", "SimStats",
    # observables
    "zsum_cost_fn",
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
