"""BMQSIM core: the paper's contribution (compressed staged SV simulation)."""
from .circuit import CHANNEL_FACTORIES, Circuit, Gate, Parameter  # noqa: F401
from .dense_engine import apply_matrix, initial_state, simulate_dense  # noqa: F401
from .devices import resolve_device  # noqa: F401
from .engine import BMQSimEngine, EngineConfig, SimStats, simulate_bmqsim  # noqa: F401
from .faults import (  # noqa: F401
    INJECTION_POINTS, FaultInjector, FaultSpec, InjectedCrash, inject_faults,
)
from .fidelity import fidelity, max_pointwise_rel_error, norm  # noqa: F401
from .fusion import FusedGate, fuse_gates, gates_to_unitary  # noqa: F401
from .groups import GroupLayout, expand_bits  # noqa: F401
from .library import (  # noqa: F401
    CIRCUIT_BUILDERS, build_circuit, maxcut_cost_fn, maxcut_edges,
    qaoa_template, random_circuit, with_depolarizing, zsum_cost_fn,
)
from .partition import Partition, Stage, partition_circuit  # noqa: F401
from .plan import ExecutionPlan, PlanPredictions, StagePlan  # noqa: F401
from .pressure import RUNGS, PressureMonitor  # noqa: F401
from .planner import (PipelineCalibration, estimate_bytes_per_amp,  # noqa: F401
                      predict_depth_speedup, resolve_config)
from .pipeline import (  # noqa: F401
    CodecBackend, HostCodecBackend, StagePipeline, make_backend,
)
from .measure import block_probabilities, expect_diagonal, sample_counts  # noqa: F401
from .result import BatchResult, SimResult  # noqa: F401
from .schedule import StageSchedule, compile_schedule, execute_schedule_batched  # noqa: F401
from .simulator import Simulator, circuit_fingerprint  # noqa: F401
