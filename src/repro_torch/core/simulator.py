"""Simulator: a persistent session around the compressed engine.

The one-shot :func:`simulate_bmqsim` call re-partitions the circuit and
rebuilds every stage schedule per invocation, and its only readout is the
dense 2^n state — which defeats the memory budget the engine exists to
honor.  The session API fixes both ends:

    sim = Simulator(qaoa_template(24, layers=1), EngineConfig(local_bits=16))
    r1 = sim.run(params={"gamma0": 0.8, "beta0": 0.4})
    e1 = r1.expectation(maxcut_cost_fn(maxcut_edges(24)))
    r2 = sim.run(params={"gamma0": 1.1, "beta0": 0.7})   # NO recompilation
    counts = r2.sample(4096)                              # streams blocks

* **Construction** plans: auto knobs (``local_bits=None`` +
  ``memory_budget_bytes``) resolve through the planner's cost model, and
  the §4.1 partition happens once.  Every ``run()`` reuses it, plus the
  compiled stage functions and transpose-minimizing schedules (cached on
  stage *structure*, which parameter values don't change) —
  ``SimStats.n_stagefn_compiles`` must not grow after the first run of a
  sweep.  :meth:`Simulator.compile` returns the frozen
  :class:`~repro_torch.core.plan.ExecutionPlan` artifact without executing
  anything (``qsim --explain``).
* **Readout** returns a :class:`~repro_torch.core.result.SimResult` handle over
  the compressed store; sampling/expectations/amplitudes stream
  block-by-block with ~one decoded block of peak extra memory.
* **Checkpointing**: ``result.save(path)`` serializes the compressed
  blocks + layout; :meth:`Simulator.resume` reopens them — readout-only
  (no circuit needed), or with the circuit to continue an interrupted
  run from the last checkpointed stage
  (``run(checkpoint_path=..., checkpoint_every=k)``).
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import replace

from ..compression.pwrel import PwRelParams
from ..compression.store import BlockStore
from ..errors import (BlockCorruptionError, MemoryPressureError,
                      ResumableError, StoreIOError)
from .circuit import Circuit
from .engine import BMQSimEngine, EngineConfig, SimStats
from .pipeline import make_backend
from .plan import ExecutionPlan, circuit_fingerprint
from .result import BatchResult, SimResult

__all__ = ["Simulator", "circuit_fingerprint"]

_CKPT_KIND = "bmqsim-checkpoint"
_CKPT_VERSION = 2

#: automatic replays-from-checkpoint after a detected corruption before
#: giving up with a ResumableError (persistent corruption means the
#: medium, not a transient flip)
_MAX_REPLAYS = 2


class Simulator:
    """A simulation session: one partition, many runs, streaming readout.

    Use as a context manager (owns the block store)::

        with Simulator(circuit, config) as sim:
            result = sim.run()
            counts = result.sample(1024)

    A session is either *engine-backed* (constructed from a circuit, can
    ``run()``) or *readout-only* (``Simulator.resume(path)`` without a
    circuit: the checkpointed final state is readable, re-running needs
    the circuit).
    """

    def __init__(self, circuit: Circuit, config: EngineConfig,
                 *, plan: ExecutionPlan | None = None,
                 _store: BlockStore | None = None):
        self._engine: BMQSimEngine | None = \
            BMQSimEngine(circuit, config, store=_store, plan=plan)
        self._backend = self._engine.backend
        self.n_qubits = self._engine.n
        self.local_bits = self._engine.b
        self._meta: dict | None = None
        self._generation = 0
        self._last: SimResult | BatchResult | None = None
        self._batched = False          # latest run was a run_batch
        self._start_stage = 0          # nonzero after a partial resume
        self._resume_params: dict | None = None
        self._closed = False

    # -- session lifecycle -----------------------------------------------------
    def __enter__(self) -> "Simulator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._generation += 1          # invalidate outstanding handles
        if self._engine is not None:
            self._engine.close()
        else:
            self._backend.store.close()

    @property
    def stats(self) -> SimStats | None:
        """Cumulative counters/timings across every run of this session
        (None for a readout-only resumed session)."""
        return self._engine.stats if self._engine is not None else None

    @property
    def circuit(self) -> Circuit | None:
        return self._engine.circuit if self._engine is not None else None

    @property
    def config(self) -> EngineConfig | None:
        """The *resolved* engine config (auto knobs made concrete)."""
        return self._engine.cfg if self._engine is not None else None

    # -- planning --------------------------------------------------------------
    def compile(self, params: dict | None = None, *,
                verify: bool = True) -> ExecutionPlan:
        """Compile (but do not execute) the circuit: returns the
        :class:`~repro_torch.core.plan.ExecutionPlan` this session will run —
        per-stage layouts/fused plans/schedules/stage-fn keys plus the
        planner's working-set and traffic predictions.

        ``params`` is needed iff the circuit template is parameterized
        (fused structure requires concrete matrices); any binding of one
        template yields the same plan, which is cached.  The subsequent
        :meth:`run` executes exactly this plan with zero additional
        schedule compilation.

        With ``verify=True`` (the default) the plan is run through the
        static verifier (:func:`repro_torch.analysis.plan_check.check_plan`)
        before being returned: layout chaining, gate-slice tiling,
        permutation identity and byte-prediction consistency are proven
        against the circuit, and a plan that fails raises
        :class:`~repro_torch.errors.PlanVerificationError`.  This catches
        planner regressions and tampered/stale plan artifacts that the
        fingerprint alone cannot (the fingerprint hashes only the stage
        inner-sets and slice *lengths*).
        """
        if self._closed:
            raise RuntimeError("Simulator is closed")
        if self._engine is None:
            raise RuntimeError(
                "readout-only session (resumed without a circuit) has "
                "no plan to compile; pass circuit= to Simulator.resume")
        plan = self._engine.compile(params)
        if verify:
            # lazy: analysis.plan_check is pure but pulls the planner
            from ..analysis.plan_check import check_plan
            check_plan(plan, self._engine.circuit)
        return plan

    # -- execution -------------------------------------------------------------
    def run(self, params: dict | None = None, *,
            trajectories: int | None = None, seed: int = 0,
            checkpoint_path: str | None = None,
            checkpoint_every: int = 0) -> "SimResult | BatchResult":
        """Execute the circuit; returns a readout handle over the final
        compressed state.

        Args:
            params: values for the circuit's free parameters (required iff
                the circuit template is parameterized).  Re-running with
                new values reuses the partition, compiled stage functions
                and schedules; only the fused gate operands are rebuilt
                (and cached per binding).
            trajectories: run K stochastic noise trajectories of the
                circuit as ONE lane-batched execution and return a
                :class:`BatchResult` (lane j realizes the circuit's Pauli
                channels with rng seed ``seed + j``).  Required for
                circuits containing channels (see
                ``library.with_depolarizing``); a deterministic circuit
                runs K identical lanes (a batching benchmark).
            seed: base trajectory seed (lane j draws with ``seed + j``).
            checkpoint_path: with ``checkpoint_every=k``, snapshot the
                store + progress every k stages so an interrupted run can
                :meth:`resume` from the last completed checkpoint.  A
                blob corruption detected mid-run additionally triggers an
                automatic in-process replay from that checkpoint
                (``stats.n_replays``), and exhausted I/O retries surface
                as a :class:`~repro_torch.errors.ResumableError` naming it.
            checkpoint_every: checkpoint period in stages (0 = never).

        Returns:
            A live :class:`SimResult` (or :class:`BatchResult` with
            ``trajectories``); invalidated by the next ``run()`` or
            :meth:`close` (persist with ``result.save(path)``).
        """
        if trajectories is not None:
            if checkpoint_path or checkpoint_every:
                raise ValueError(
                    "mid-run checkpointing is not supported for batched "
                    "trajectory runs")
            return self.run_batch(
                [params] * trajectories,
                seeds=[seed + j for j in range(trajectories)])
        if self._closed:
            raise RuntimeError("Simulator is closed")
        if self._engine is None:
            raise RuntimeError(
                "readout-only session (resumed without a circuit); pass "
                "circuit= to Simulator.resume to re-run or continue")
        if self._start_stage > 0:
            # continuing a partial checkpoint: the already-executed stages
            # were bound with the checkpointed params — a different
            # binding for the remaining stages would produce a state no
            # single parameter setting generates
            if params is None:
                params = self._resume_params
            elif (BMQSimEngine._params_key(params)
                  != BMQSimEngine._params_key(self._resume_params)):
                raise ValueError(
                    "cannot continue a partial checkpoint with different "
                    f"params: checkpointed {self._resume_params!r}, "
                    f"given {params!r}")
        # validate the binding BEFORE invalidating anything: a bad
        # params dict must not stale the previous (still intact) result
        # or discard a partial checkpoint's resume position.  Cached, so
        # the actual run re-pays nothing.
        self._engine._bind_stages(params)
        start = self._start_stage
        self._start_stage = 0
        self._resume_params = None
        self._generation += 1          # old handles read overwritten blocks
        self._batched = False
        on_stage_done = None
        last_ckpt = {"stage": None}    # last checkpoint written THIS run
        if checkpoint_path and checkpoint_every > 0:
            def on_stage_done(idx: int) -> None:
                if (idx + 1) % checkpoint_every == 0:
                    self._save_checkpoint(checkpoint_path,
                                          stages_done=idx + 1,
                                          run_params=params)
                    last_ckpt["stage"] = idx + 1
        self._run_resilient(params, start, on_stage_done,
                            checkpoint_path, last_ckpt)
        self._last = SimResult(self._backend, self.n_qubits, self.local_bits,
                               stats=self._engine.stats, owner=self,
                               generation=self._generation)
        return self._last

    def _run_resilient(self, params, start, on_stage_done,
                       checkpoint_path, last_ckpt) -> None:
        """Drive ``engine.run`` with the resilience contract.

        * :class:`~repro_torch.errors.BlockCorruptionError` — a blob failed its
          checksum mid-run.  If a checkpoint was written *this run*,
          replay from it (restore the snapshot in place, restart from the
          checkpointed stage; ``stats.n_replays``), up to ``_MAX_REPLAYS``
          times; otherwise (or when corruption persists) propagate.
        * :class:`~repro_torch.errors.MemoryPressureError` — the monitor's
          terminal rung fired at a stage boundary, where the store is
          consistent: flush an emergency checkpoint
          (``stats.n_emergency_checkpoints``) and re-raise carrying its
          ``resume_path``.
        * :class:`~repro_torch.errors.StoreIOError` — retries exhausted
          mid-stage, where the store holds a mix of old/new blocks, so NO
          new snapshot is taken; re-raised as a
          :class:`~repro_torch.errors.ResumableError` naming the last periodic
          checkpoint when one exists.
        """
        eng = self._engine
        replays = 0
        while True:
            try:
                eng.run(collect_state=False, params=params,
                        start_stage=start, on_stage_done=on_stage_done)
                return
            except BlockCorruptionError as e:
                eng._snap_store_stats()
                stage = last_ckpt["stage"]
                if (stage is None or checkpoint_path is None
                        or replays >= _MAX_REPLAYS):
                    if stage is not None and checkpoint_path is not None:
                        raise ResumableError(
                            f"corruption persisted across {replays} "
                            f"replays: {e}",
                            resume_path=checkpoint_path,
                            stages_done=stage) from e
                    raise
                replays += 1
                eng.stats.n_replays += 1
                self._backend.store.load_snapshot(checkpoint_path)
                start = stage
            except MemoryPressureError as e:
                eng._snap_store_stats()
                path = checkpoint_path
                if path is None:
                    fd, path = tempfile.mkstemp(
                        prefix="bmqsim-emergency-", suffix=".ckpt")
                    os.close(fd)
                try:
                    self._save_checkpoint(path, stages_done=e.stages_done,
                                          run_params=params)
                except OSError:
                    # the flush itself failed (e.g. the disk that just
                    # overflowed — snapshot I/O surfaces as StoreIOError,
                    # an OSError): surface the original pressure abort.
                    # An InjectedCrash stays fatal, as a real kill would.
                    raise e from None
                eng.stats.n_emergency_checkpoints += 1
                raise MemoryPressureError(
                    e.args[0], resume_path=path,
                    stages_done=e.stages_done) from e
            except StoreIOError as e:
                eng._snap_store_stats()
                stage = last_ckpt["stage"]
                if stage is not None and checkpoint_path is not None:
                    raise ResumableError(
                        f"store I/O failed after retries ({e})",
                        resume_path=checkpoint_path,
                        stages_done=stage) from e
                raise

    def run_batch(self, params_list, *, seeds=None,
                  checkpoint_path: str | None = None,
                  checkpoint_every: int = 0) -> BatchResult:
        """Execute K parameter bindings (and/or noise trajectories) as
        ONE lane-batched run.

        Every lane shares the partition, the compiled transpose-
        minimizing schedules, and every stage call, boundary crossing
        and store barrier: per (stage, wave) the whole batch costs one
        call (one kernel launch per op) instead of K.

        Args:
            params_list: one params dict (or None) per lane.
            seeds: per-lane trajectory seeds realizing stochastic Pauli
                channels; defaults to ``range(K)`` for a stochastic
                circuit and no draws otherwise.

        Returns:
            A live :class:`BatchResult` — per-lane :class:`SimResult`
            views plus lane-averaged ``expectation`` — invalidated by
            the next run.  When a memory budget is set and K lanes
            exceed it, the engine warns and executes chunked
            sub-batches (``stats.n_batch_chunks``); results are
            identical.

        Mid-run checkpointing is NOT supported for batched runs — the
        store holds K lane states under one manifest, and a snapshot
        taken mid-batch could not be resumed into any single-lane
        session.  Passing ``checkpoint_path``/``checkpoint_every``
        raises ``ValueError`` up front; checkpoint per-binding ``run()``
        calls instead, or persist finished lanes from the
        :class:`BatchResult`.
        """
        if checkpoint_path is not None or checkpoint_every:
            raise ValueError(
                "run_batch does not support mid-run checkpointing: the "
                "store holds K lane states under one manifest and a "
                "mid-batch snapshot cannot be resumed; checkpoint "
                "per-binding run() calls instead, or persist lanes via "
                "BatchResult readout")
        if self._closed:
            raise RuntimeError("Simulator is closed")
        if self._engine is None:
            raise RuntimeError(
                "readout-only session (resumed without a circuit); pass "
                "circuit= to Simulator.resume to re-run")
        if self._start_stage > 0:
            raise RuntimeError(
                "a partial checkpoint is pending; finish it with run() "
                "before starting a batched run")
        params_list = list(params_list)
        if seeds is None:
            seeds = (list(range(len(params_list)))
                     if self._engine._stochastic
                     else [None] * len(params_list))
        if len(seeds) != len(params_list):
            raise ValueError(
                f"{len(params_list)} lanes but {len(seeds)} seeds")
        bindings = tuple(zip(params_list, seeds))
        # validate BEFORE invalidating the previous (still intact) result
        self._engine._validate_bindings(bindings)
        self._generation += 1
        self._batched = True
        self._engine.run_batch(bindings)
        self._last = BatchResult(self._backend, self.n_qubits,
                                 self.local_bits, len(bindings),
                                 stats=self._engine.stats, owner=self,
                                 generation=self._generation)
        return self._last

    def result(self) -> "SimResult | BatchResult":
        """The latest run's (or resumed checkpoint's) readout handle."""
        if self._last is None:
            raise RuntimeError("no result yet: call run() first")
        return self._last

    # -- checkpointing ---------------------------------------------------------
    def _manifest(self, stages_done: int, run_params: dict | None) -> dict:
        if self._engine is not None:
            cfg = self._engine.cfg
            return {
                "kind": _CKPT_KIND, "version": _CKPT_VERSION,
                "n_qubits": self.n_qubits, "local_bits": self.local_bits,
                "inner_size": cfg.inner_size, "b_r": cfg.b_r,
                "compression": cfg.compression, "prescan": cfg.prescan,
                "stages_done": stages_done,
                "n_stages": self._engine.partition.n_stages,
                "fingerprint": circuit_fingerprint(self._engine.circuit),
                "plan_fingerprint": self._engine.plan_fingerprint(),
                # JSON-native coercion: optimizer loops hand np.float64
                # values, which json.dumps inside store.snapshot rejects
                "run_params": (None if run_params is None else
                               {str(k): float(v)
                                for k, v in run_params.items()}),
            }
        return dict(self._meta)        # readout-only: re-save as loaded

    def _save_checkpoint(self, path: str, stages_done: int | None = None,
                         run_params: dict | None = None) -> None:
        if self._batched:
            raise RuntimeError(
                "checkpointing a batched run is not supported: the store "
                "holds K lane states under one manifest; read the lanes "
                "out (BatchResult) or re-run the binding you want to keep")
        if stages_done is None and self._engine is not None:
            stages_done = self._engine.partition.n_stages
        self._backend.store.snapshot(
            path, meta=self._manifest(stages_done, run_params))

    @classmethod
    def resume(cls, path: str, circuit: Circuit | None = None,
               config: EngineConfig | None = None) -> "Simulator":
        """Reopen a checkpoint written by ``result.save`` / mid-run
        checkpointing.

        Without ``circuit``: a readout-only session over the checkpointed
        (complete) final state — ``sim.result()`` streams it.  With
        ``circuit`` (+ optionally ``config``): a full session whose store
        is the checkpoint; a partial checkpoint continues from the first
        unfinished stage on the next ``run()``, a complete one exposes
        ``result()`` immediately.
        """
        store, meta = BlockStore.restore(
            path,
            ram_budget_bytes=config.ram_budget_bytes if config else None,
            spill_dir=config.spill_dir if config else None)
        if meta.get("kind") != _CKPT_KIND:
            store.close()
            raise ValueError(f"{path}: not a {_CKPT_KIND} file")
        complete = meta["stages_done"] == meta["n_stages"]

        if circuit is None:
            if not complete:
                store.close()
                raise ValueError(
                    f"{path} is a partial checkpoint "
                    f"({meta['stages_done']}/{meta['n_stages']} stages); "
                    "pass the circuit to continue the run")
            sim = cls.__new__(cls)
            sim._engine = None
            sim._backend = make_backend(
                "host", store, PwRelParams(b_r=meta["b_r"]),
                2 ** meta["local_bits"], compression=meta["compression"],
                prescan=meta["prescan"])
            sim.n_qubits = meta["n_qubits"]
            sim.local_bits = meta["local_bits"]
            sim._meta = meta
            sim._generation = 1
            sim._batched = False
            sim._start_stage = 0
            sim._resume_params = None
            sim._closed = False
            sim._last = SimResult(sim._backend, sim.n_qubits, sim.local_bits,
                                  owner=sim, generation=1)
            return sim

        if circuit_fingerprint(circuit) != meta["fingerprint"]:
            store.close()
            raise ValueError(
                f"{path}: circuit does not match the checkpointed one "
                "(structural fingerprint mismatch)")
        if config is None:
            config = EngineConfig(local_bits=meta["local_bits"],
                                  inner_size=meta["inner_size"],
                                  b_r=meta["b_r"],
                                  compression=meta["compression"],
                                  prescan=meta["prescan"])
        else:
            # auto knobs (None) adopt the checkpointed values; explicit
            # ones must match — the compressed blocks on disk are laid
            # out for exactly one (local_bits, inner_size) plan
            for attr in ("local_bits", "inner_size", "b_r", "compression",
                         "prescan"):
                given = getattr(config, attr)
                if given is None:
                    continue
                if given != meta[attr]:
                    store.close()
                    raise ValueError(
                        f"{path}: config.{attr}={given!r} "
                        f"!= checkpointed {meta[attr]!r}")
            config = replace(config, local_bits=meta["local_bits"],
                             inner_size=meta["inner_size"])
        sim = cls(circuit, config, _store=store)
        if sim._engine.partition.n_stages != meta["n_stages"]:
            sim.close()
            raise ValueError(
                f"{path}: partition produced "
                f"{sim._engine.partition.n_stages} stages but checkpoint "
                f"recorded {meta['n_stages']}")
        ckpt_pf = meta.get("plan_fingerprint")
        if ckpt_pf is not None and sim._engine.plan_fingerprint() != ckpt_pf:
            sim.close()
            raise ValueError(
                f"{path}: incompatible execution plan — the checkpointed "
                "compressed state was laid out by plan "
                f"{ckpt_pf[:12]} but this session compiles "
                f"{sim._engine.plan_fingerprint()[:12]}")
        sim._meta = meta
        if complete:
            sim._generation = 1
            sim._last = SimResult(sim._backend, sim.n_qubits, sim.local_bits,
                                  stats=sim._engine.stats, owner=sim,
                                  generation=1)
        else:
            sim._start_stage = meta["stages_done"]
            sim._resume_params = meta.get("run_params")
        return sim
