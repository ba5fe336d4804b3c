"""Service tier: plan-admission scheduling + continuous lane batching.

A multi-tenant simulation service needs exactly what the planning layer
already provides: every job compiles to an
:class:`~repro_torch.core.plan.ExecutionPlan` whose
``PlanPredictions.peak_ram_bytes`` is a *provable* working-set bound
(backstopped by the store's RAM budget), so admission control can be a
sum instead of a heuristic.  :class:`SimService` turns that into a
scheduler:

* **Session pool keyed by circuit structure.**  One :class:`Simulator`
  per :func:`~repro_torch.core.plan.circuit_fingerprint` — stage functions and
  transpose-minimizing schedules compile once per *structure* (the
  ``SimStats.n_stagefn_cache_hits`` contract), so the first job of a
  structure pays the cold compile and every later one is warm
  (``ServiceStats.n_cold_compiles`` / ``n_warm_hits``).  Idle sessions
  evict LRU past ``max_sessions``.
* **Plan admission.**  ``submit()`` prices the job at
  :func:`~repro_torch.core.planner.peak_ram_for` (plan, lanes=1) and compares
  the *sum of reservations* against the global ``memory_budget_bytes``:
  **reject** only when the job can never fit (``peak_ram > budget`` even
  alone), **admit** (reserve) when it fits now, **queue** when it merely
  can't fit *now*.  The reservation sum never exceeds the budget
  (``ServiceStats.peak_reserved_bytes`` audits the high-water mark).
* **Continuous lane batching.**  Each scheduling round takes the oldest
  admitted job and merges every co-admitted job of the *same structure*
  into one ``run_batch`` lane stack (capped by
  :func:`~repro_torch.core.planner.max_feasible_lanes`) — the sim-engine
  analogue of LLM serving batchers: per (stage, wave) the whole merged
  batch pays one stage call (one kernel launch per op), one boundary
  crossing, one store barrier.  The working-set model is linear in lanes, so the merged
  stack needs exactly the reservations its jobs already hold.

The scheduler is pure Python, single-threaded and **deterministic under
an injected clock** — ``SimService(..., clock=VirtualClock())`` makes
every recorded timestamp (and therefore every latency, every LRU
decision) reproducible in tests.  Network frontends are expected to
serialize into ``submit()``/``step()``; a lock makes that safe but no
concurrency happens inside the service itself.

    svc = SimService(memory_budget_bytes=64 << 20)
    jobs = [svc.submit(qaoa_template(16), params=p, shots=256)
            for p in points]                     # admission decisions
    svc.drain()                                  # merged lane stacks run
    counts = jobs[0].result["counts"]
    print(svc.stats.summary())

The PyTorch port of ``repro.core.service``: the scheduler is the same
code over the port's :class:`Simulator`, whose sessions run on
``cuda:0`` unless ``config.devices`` asks for the CPU.  ``docs/SERVING.md``
is the operator guide (decision table, budget math, merge rules, session
lifecycle).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field, replace
from typing import Callable

from ..errors import (BlockCorruptionError, MemoryPressureError,
                      ResumableError, StoreIOError)
from .engine import EngineConfig
from .planner import estimate_bytes_per_amp, max_feasible_lanes, peak_ram_for
from .simulator import Simulator, circuit_fingerprint

__all__ = ["Job", "ServiceStats", "SimService", "VirtualClock"]

#: job lifecycle states (``Job.state``)
JOB_STATES = ("queued", "admitted", "running", "done", "failed", "rejected")

#: typed engine failures the scheduler absorbs into ``Job.error`` —
#: anything else (including ``InjectedCrash``) propagates to the caller
_JOB_FAILURES = (BlockCorruptionError, MemoryPressureError,
                 ResumableError, StoreIOError)


class VirtualClock:
    """Deterministic clock for tests: time moves only via :meth:`advance`.

    Inject with ``SimService(..., clock=VirtualClock())`` — every
    timestamp the service records then becomes reproducible, so
    scheduler tests can assert exact queueing delays and latencies.
    """

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clocks only move forward (dt={dt})")
        self.now += dt
        return self.now


@dataclass
class Job:
    """One submitted simulation request and its lifecycle record.

    ``state`` walks ``queued | admitted -> running -> done | failed``,
    or is terminally ``rejected`` at submit time.  ``peak_ram_bytes`` is
    the admission price (predicted peak RAM at lanes=1); ``merge_width``
    records how many same-structure jobs shared the lane stack this job
    ran in (1 = solo).  ``result`` holds whatever readout was requested
    at submit — readout is captured *eagerly* while the underlying
    handle is live, so a finished ``Job`` stays valid after the session
    runs its next batch.
    """

    job_id: int
    structure: str                    #: circuit fingerprint (pool key)
    peak_ram_bytes: int               #: admission price at lanes=1
    params: dict | None = None
    seed: int | None = None
    shots: int | None = None
    observable: Callable | None = None
    readout: Callable | None = None
    state: str = "queued"
    cold: bool = False                #: this job triggered the cold compile
    merge_width: int = 0
    result: dict = field(default_factory=dict)
    error: str | None = None
    submitted_at: float | None = None
    admitted_at: float | None = None
    started_at: float | None = None
    finished_at: float | None = None

    @property
    def done(self) -> bool:
        return self.state in ("done", "failed", "rejected")

    @property
    def wait_s(self) -> float | None:
        """Admission-queue delay (None until admitted)."""
        if self.admitted_at is None or self.submitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    @property
    def latency_s(self) -> float | None:
        """Submit-to-finish latency (None until finished)."""
        if self.finished_at is None or self.submitted_at is None:
            return None
        return self.finished_at - self.submitted_at


@dataclass
class ServiceStats:
    """Service-level counters (the analogue of ``SimStats`` one tier up).

    ``n_admitted``/``n_queued``/``n_rejected`` partition the *admission
    decisions at submit time* (a queued job is admitted later without
    re-counting); ``n_cold_compiles``/``n_warm_hits`` partition submits
    by session-pool outcome; ``merge_widths`` records the lane count of
    every dispatched batch (``n_batches`` entries).
    """

    n_submitted: int = 0
    n_admitted: int = 0          #: fit at submit time (reserved immediately)
    n_queued: int = 0            #: had to wait for budget headroom
    n_rejected: int = 0          #: can never fit (peak_ram > budget alone)
    n_completed: int = 0
    n_failed: int = 0
    n_cold_compiles: int = 0     #: structure-pool misses (plan compiled)
    n_warm_hits: int = 0         #: structure-pool hits (plan + stage fns reused)
    n_batches: int = 0           #: lane stacks dispatched
    n_merged_jobs: int = 0       #: jobs that ran at merge_width >= 2
    max_merge_width: int = 0
    merge_widths: list = field(default_factory=list)
    n_sessions_evicted: int = 0
    reserved_bytes: int = 0      #: current admission-reservation sum
    peak_reserved_bytes: int = 0  #: high-water mark (must stay <= budget)

    def summary(self) -> str:
        """The one-line stats form the serve CLI prints and CI asserts."""
        return (f"submitted={self.n_submitted} admitted={self.n_admitted} "
                f"queued={self.n_queued} rejected={self.n_rejected} "
                f"completed={self.n_completed} failed={self.n_failed} "
                f"cold={self.n_cold_compiles} warm={self.n_warm_hits} "
                f"batches={self.n_batches} merged={self.n_merged_jobs} "
                f"max_merge={self.max_merge_width} "
                f"peak_reserved_mib={self.peak_reserved_bytes / 2**20:.2f}")


class _Session:
    """One pooled Simulator + its frozen plan and admission price."""

    __slots__ = ("sim", "plan", "peak1", "last_used", "n_pending")

    def __init__(self, sim: Simulator, plan, peak1: int, now: float):
        self.sim = sim
        self.plan = plan
        self.peak1 = peak1
        self.last_used = now
        self.n_pending = 0           # jobs submitted but not finished


class SimService:
    """Admission-controlled, continuously-batched simulation service.

    Args:
        memory_budget_bytes: global admission budget — the sum of every
            admitted-but-unfinished job's predicted peak RAM never
            exceeds it.
        config: template :class:`EngineConfig` for pooled sessions.
            When it carries neither explicit ``local_bits`` nor its own
            ``memory_budget_bytes``, the service budget is passed down
            so the planner auto-tunes each structure's knobs under it
            (and the store's RAM backstop enforces it at run time).
        max_sessions: session-pool size; least-recently-used idle
            sessions beyond it are closed (their next job is a fresh
            cold compile).
        clock: monotonic time source; inject :class:`VirtualClock` for
            deterministic tests.
    """

    def __init__(self, memory_budget_bytes: int, *,
                 config: EngineConfig | None = None, max_sessions: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        if memory_budget_bytes <= 0:
            raise ValueError("memory_budget_bytes must be positive")
        if max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        self._budget = int(memory_budget_bytes)
        cfg = config if config is not None else EngineConfig()
        if cfg.local_bits is None and cfg.memory_budget_bytes is None:
            # auto knobs with no budget of their own: plan each structure
            # under the service budget (also arms the store backstop)
            cfg = replace(cfg, memory_budget_bytes=self._budget)
        self._config = cfg
        self._max_sessions = max_sessions
        self._clock = clock
        self._lock = threading.RLock()
        self._sessions: OrderedDict[str, _Session] = OrderedDict()
        self._ready: list[Job] = []      # admitted, reserved, arrival order
        self._wait: deque[Job] = deque()  # queued, arrival order
        self._jobs: list[Job] = []
        self._next_id = 0
        self._closed = False
        self.stats = ServiceStats()

    # -- lifecycle -------------------------------------------------------------
    def __enter__(self) -> "SimService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for sess in self._sessions.values():
                sess.sim.close()
            self._sessions.clear()

    @property
    def memory_budget_bytes(self) -> int:
        return self._budget

    @property
    def reserved_bytes(self) -> int:
        """Current sum of admitted-but-unfinished reservations."""
        with self._lock:
            return self.stats.reserved_bytes

    @property
    def jobs(self) -> list[Job]:
        with self._lock:
            return list(self._jobs)

    @property
    def n_pending(self) -> int:
        """Jobs admitted or queued but not yet finished."""
        with self._lock:
            return len(self._ready) + len(self._wait)

    @property
    def n_sessions(self) -> int:
        with self._lock:
            return len(self._sessions)

    # -- session pool ----------------------------------------------------------
    def _session_for(self, circuit, params) -> tuple[str, _Session, bool]:
        fp = circuit_fingerprint(circuit)
        sess = self._sessions.get(fp)
        if sess is not None:
            self._sessions.move_to_end(fp)
            sess.last_used = self._clock()
            return fp, sess, False
        sim = Simulator(circuit, self._config)
        try:
            plan = sim.compile(params=params)
        except Exception:
            sim.close()
            raise
        sess = _Session(sim, plan, peak_ram_for(plan, 1), self._clock())
        self._sessions[fp] = sess
        self._evict_idle()
        return fp, sess, True

    def _evict_idle(self) -> None:
        # LRU-evict *idle* sessions only — a session with pending jobs
        # holds compiled state its jobs were admitted against.  The MRU
        # entry is always spared: it is the session just created or just
        # used, and evicting it would orphan the submit/round in flight.
        mru = next(reversed(self._sessions), None)
        idle = [fp for fp, s in self._sessions.items()
                if s.n_pending == 0 and fp != mru]
        for fp in idle:
            if len(self._sessions) <= self._max_sessions:
                break
            self._sessions.pop(fp).sim.close()
            self.stats.n_sessions_evicted += 1

    # -- admission -------------------------------------------------------------
    def submit(self, circuit, params: dict | None = None, *,
               seed: int | None = None, shots: int | None = None,
               observable: Callable | None = None,
               readout: Callable | None = None) -> Job:
        """Admit, queue or reject one simulation request.

        The decision (see docs/SERVING.md for the full table) prices the
        job at its plan's predicted peak RAM for one lane:

        ========================================  =============
        condition                                 decision
        ========================================  =============
        ``peak_ram(1) > budget``                  **rejected** — can
                                                  never fit
        ``reserved + peak_ram(1) <= budget``      **admitted** — reserved
                                                  now, runs next round
        otherwise                                 **queued** — admitted
                                                  in arrival order as
                                                  budget frees
        ========================================  =============

        ``shots``/``observable``/``readout`` choose what lands in
        ``job.result`` (``"counts"``, ``"expectation"``, ``"readout"``)
        — captured eagerly at completion, so the job outlives the
        session's next batch.  ``seed`` seeds a stochastic circuit's
        trajectory lane (default 0).
        """
        with self._lock:
            if self._closed:
                raise RuntimeError("SimService is closed")
            fp, sess, cold = self._session_for(circuit, params)
            if cold:
                self.stats.n_cold_compiles += 1
            else:
                self.stats.n_warm_hits += 1
            job = Job(job_id=self._next_id, structure=fp,
                      peak_ram_bytes=sess.peak1, params=params, seed=seed,
                      shots=shots, observable=observable, readout=readout,
                      cold=cold)
            self._next_id += 1
            job.submitted_at = self._clock()
            self._jobs.append(job)
            self.stats.n_submitted += 1
            if job.peak_ram_bytes > self._budget:
                job.state = "rejected"
                job.finished_at = job.submitted_at
                self.stats.n_rejected += 1
                return job
            sess.n_pending += 1
            if self._try_reserve(job):
                self.stats.n_admitted += 1
            else:
                job.state = "queued"
                self._wait.append(job)
                self.stats.n_queued += 1
            return job

    def _try_reserve(self, job: Job) -> bool:
        """Reserve budget for ``job`` and move it to the ready list;
        False (untouched) when the reservation would overflow."""
        if self.stats.reserved_bytes + job.peak_ram_bytes > self._budget:
            return False
        self.stats.reserved_bytes += job.peak_ram_bytes
        self.stats.peak_reserved_bytes = max(self.stats.peak_reserved_bytes,
                                             self.stats.reserved_bytes)
        job.state = "admitted"
        job.admitted_at = self._clock()
        self._ready.append(job)
        return True

    def _promote(self) -> None:
        """Drain the wait queue into freed budget, arrival order.  A job
        that still doesn't fit is skipped, not head-of-line blocking —
        same-structure jobs price identically, so order *within a
        structure class* is always preserved."""
        for job in list(self._wait):
            if self._try_reserve(job):
                self._wait.remove(job)

    # -- scheduling ------------------------------------------------------------
    def _merge_cap(self, sess: _Session, want: int) -> int:
        """Lane cap for one merged batch: `max_feasible_lanes` under the
        global budget.  Reservations already guarantee feasibility (the
        working-set model is linear in lanes), so this is a defensive
        floor, not the usual binding constraint."""
        plan = sess.plan
        max_m = max((st.layout.m for st in plan.stages), default=0)
        bpa = estimate_bytes_per_amp(plan.b_r, plan.compression)
        return max_feasible_lanes(plan.n_qubits, plan.local_bits, max_m,
                                  plan.pipeline_depth, bpa, self._budget,
                                  want)

    def step(self) -> list[Job]:
        """Run one scheduling round; returns the jobs finished in it.

        The round takes the *oldest* admitted job, merges every other
        admitted job of the same structure class (arrival order) into
        one ``run_batch`` lane stack up to the feasible-lane cap,
        executes it on the pooled session, captures each lane's
        requested readout eagerly, releases the reservations and
        promotes waiting jobs into the freed budget.  Returns ``[]``
        when nothing is admitted (idle, or everything queued is still
        over budget — impossible unless jobs are also running
        elsewhere).
        """
        with self._lock:
            if self._closed:
                raise RuntimeError("SimService is closed")
            self._promote()
            if not self._ready:
                return []
            head = self._ready[0]
            sess = self._sessions[head.structure]
            same = [j for j in self._ready if j.structure == head.structure]
            batch = same[:self._merge_cap(sess, len(same))]
            for job in batch:
                self._ready.remove(job)
            self._run_batch(sess, batch)
            for job in batch:
                self.stats.reserved_bytes -= job.peak_ram_bytes
                sess.n_pending -= 1
            sess.last_used = self._clock()
            self._sessions.move_to_end(head.structure)   # keep LRU order
            self._promote()
            self._evict_idle()
            return batch

    def drain(self) -> list[Job]:
        """Run scheduling rounds until no job is admitted or queued;
        returns every job finished during the drain, completion order."""
        finished: list[Job] = []
        while True:
            done = self.step()
            if not done:
                break
            finished.extend(done)
        return finished

    # -- execution -------------------------------------------------------------
    def _run_batch(self, sess: _Session, batch: list[Job]) -> None:
        now = self._clock()
        for job in batch:
            job.state = "running"
            job.started_at = now
        stochastic = sess.sim.circuit.is_stochastic
        seeds = [(job.seed if job.seed is not None else 0) if stochastic
                 else None for job in batch]
        self.stats.n_batches += 1
        self.stats.merge_widths.append(len(batch))
        self.stats.max_merge_width = max(self.stats.max_merge_width,
                                         len(batch))
        if len(batch) > 1:
            self.stats.n_merged_jobs += len(batch)
        try:
            # every dispatch goes through run_batch — width 1 included —
            # so a lane's float path is identical whether it ran solo or
            # merged (the batched executor and its kernels compute each
            # row alike whatever the row count), keeping merge results
            # bitwise-equal to solo runs
            result = sess.sim.run_batch([j.params for j in batch],
                                        seeds=seeds)
        except _JOB_FAILURES as e:
            now = self._clock()
            for job in batch:
                job.state = "failed"
                job.error = f"{type(e).__name__}: {e}"
                job.finished_at = now
                self.stats.n_failed += 1
            return
        for lane, job in enumerate(batch):
            view = result[lane]
            if job.shots:
                job.result["counts"] = view.sample(job.shots,
                                                   seed=job.seed or 0)
            if job.observable is not None:
                job.result["expectation"] = view.expectation(job.observable)
            if job.readout is not None:
                job.result["readout"] = job.readout(view)
            job.merge_width = len(batch)
            job.state = "done"
            job.finished_at = self._clock()
            self.stats.n_completed += 1
