"""Typed failure contract of the resilience layer.

Every layer that touches bytes raises (or converts into) one of these
instead of leaking a raw ``OSError``/``ValueError`` out of a worker
thread with no context:

* :class:`StoreIOError` — a spill-file / checkpoint read or write failed
  after the store's bounded retries; names the operation, key/blob and
  path.  Subclasses ``OSError`` so callers already catching I/O errors
  keep working.
* :class:`BlockCorruptionError` — a stored blob's content checksum did
  not match on read (flipped bits on the spill tier or inside a
  snapshot).  The Simulator converts this into an automatic
  replay-from-last-checkpoint when one exists.
* :class:`CheckpointError` — a snapshot file is structurally bad
  (truncated/torn/bad magic).  Subclasses ``ValueError`` for backward
  compatibility with callers that treated "not a checkpoint" as one.
* :class:`ResumableError` — the run died mid-flight but a consistent
  checkpoint exists; carries ``resume_path`` + ``stages_done`` so the
  caller can ``Simulator.resume(resume_path, circuit=...)``.
* :class:`MemoryPressureError` — the pressure ladder's final rung: the
  run was aborted at a stage boundary because memory blew past every
  degradation step; a :class:`ResumableError` (an emergency checkpoint
  is flushed first when possible).

This module is deliberately stdlib-only and import-cycle-free: both the
``compression`` and ``core`` packages raise these.
"""
from __future__ import annotations

__all__ = [
    "StoreIOError",
    "BlockCorruptionError",
    "CheckpointError",
    "ResumableError",
    "MemoryPressureError",
    "PlanVerificationError",
]


class StoreIOError(OSError):
    """A spill/checkpoint I/O operation failed after bounded retries.

    Attributes:
        op: what was being done ("spill write", "spill read", "snapshot",
            "pipeline fetch", ...).
        key: the store key involved, when known.
        blob_id: the internal blob id involved, when known.
        path: the file path involved, when known.
        retries: how many retries were exhausted before giving up.
    """

    def __init__(self, op: str, *, key=None, blob_id=None, path=None,
                 retries: int = 0, detail: str = ""):
        self.op = op
        self.key = key
        self.blob_id = blob_id
        self.path = path
        self.retries = retries
        parts = [f"{op} failed"]
        if key is not None:
            parts.append(f"key={key}")
        if blob_id is not None:
            parts.append(f"blob={blob_id}")
        if path is not None:
            parts.append(f"path={path}")
        if retries:
            parts.append(f"after {retries} retries")
        if detail:
            parts.append(detail)
        super().__init__(" ".join(parts))


class BlockCorruptionError(RuntimeError):
    """A blob's stored bytes failed their content-checksum verification.

    Raised on every disk-tier read and on snapshot restore — corrupted
    data is *detected*, never silently decoded.  Attributes name the
    blob so the failure is attributable: ``key``, ``blob_id``, ``path``,
    ``expected_crc``, ``actual_crc``.
    """

    def __init__(self, where: str, *, key=None, blob_id=None, path=None,
                 expected_crc=None, actual_crc=None):
        self.where = where
        self.key = key
        self.blob_id = blob_id
        self.path = path
        self.expected_crc = expected_crc
        self.actual_crc = actual_crc
        parts = [f"block checksum mismatch at {where}"]
        if key is not None:
            parts.append(f"key={key}")
        if blob_id is not None:
            parts.append(f"blob={blob_id}")
        if path is not None:
            parts.append(f"path={path}")
        if expected_crc is not None:
            parts.append(f"expected=0x{expected_crc:08x} "
                         f"got=0x{actual_crc:08x}")
        super().__init__(" ".join(parts))


class CheckpointError(ValueError):
    """A checkpoint file is structurally invalid (truncated/torn/bad
    magic) — distinct from a *corrupted blob inside* a structurally
    sound snapshot, which is :class:`BlockCorruptionError`."""


class ResumableError(RuntimeError):
    """The run failed, but a consistent checkpoint can continue it.

    ``resume_path`` names a snapshot written at a stage boundary;
    ``Simulator.resume(resume_path, circuit=...)`` then ``run()``
    reproduces the uninterrupted result.  ``stages_done`` is the number
    of stages the checkpoint contains.  The original failure is chained
    as ``__cause__``.
    """

    def __init__(self, msg: str, *, resume_path: str | None = None,
                 stages_done: int | None = None):
        self.resume_path = resume_path
        self.stages_done = stages_done
        if resume_path is not None:
            msg = (f"{msg} — resume from {resume_path!r} "
                   f"(stages_done={stages_done})")
        super().__init__(msg)


class MemoryPressureError(ResumableError):
    """The pressure ladder's terminal rung: measured memory blew past the
    plan's prediction beyond what degradation could absorb (or the disk
    tier's own budget overflowed).  When checkpointing is active the
    Simulator flushes an emergency checkpoint at the failing stage
    boundary and re-raises this carrying its path."""


class PlanVerificationError(ValueError):
    """An :class:`~repro_torch.core.plan.ExecutionPlan` failed static
    verification (:func:`repro_torch.analysis.plan_check.check_plan`): its
    stage layouts, gate slices, schedules or byte predictions are not
    internally consistent, so executing it verbatim would corrupt state
    or blow the budget.  ``findings`` carries every
    ``PlanFinding`` (errors and warnings) from the failed pass.

    Subclasses ``ValueError`` so callers treating "bad plan artifact"
    generically (e.g. around ``ExecutionPlan.from_json``) keep working.
    """

    def __init__(self, msg: str, findings=()):
        self.findings = tuple(findings)
        super().__init__(msg)
