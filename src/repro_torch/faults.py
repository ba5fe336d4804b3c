"""Deterministic, seed-driven fault injection for the resilience layer.

Every I/O-and-bytes-touching seam in the engine is a *named injection
point* that calls :func:`fault_point` — a no-op (one global read) unless
an injector is installed.  Tests and ``qsim --inject`` install one to
deterministically provoke the failure paths the resilience layer exists
to handle:

    with inject_faults(["store.spill_read:ioerror:times=2"]):
        sim.run()          # first two spill reads fail, are retried

Registered points (see ARCHITECTURE.md "Resilience layer"):

===================== =====================================================
``store.spill_write`` every spill-tier file write (payload: blob bytes)
``store.spill_read``  every spill-tier file read (payload: bytes read)
``codec.encode``      every host/device block-encode dispatch
``codec.decode``      every host/device block-decode dispatch
``pipeline.fetch``    every pipeline fetch-worker step (one wave/group)
``pipeline.store``    every pipeline store-worker step (one wave/group)
``pipeline.exchange`` every cross-device block hand-off (one block moving
                      owners between stages of a block-sharded run)
``checkpoint.write``  every store snapshot (once per checkpoint)
``checkpoint.read``   every snapshot parse (restore / resume / replay)
===================== =====================================================

Fault *kinds*:

* ``ioerror`` — raise ``OSError(EIO)`` at the point (exercises the
  retry/typed-error paths).
* ``corrupt`` — flip one byte of the payload (only meaningful at the
  byte-carrying spill points; exercises checksum detection).
* ``crash`` — raise :class:`InjectedCrash`, simulating hard process
  death at that point (exercises checkpoint/resume).

A spec fires at deterministic 1-based *hit* numbers (``hit=3`` or
``hit=2,5``), with a seeded probability (``p=0.1`` — the chaos sweep),
or on every hit; ``times=K`` caps the total number of firings.  All
bookkeeping is under one lock, so firing decisions are reproducible for
a fixed seed and call order.

This module is stdlib-only (no ``repro_torch`` imports) so the compression
layer can use it without import cycles; :mod:`repro_torch.core.faults` is the
canonical public import surface.
"""
from __future__ import annotations

import contextlib
import errno
import random
import threading
from dataclasses import dataclass

__all__ = [
    "INJECTION_POINTS",
    "InjectedCrash",
    "FaultSpec",
    "FaultInjector",
    "fault_point",
    "install_faults",
    "clear_faults",
    "active_injector",
    "inject_faults",
]

INJECTION_POINTS = frozenset({
    "store.spill_write",
    "store.spill_read",
    "codec.encode",
    "codec.decode",
    "pipeline.fetch",
    "pipeline.store",
    "pipeline.exchange",
    "checkpoint.write",
    "checkpoint.read",
})

#: points whose payload is raw bytes — the only ones ``corrupt`` touches
_CORRUPTIBLE = frozenset({"store.spill_write", "store.spill_read"})

_KINDS = ("ioerror", "corrupt", "crash")


class InjectedCrash(RuntimeError):
    """Simulated hard crash (process death) at an injection point.

    Deliberately NOT an ``OSError``: nothing in the stack retries or
    converts it — it unwinds like a kill signal would, leaving whatever
    checkpoint files are already on disk."""


@dataclass(frozen=True)
class FaultSpec:
    """One fault to inject: where, what, and when.

    Attributes:
        point: injection-point name (member of :data:`INJECTION_POINTS`).
        kind: ``ioerror`` | ``corrupt`` | ``crash``.
        hits: fire at these 1-based hit numbers of the point (None =
            every hit, subject to ``p``/``times``).
        p: fire each hit with this probability (seeded rng) when no
            explicit ``hits`` are given; 0 means "always".
        times: stop firing after this many firings (None = unlimited).
    """

    point: str
    kind: str
    hits: tuple[int, ...] | None = None
    p: float = 0.0
    times: int | None = None

    def __post_init__(self):
        if self.point not in INJECTION_POINTS:
            raise ValueError(
                f"unknown injection point {self.point!r}; expected one of "
                f"{sorted(INJECTION_POINTS)}")
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{_KINDS}")
        if self.kind == "corrupt" and self.point not in _CORRUPTIBLE:
            raise ValueError(
                f"kind 'corrupt' only applies to byte-carrying points "
                f"{sorted(_CORRUPTIBLE)}, not {self.point!r}")

    @classmethod
    def parse(cls, spec: str) -> "FaultSpec":
        """Parse the CLI form ``point:kind[:hit=N[,M]][:p=F][:times=K]``.

        Examples: ``store.spill_read:ioerror:times=2``,
        ``pipeline.fetch:crash:hit=5``, ``store.spill_write:corrupt:p=0.05``.
        """
        parts = spec.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"bad fault spec {spec!r}: expected "
                "'point:kind[:hit=N][:p=F][:times=K]'")
        point, kind = parts[0], parts[1]
        kwargs: dict = {}
        for opt in parts[2:]:
            if "=" not in opt:
                raise ValueError(f"bad fault option {opt!r} in {spec!r}")
            k, v = opt.split("=", 1)
            if k == "hit":
                kwargs["hits"] = tuple(int(x) for x in v.split(","))
            elif k == "p":
                kwargs["p"] = float(v)
            elif k == "times":
                kwargs["times"] = int(v)
            else:
                raise ValueError(f"unknown fault option {k!r} in {spec!r}")
        return cls(point, kind, **kwargs)


class FaultInjector:
    """Evaluates :class:`FaultSpec` firings at every :func:`fault_point`.

    All state (per-point hit counters, per-spec fire counters, the
    seeded rng) mutates under one lock, so a fixed ``seed`` + call order
    reproduces the same firing pattern."""

    def __init__(self, specs, seed: int = 0):
        self.specs = [FaultSpec.parse(s) if isinstance(s, str) else s
                      for s in specs]
        self.seed = seed
        self._rng = random.Random(seed)
        self._hits: dict[str, int] = {}
        self._fired: list[int] = [0] * len(self.specs)
        self._lock = threading.Lock()

    @property
    def fired(self) -> dict[str, int]:
        """Total firings so far, keyed ``point:kind``."""
        out: dict[str, int] = {}
        with self._lock:
            for spec, n in zip(self.specs, self._fired):
                key = f"{spec.point}:{spec.kind}"
                out[key] = out.get(key, 0) + n
        return out

    def fire(self, point: str, payload=None):
        """Evaluate all specs at ``point``; returns the (possibly
        corrupted) payload or raises the injected failure."""
        if point not in INJECTION_POINTS:
            raise ValueError(f"unknown injection point {point!r}; "
                             f"known: {sorted(INJECTION_POINTS)}")
        with self._lock:
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit
            todo = None
            for i, spec in enumerate(self.specs):
                if spec.point != point:
                    continue
                if spec.times is not None and self._fired[i] >= spec.times:
                    continue
                if spec.hits is not None:
                    if hit not in spec.hits:
                        continue
                elif spec.p and self._rng.random() >= spec.p:
                    continue
                self._fired[i] += 1
                todo = spec
                # corruption draws its flip position under the same lock
                # so the pattern is reproducible
                flip = (self._rng.randrange(len(payload))
                        if spec.kind == "corrupt" and payload else 0)
                break
        if todo is None:
            return payload
        if todo.kind == "ioerror":
            raise OSError(errno.EIO,
                          f"injected I/O fault at {point} (hit {hit})")
        if todo.kind == "crash":
            raise InjectedCrash(f"injected crash at {point} (hit {hit})")
        # corrupt: flip one byte of the payload
        if not payload:
            return payload
        buf = bytearray(payload)
        buf[flip] ^= 0xFF
        return bytes(buf)


_active: FaultInjector | None = None


def install_faults(injector: FaultInjector) -> None:
    """Install ``injector`` process-wide (``qsim --inject``)."""
    global _active
    _active = injector


def clear_faults() -> None:
    global _active
    _active = None


def active_injector() -> FaultInjector | None:
    return _active


@contextlib.contextmanager
def inject_faults(specs, seed: int = 0):
    """Scoped installation for tests::

        with inject_faults(["pipeline.fetch:crash:hit=3"]) as inj:
            ...
        inj.fired   # {"pipeline.fetch:crash": 1}
    """
    inj = FaultInjector(specs, seed=seed)
    prev = _active
    install_faults(inj)
    try:
        yield inj
    finally:
        install_faults(prev) if prev is not None else clear_faults()


def fault_point(point: str, payload=None):
    """The instrumentation hook: near-zero cost when no injector is
    installed; otherwise evaluates the active injector's specs at
    ``point`` and returns the (possibly corrupted) ``payload``."""
    inj = _active
    if inj is None:
        return payload
    return inj.fire(point, payload)
