"""Checker registry, pragma conventions and the file walker.

A checker is a small class over one parsed :class:`SourceFile` (or, for
whole-program analyses, over all of them at once via
:meth:`Checker.check_project`).  Checkers register themselves with
:func:`register`; ``python -m repro_torch.analysis`` discovers them there.

Suppression is *annotation-with-justification*, never blanket excludes:

``# lint: disable=<checker>[,<checker>] -- <reason>``
    Silence the named checkers on this line.  The ``-- <reason>`` is
    mandatory — a pragma without one does not suppress anything, so
    every allowlisted violation carries its justification in-tree.

``# guarded-by: <lock>``
    On a ``self.field = ...`` declaration: the field may only be
    accessed inside ``with self.<lock>:`` (the *lock-discipline*
    checker).

``# holds-lock: <lock>``
    On a ``def`` line (or the line above): the whole function body runs
    with ``<lock>`` held by its callers.

``# jit-ok: <reason>``
    On a line inside a jit-reachable function: the flagged host-sync
    call is intentional and safe (e.g. operates on a static Python
    value at trace time).

``# fault-covered: <point>``
    On a ``def`` line (or the line above): the function's I/O flows
    through the named registered injection point elsewhere on the same
    data path.  ``<point>`` must be a member of
    :data:`repro_torch.faults.INJECTION_POINTS` — a typo is itself a
    violation, so the annotation can't rot.

Files matching an entry in ``analysis/quarantine.txt`` are skipped
entirely (dead seed scaffolding; see ARCHITECTURE.md).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass

__all__ = [
    "Violation",
    "SourceFile",
    "Checker",
    "register",
    "all_checkers",
    "load_quarantine",
    "is_quarantined",
    "iter_source_files",
    "run_checkers",
    "DEFAULT_QUARANTINE",
]

_PRAGMA_RE = re.compile(r"#\s*lint:\s*disable=([\w,\s-]+?)\s*--\s*\S")
_PRAGMA_NO_REASON_RE = re.compile(r"#\s*lint:\s*disable=([\w,\s-]+)\s*$")
_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*(\w+)")
_HOLDS_LOCK_RE = re.compile(r"#\s*holds-lock:\s*(\w+)")
_JIT_OK_RE = re.compile(r"#\s*jit-ok:\s*\S")
_FAULT_COVERED_RE = re.compile(r"#\s*fault-covered:\s*([\w.]+)")

#: quarantine list shipped next to the analysis package
DEFAULT_QUARANTINE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "quarantine.txt",
)


@dataclass(frozen=True)
class Violation:
    """One finding: which checker, where, what."""

    checker: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}"


class SourceFile:
    """One parsed source file plus its per-line annotations."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)  # may raise SyntaxError
        self._disabled: dict[int, frozenset[str]] = {}
        self._bare_pragmas: list[int] = []
        for i, ln in enumerate(self.lines, 1):
            m = _PRAGMA_RE.search(ln)
            if m:
                names = (s.strip() for s in m.group(1).split(","))
                self._disabled[i] = frozenset(s for s in names if s)
            elif _PRAGMA_NO_REASON_RE.search(ln):
                # a pragma with no `-- reason` suppresses nothing
                self._bare_pragmas.append(i)

    @classmethod
    def load(cls, path: str) -> "SourceFile":
        # lint tooling reading source text, not simulator state I/O
        fh = open(path, encoding="utf-8")  # lint: disable=fault-coverage -- tool IO
        with fh:
            return cls(path, fh.read())

    # -- annotation lookups --------------------------------------------------
    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def disabled(self, lineno: int, checker: str) -> bool:
        names = self._disabled.get(lineno, ())
        return checker in names or "all" in names

    def reasonless_pragmas(self) -> list[int]:
        """Lines carrying a ``lint: disable`` with no ``-- reason``."""
        return list(self._bare_pragmas)

    def guarded_by(self, lineno: int) -> str | None:
        m = _GUARDED_BY_RE.search(self.line(lineno))
        return m.group(1) if m else None

    def jit_ok(self, lineno: int) -> bool:
        return bool(_JIT_OK_RE.search(self.line(lineno)))

    def _def_annotation(self, node: ast.AST, regex: re.Pattern) -> list[str]:
        """Matches of ``regex`` on the def line or the line above it."""
        out = []
        for lineno in (node.lineno, node.lineno - 1):
            m = regex.search(self.line(lineno))
            if m:
                out.append(m.group(1))
        return out

    def holds_locks(self, func: ast.AST) -> set[str]:
        return set(self._def_annotation(func, _HOLDS_LOCK_RE))

    def fault_covered(self, func: ast.AST) -> list[str]:
        return self._def_annotation(func, _FAULT_COVERED_RE)


class Checker:
    """Base class.  Subclasses set ``name``/``description`` and override
    :meth:`check` (per-file) or :meth:`check_project` (whole-program)."""

    name: str = ""
    description: str = ""

    def check(self, src: SourceFile) -> list[Violation]:
        return []

    def check_project(self, files: list[SourceFile]) -> list[Violation]:
        out: list[Violation] = []
        for src in files:
            out.extend(self.check(src))
        return out


_REGISTRY: dict[str, type[Checker]] = {}


def register(cls: type[Checker]) -> type[Checker]:
    if not cls.name:
        raise ValueError(f"checker {cls.__name__} has no name")
    if cls.name in _REGISTRY:
        raise ValueError(f"duplicate checker name {cls.name!r}")
    _REGISTRY[cls.name] = cls
    return cls


def all_checkers() -> dict[str, type[Checker]]:
    return dict(_REGISTRY)


# -- quarantine + walking ----------------------------------------------------
def load_quarantine(path: str | None = None) -> list[tuple[str, str]]:
    """Parse the quarantine file into ``(path_fragment, reason)`` pairs."""
    path = path or DEFAULT_QUARANTINE
    if not os.path.exists(path):
        return []
    out = []
    fh = open(path, encoding="utf-8")  # lint: disable=fault-coverage -- tool IO
    with fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            frag, _, reason = line.partition("#")
            frag = frag.strip().rstrip("/")
            if frag:
                out.append((frag, reason.strip()))
    return out


def is_quarantined(path: str, quarantine: list[tuple[str, str]]) -> bool:
    norm = "/" + os.path.abspath(path).replace(os.sep, "/").lstrip("/")
    for frag, _reason in quarantine:
        if f"/{frag}/" in norm or norm.endswith(f"/{frag}"):
            return True
    return False


def iter_source_files(paths, quarantine):
    """Yield ``(path, SourceFile | SyntaxError | None)`` for every .py
    under ``paths`` — ``None`` marks a quarantined (skipped) file."""
    seen = set()
    for root in paths:
        if os.path.isfile(root):
            candidates = [root]
        else:
            candidates = []
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = sorted(
                    d for d in dirnames if d not in ("__pycache__", ".git")
                )
                candidates.extend(
                    os.path.join(dirpath, f)
                    for f in sorted(filenames)
                    if f.endswith(".py")
                )
        for path in candidates:
            key = os.path.abspath(path)
            if key in seen:
                continue
            seen.add(key)
            if is_quarantined(path, quarantine):
                yield path, None
                continue
            try:
                yield path, SourceFile.load(path)
            except SyntaxError as exc:
                yield path, exc


def run_checkers(paths, select=None, quarantine_path=None, use_quarantine=True):
    """Run (selected) checkers over every live source under ``paths``.

    Returns ``(violations, n_checked, skipped)`` — ``skipped`` is the
    list of quarantined paths, so callers can surface what the gate did
    NOT look at.
    """
    from . import fault_coverage, jit_purity, lock_discipline  # noqa: F401
    from . import typed_errors  # noqa: F401  (register on import)

    registry = all_checkers()
    names = list(registry) if select is None else list(select)
    unknown = [nm for nm in names if nm not in registry]
    if unknown:
        raise ValueError(
            f"unknown checker(s) {unknown}; available: {sorted(registry)}"
        )

    quarantine = load_quarantine(quarantine_path) if use_quarantine else []
    files: list[SourceFile] = []
    skipped: list[str] = []
    violations: list[Violation] = []
    for path, src in iter_source_files(paths, quarantine):
        if src is None:
            skipped.append(path)
        elif isinstance(src, SyntaxError):
            v = Violation("parse", path, src.lineno or 0, f"syntax error: {src.msg}")
            violations.append(v)
        else:
            files.append(src)
            for lineno in src.reasonless_pragmas():
                msg = (
                    "lint: disable pragma without a '-- reason' justification "
                    "(it suppresses nothing)"
                )
                violations.append(Violation("pragma", path, lineno, msg))

    for nm in names:
        violations.extend(registry[nm]().check_project(files))
    violations.sort(key=lambda v: (v.path, v.line, v.checker))
    return violations, len(files), skipped
