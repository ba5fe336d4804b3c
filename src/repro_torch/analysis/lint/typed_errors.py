"""typed-errors: the failure contract stays typed.

repro_torch.errors defines the complete failure vocabulary of the public
paths (StoreIOError, BlockCorruptionError, CheckpointError,
ResumableError, MemoryPressureError, PlanVerificationError).  Raw
``Exception`` raising or broad swallowing erases the context the
resilience layer depends on (what failed, whether it is resumable).

Rules:

* ``raise Exception(...)`` / ``raise BaseException(...)`` — always a
  violation: raise a :mod:`repro_torch.errors` type (or a stdlib type that
  one of them subclasses).
* bare ``except:`` — always a violation.
* ``except Exception`` / ``except BaseException`` (alone or in a
  tuple) — a violation *unless* the handler re-raises: a handler whose
  last statement is a bare ``raise`` is cleanup code, not swallowing,
  and is allowed as-is.  Anything else needs
  ``# lint: disable=typed-errors -- <reason>`` on the ``except`` line —
  the explicit allowlist-with-justification.
"""

from __future__ import annotations

import ast

from .base import Checker, SourceFile, Violation, register

_BROAD = ("Exception", "BaseException")


def _names(expr: ast.AST):
    """Exception names in an except clause (handles tuples)."""
    if expr is None:
        return
    nodes = expr.elts if isinstance(expr, ast.Tuple) else [expr]
    for node in nodes:
        if isinstance(node, ast.Name):
            yield node.id
        elif isinstance(node, ast.Attribute):
            yield node.attr


def _reraises(handler: ast.ExceptHandler) -> bool:
    """Handler body ends in a bare ``raise`` (cleanup/re-raise idiom)."""
    body = handler.body
    if not body or not isinstance(body[-1], ast.Raise):
        return False
    return body[-1].exc is None


def _raised_name(node: ast.Raise) -> str | None:
    exc = node.exc
    if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
        return exc.func.id
    if isinstance(exc, ast.Name):
        return exc.id
    return None


@register
class TypedErrors(Checker):
    name = "typed-errors"
    description = "raise typed errors; no unjustified broad excepts"

    def check(self, src: SourceFile) -> list[Violation]:
        out: list[Violation] = []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Raise):
                name = _raised_name(node)
                if name in _BROAD and not src.disabled(node.lineno, self.name):
                    msg = (f"raise {name} — use a typed error from "
                           "repro_torch.errors")
                    out.append(Violation(self.name, src.path, node.lineno, msg))
            elif isinstance(node, ast.ExceptHandler):
                if src.disabled(node.lineno, self.name):
                    continue
                if node.type is None:
                    msg = (
                        "bare 'except:' swallows everything including "
                        "KeyboardInterrupt — name the exception types"
                    )
                    out.append(Violation(self.name, src.path, node.lineno, msg))
                    continue
                broad = [nm for nm in _names(node.type) if nm in _BROAD]
                if broad and not _reraises(node):
                    msg = (
                        f"'except {broad[0]}' without re-raise — narrow to "
                        f"the repro_torch.errors types the block can actually "
                        f"produce, or justify with "
                        f"'# lint: disable=typed-errors -- <reason>'"
                    )
                    out.append(Violation(self.name, src.path, node.lineno, msg))
        return out
