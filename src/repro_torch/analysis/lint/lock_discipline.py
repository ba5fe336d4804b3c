"""lock-discipline: a static race detector for annotated shared state.

The threaded wave scheduler (core/pipeline.py) and the two-level store
(compression/store.py) share mutable counters and dicts across worker
threads.  The convention: declare the guard on the field's ``__init__``
assignment —

    self.t_load = 0.0          # guarded-by: _t_lock

— and from then on every ``self.t_load`` access (read or write) must
sit lexically inside ``with self._t_lock:`` in the same class, or in a
method annotated ``# holds-lock: _t_lock`` (callers own the lock).

Scope and limits (by design, to stay zero-false-positive):

* tracking is per-class and lexical — a closure defined inside the
  ``with`` block counts as inside it;
* only ``self.<field>`` accesses are checked; cross-object accesses
  (``store.stats`` from the pressure monitor) are a documented blind
  spot — annotate those call sites by hand if they become load-bearing;
* the declaration line itself is exempt.
"""

from __future__ import annotations

import ast

from .base import Checker, SourceFile, Violation, register

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)
_ASSIGNS = (ast.Assign, ast.AnnAssign, ast.AugAssign)


def _is_self_attr(node: ast.AST) -> bool:
    if not isinstance(node, ast.Attribute):
        return False
    return isinstance(node.value, ast.Name) and node.value.id == "self"


def _with_locks(node: ast.With) -> set[str]:
    """Lock attribute names acquired by ``with self.<lock>[, ...]:``."""
    out = set()
    for item in node.items:
        ctx = item.context_expr
        if _is_self_attr(ctx):
            out.add(ctx.attr)
    return out


@register
class LockDiscipline(Checker):
    name = "lock-discipline"
    description = "'# guarded-by:' fields only touched under their lock"

    def check(self, src: SourceFile) -> list[Violation]:
        out: list[Violation] = []
        classes = [n for n in ast.walk(src.tree) if isinstance(n, ast.ClassDef)]
        for cls in classes:
            guarded: dict[str, str] = {}
            decl_lines: set[int] = set()
            for node in ast.walk(cls):
                if not isinstance(node, _ASSIGNS):
                    continue
                lock = src.guarded_by(node.lineno)
                if lock is None:
                    continue
                if isinstance(node, ast.Assign):
                    targets = node.targets
                else:
                    targets = [node.target]
                for tgt in targets:
                    if _is_self_attr(tgt):
                        guarded[tgt.attr] = lock
                        decl_lines.add(node.lineno)
            if not guarded:
                continue
            for func in cls.body:
                if isinstance(func, _FUNC_DEFS):
                    self._check_func(src, func, guarded, decl_lines, out)
        return out

    def _check_func(self, src, func, guarded, decl_lines, out):
        held0 = frozenset(src.holds_locks(func))

        def flag(node, lock):
            if node.lineno in decl_lines:
                return
            if src.disabled(node.lineno, self.name):
                return
            msg = (
                f"self.{node.attr} accessed outside 'with self.{lock}:' "
                f"in {func.name}() (declared # guarded-by: {lock})"
            )
            out.append(Violation(self.name, src.path, node.lineno, msg))

        def visit(node, held):
            if isinstance(node, ast.With):
                held = held | _with_locks(node)
            elif isinstance(node, _FUNC_DEFS) and node is not func:
                # nested scope: lexical nesting keeps `held`, plus the
                # closure's own holds-lock annotation
                held = held | src.holds_locks(node)
            elif _is_self_attr(node) and node.attr in guarded:
                lock = guarded[node.attr]
                if lock not in held:
                    flag(node, lock)
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        visit(func, held0)
