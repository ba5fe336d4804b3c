"""jit-purity: no host synchronization inside traced code.

Functions compiled by ``jax.jit`` (or lowered as Pallas kernels) trace
once and run on device; a ``np.asarray``/``jax.device_get``/
``.block_until_ready()``/dynamic ``float(...)`` inside one either
breaks tracing outright or — worse — silently forces a blocking
device->host sync in the middle of the stage pipeline, serializing the
exact overlap the pipeline exists to create.

The checker builds a project-wide call graph:

* roots: functions decorated ``@jax.jit`` / ``@partial(jax.jit, ...)``,
  functions passed to a ``jax.jit(f, ...)`` call, and kernel bodies
  passed to ``pallas_call``;
* edges: bare-name calls and ``self.method()`` calls resolved against
  every analyzed file's function definitions (conservative: all
  same-named defs are followed);
* inside any reachable function (nested helpers included), flag
  ``np.asarray``/``np.array``/``np.frombuffer``, ``jax.device_get``,
  ``.block_until_ready()``, and ``float()``/``int()``/``bool()`` on a
  non-static argument (constants, ALL_CAPS module constants and
  ``len(...)`` of traced-time-static containers are fine).

Intentional trace-time host math on static Python values is annotated
``# jit-ok: <reason>`` at the call line.
"""

from __future__ import annotations

import ast

from .base import Checker, SourceFile, Violation, register

_NP_FORBIDDEN = frozenset({"asarray", "array", "frombuffer"})
_CASTS = frozenset({"float", "int", "bool"})
_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


class _FileInfo:
    def __init__(self, src: SourceFile):
        self.src = src
        self.np_aliases: set[str] = set()
        self.jax_aliases: set[str] = set()
        self.defs: list[ast.AST] = []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "numpy":
                        self.np_aliases.add(a.asname or "numpy")
                    elif a.name == "jax":
                        self.jax_aliases.add(a.asname or "jax")
            elif isinstance(node, _FUNC_DEFS):
                self.defs.append(node)

    def is_jit(self, f: ast.AST) -> bool:
        if isinstance(f, ast.Name) and f.id == "jit":
            return True
        if not isinstance(f, ast.Attribute) or f.attr != "jit":
            return False
        if not isinstance(f.value, ast.Name):
            return False
        return f.value.id in (self.jax_aliases or {"jax"})


def _is_partial(f: ast.AST) -> bool:
    if isinstance(f, ast.Name):
        return f.id == "partial"
    return isinstance(f, ast.Attribute) and f.attr == "partial"


def _is_pallas(f: ast.AST) -> bool:
    if isinstance(f, ast.Name):
        return f.id == "pallas_call"
    return isinstance(f, ast.Attribute) and f.attr == "pallas_call"


def _static_arg(arg: ast.AST) -> bool:
    """Trace-time-static expressions a float()/int() cast may consume."""
    if isinstance(arg, ast.Constant):
        return True
    if isinstance(arg, ast.UnaryOp):
        return _static_arg(arg.operand)
    if isinstance(arg, ast.BinOp):
        return _static_arg(arg.left) and _static_arg(arg.right)
    if isinstance(arg, ast.Name) and arg.id.isupper():
        return True  # module-level constant
    if isinstance(arg, ast.Attribute) and arg.attr.isupper():
        return True
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name):
        if arg.func.id == "len":
            return True  # shapes are static under trace
    return False


def _jit_decorated(info: _FileInfo, fn: ast.AST) -> bool:
    for dec in fn.decorator_list:
        if info.is_jit(dec):
            return True
        if not isinstance(dec, ast.Call):
            continue
        if info.is_jit(dec.func):
            return True
        if _is_partial(dec.func) and dec.args and info.is_jit(dec.args[0]):
            return True
    return False


def _called_def_name(node: ast.Call) -> str | None:
    """Call edge name: bare ``helper()`` or ``self.method()`` only —
    matching arbitrary attribute names would conflate ``list.append`` /
    ``int.to_bytes`` with same-named project functions."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name) and f.value.id == "self":
            return f.attr
    return None


@register
class JitPurity(Checker):
    name = "jit-purity"
    description = "no host syncs reachable from jit/Pallas-traced code"

    def check_project(self, files: list[SourceFile]) -> list[Violation]:
        infos = [_FileInfo(src) for src in files]
        table: dict[str, list[tuple[_FileInfo, ast.AST]]] = {}
        for info in infos:
            for fn in info.defs:
                table.setdefault(fn.name, []).append((info, fn))

        roots: list[tuple[_FileInfo, ast.AST]] = []
        for info in infos:
            local: dict[str, list[tuple[_FileInfo, ast.AST]]] = {}
            for fn in info.defs:
                local.setdefault(fn.name, []).append((info, fn))
            for fn in info.defs:
                if _jit_decorated(info, fn):
                    roots.append((info, fn))
            for node in ast.walk(info.src.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                if info.is_jit(node.func) or _is_pallas(node.func):
                    arg0 = node.args[0]
                    if isinstance(arg0, ast.Name):
                        hits = local.get(arg0.id) or table.get(arg0.id, [])
                        roots.extend(hits)

        # BFS over called names, conservatively following every
        # same-named definition in the analyzed set
        reachable: dict[int, tuple[_FileInfo, ast.AST]] = {}
        stack = list(roots)
        while stack:
            info, fn = stack.pop()
            if id(fn) in reachable:
                continue
            reachable[id(fn)] = (info, fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = _called_def_name(node)
                if name and name in table:
                    stack.extend(table[name])

        out: list[Violation] = []
        seen: set[tuple[str, int, str]] = set()

        def flag(src, lineno, msg):
            key = (src.path, lineno, msg)
            if key in seen:
                return
            seen.add(key)
            if src.jit_ok(lineno) or src.disabled(lineno, self.name):
                return
            out.append(Violation(self.name, src.path, lineno, msg))

        for info, fn in reachable.values():
            self._scan_fn(info, fn, flag)
        out.sort(key=lambda v: (v.path, v.line))
        return out

    def _scan_fn(self, info, fn, flag):
        src = info.src
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute):
                if f.attr == "block_until_ready":
                    msg = (
                        f".block_until_ready() inside jit-reachable "
                        f"{fn.name}() — host sync in traced code"
                    )
                    flag(src, node.lineno, msg)
                elif isinstance(f.value, ast.Name):
                    is_np = f.value.id in info.np_aliases
                    if is_np and f.attr in _NP_FORBIDDEN:
                        msg = (
                            f"{f.value.id}.{f.attr}() inside jit-reachable "
                            f"{fn.name}() — forces device->host transfer "
                            f"under trace"
                        )
                        flag(src, node.lineno, msg)
                    elif f.value.id in info.jax_aliases and f.attr == "device_get":
                        msg = f"jax.device_get() inside jit-reachable {fn.name}()"
                        flag(src, node.lineno, msg)
            elif isinstance(f, ast.Name) and f.id in _CASTS:
                if node.args and not _static_arg(node.args[0]):
                    msg = (
                        f"{f.id}() on a non-static value inside jit-reachable "
                        f"{fn.name}() — concretizes a tracer (add "
                        f"'# jit-ok: <reason>' if the value is static at "
                        f"trace time)"
                    )
                    flag(src, node.lineno, msg)
