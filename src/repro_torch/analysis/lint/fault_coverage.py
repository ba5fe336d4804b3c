"""fault-coverage: the injection surface must not silently shrink.

The resilience layer (repro_torch.faults) only exercises failure paths that
actually pass a registered ``fault_point``.  A new disk read, codec
call or checkpoint path added *without* one is invisible to the chaos
sweep and the crash/resume tests — the exact rot this checker stops.

Rule: any function whose body (excluding nested ``def``s, which are
checked as their own scopes) performs raw file I/O (``open``/``os.open``)
or calls a codec primitive must either

* call ``fault_point(...)`` in the same scope,
* carry ``# fault-covered: <registered point>`` on its ``def`` line
  (the data path is instrumented elsewhere — say where), or
* suppress the specific line with a justified pragma:
  ``# lint: disable=fault-coverage -- reason`` (the reason is mandatory).

The checker also validates every literal point name passed to
``fault_point`` / listed in ``# fault-covered:`` against
``repro_torch.faults.INJECTION_POINTS``, so typos surface statically instead
of as never-firing injections.
"""

from __future__ import annotations

import ast

from ...faults import INJECTION_POINTS
from .base import Checker, SourceFile, Violation, register

#: the compression layer's encode/decode/wire primitives — every call
#: site is a byte-touching seam that must be on the injection surface
CODEC_PRIMITIVES = frozenset(
    {
        "encode_block_host",
        "decode_block_host",
        "encode_group_planes",
        "decode_blocks_planes",
        "segments_to_wire",
        "wire_to_segments",
        "fetch_group_wire",
    }
)

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _call_name(node: ast.Call) -> str | None:
    """Bare or attribute call name: ``open(...)`` -> "open",
    ``os.open(...)`` -> "os.open", ``codec.encode_block_host`` ->
    "encode_block_host" (attribute calls match by terminal name)."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Name) and f.value.id == "os" and f.attr == "open":
            return "os.open"
        return f.attr
    return None


def _own_statements(func: ast.AST):
    """Walk a function body, stopping at nested function/class scopes."""
    stack = list(getattr(func, "body", []))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


@register
class FaultCoverage(Checker):
    name = "fault-coverage"
    description = "raw I/O and codec calls must pass a registered fault_point"

    def check(self, src: SourceFile) -> list[Violation]:
        out: list[Violation] = []
        funcs = [n for n in ast.walk(src.tree) if isinstance(n, _FUNC_DEFS)]
        for func in funcs:
            triggers: list[tuple[int, str]] = []
            covered = False
            for node in _own_statements(func):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node)
                if name == "fault_point":
                    covered = True
                    # validate a literal point name against the registry
                    if node.args and isinstance(node.args[0], ast.Constant):
                        point = node.args[0].value
                        if point not in INJECTION_POINTS:
                            msg = (
                                f"fault_point({point!r}) is not a registered "
                                f"injection point (see "
                                f"repro_torch.faults.INJECTION_POINTS)"
                            )
                            v = Violation(self.name, src.path, node.lineno, msg)
                            out.append(v)
                elif name in ("open", "os.open"):
                    triggers.append((node.lineno, f"{name}()"))
                elif name in CODEC_PRIMITIVES and func.name != name:
                    triggers.append((node.lineno, f"{name}()"))
            if not triggers or covered:
                continue
            annotations = src.fault_covered(func)
            bad = [p for p in annotations if p not in INJECTION_POINTS]
            for p in bad:
                msg = f"# fault-covered: {p!r} is not a registered injection point"
                out.append(Violation(self.name, src.path, func.lineno, msg))
            if annotations and not bad:
                continue
            for lineno, what in triggers:
                if src.disabled(lineno, self.name):
                    continue
                msg = (
                    f"{what} in {func.name}() without a fault_point on its "
                    f"path — add one, or annotate the def with "
                    f"'# fault-covered: <point>'"
                )
                out.append(Violation(self.name, src.path, lineno, msg))
        return out
