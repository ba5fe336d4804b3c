"""Generate ``docs/API_torch.md`` from the ``repro_torch`` public surface.

The public API is whatever :data:`repro_torch.__all__` declares; this module
renders one entry per export — heading, cleaned signature, first
docstring line — grouped by the ``#`` section comments inside the
``__all__`` literal itself (parsed from source, so the doc's grouping
can never drift from the code's).

Two CLI modes keep the committed file honest:

``python -m repro_torch.analysis.api_doc --write docs/API_torch.md``
    Regenerate the file in place.

``python -m repro_torch.analysis.api_doc --check docs/API_torch.md``
    Exit nonzero (printing a unified diff) when the committed doc and
    the live surface disagree — the CI ``docs`` gate.

Rendering is deterministic for a given source tree: annotations are
PEP-563 strings (every public module uses ``from __future__ import
annotations``), defaults render via ``repr``, and signatures longer
than 88 columns wrap one-parameter-per-line.
"""

from __future__ import annotations

import argparse
import difflib
import inspect
import re
import sys

__all__ = ["generate", "main"]

_WIDTH = 88

_SECTION_RE = re.compile(r"^\s*#\s*(.+?)\s*$")
_NAME_RE = re.compile(r"\"([A-Za-z_][A-Za-z0-9_]*)\"")
_BUILTIN_RE = re.compile(r"<built-in function (\w+)>")
_CLASS_RE = re.compile(r"<class '([\w.]+)'>")


def _sections():
    """``[(section_title, [export, ...]), ...]`` in ``__all__`` order.

    Parsed from the source of ``repro_torch/__init__.py`` so the grouping
    comments inside the ``__all__`` literal carry over to the doc.
    """
    import repro_torch

    src = inspect.getsource(repro_torch)
    body = src.split("__all__ = [", 1)[1].split("]", 1)[0]
    sections: list[tuple[str, list[str]]] = []
    title = "exports"
    for line in body.splitlines():
        m = _SECTION_RE.match(line)
        if m:
            title = m.group(1)
            continue
        for name in _NAME_RE.findall(line):
            if not sections or sections[-1][0] != title:
                sections.append((title, []))
            sections[-1][1].append(name)
    flat = [n for _, names in sections for n in names]
    if flat != list(repro_torch.__all__):
        raise RuntimeError(
            "api_doc parsed __all__ inconsistently with repro_torch.__all__: "
            f"{flat!r} != {list(repro_torch.__all__)!r}"
        )
    return sections


def _fmt_param(p: inspect.Parameter) -> str:
    s = p.name
    if p.kind is p.VAR_POSITIONAL:
        s = "*" + s
    elif p.kind is p.VAR_KEYWORD:
        s = "**" + s
    if p.annotation is not p.empty:
        ann = p.annotation
        if not isinstance(ann, str):
            ann = inspect.formatannotation(ann)
        s += f": {ann}"
    if p.default is not p.empty:
        d = repr(p.default)
        d = _BUILTIN_RE.sub(r"\1", d)
        d = _CLASS_RE.sub(r"\1", d)
        sep = " = " if p.annotation is not p.empty else "="
        s += f"{sep}{d}"
    return s


def _fmt_signature(obj) -> str | None:
    """Render ``obj``'s signature, or None when it has no useful one.

    Private (``_``-prefixed) parameters are dropped; ``*`` / ``/``
    markers are preserved around the drop.
    """
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    parts: list[str] = []
    saw_var_positional = False
    marker_emitted = False
    for p in sig.parameters.values():
        if p.kind is p.VAR_POSITIONAL:
            saw_var_positional = True
        if p.name.startswith("_"):
            continue
        if (
            p.kind is p.KEYWORD_ONLY
            and not saw_var_positional
            and not marker_emitted
        ):
            parts.append("*")
            marker_emitted = True
        parts.append(_fmt_param(p))
    one_line = f"({', '.join(parts)})"
    ret = ""
    if not inspect.isclass(obj) and sig.return_annotation is not sig.empty:
        ann = sig.return_annotation
        if not isinstance(ann, str):
            ann = inspect.formatannotation(ann)
        ret = f" -> {ann}"
    return one_line + ret


def _headline(obj, name: str) -> str:
    """``class Name(Base)`` / ``def name`` — the fenced block's first line."""
    if inspect.isclass(obj):
        bases = [
            b.__name__
            for b in obj.__bases__
            if b is not object and not b.__name__.startswith("_")
        ]
        suffix = f"({', '.join(bases)})" if bases else ""
        return f"class {name}{suffix}"
    return f"def {name}"


def _wrap(decl: str, sig: str) -> str:
    """One line when it fits, else one parameter per line."""
    flat = decl + sig
    if len(flat) <= _WIDTH:
        return flat
    params, _, ret = sig.rpartition(")")
    params = params[1:]
    depth = 0
    parts, cur = [], ""
    for ch in params:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        parts.append(cur.strip())
    body = "".join(f"    {p},\n" for p in parts)
    return f"{decl}(\n{body}){ret}"


def _summary(obj) -> str:
    doc = inspect.getdoc(obj) or ""
    for line in doc.splitlines():
        if line.strip():
            return line.strip()
    return "*(no docstring)*"


def generate() -> str:
    """The full ``docs/API_torch.md`` body as a string."""
    import repro_torch

    out = [
        "# Public API reference",
        "",
        "<!-- GENERATED FILE - DO NOT EDIT BY HAND. -->",
        "<!-- Regenerate: PYTHONPATH=src python -m repro_torch.analysis.api_doc"
        " --write docs/API_torch.md -->",
        "",
        f"`repro_torch` {repro_torch.__version__} — every name in"
        " `repro_torch.__all__`, in declared order.",
        "The CI docs gate (`--check`) fails when this file and the live"
        " surface disagree.",
        "",
    ]
    for title, names in _sections():
        out.append(f"## {title.capitalize()}")
        out.append("")
        for name in names:
            obj = getattr(repro_torch, name)
            out.append(f"### `{name}`")
            out.append("")
            sig = _fmt_signature(obj)
            if sig is not None:
                out.append("```python")
                out.append(_wrap(_headline(obj, name), sig))
                out.append("```")
                out.append("")
            out.append(_summary(obj))
            out.append("")
    return "\n".join(out).rstrip() + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.api_doc",
        description="generate/verify docs/API_torch.md from "
        "repro_torch.__all__",
    )
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument(
        "--write", action="store_true", help="(re)write PATH from the live surface"
    )
    mode.add_argument(
        "--check",
        action="store_true",
        help="diff PATH against the live surface; exit 1 on drift",
    )
    ap.add_argument("path", nargs="?", default="docs/API_torch.md")
    args = ap.parse_args(argv)

    want = generate()
    if args.write:
        fh = open(args.path, "w", encoding="utf-8")  # lint: disable=fault-coverage -- CLI
        with fh:
            fh.write(want)
        print(f"wrote {args.path} ({len(want.splitlines())} lines)")
        return 0

    try:
        fh = open(args.path, encoding="utf-8")  # lint: disable=fault-coverage -- CLI
        with fh:
            have = fh.read()
    except OSError as e:
        print(f"cannot read {args.path}: {e}", file=sys.stderr)
        return 1
    if have == want:
        print(f"{args.path} is up to date with repro_torch.__all__")
        return 0
    diff = difflib.unified_diff(
        have.splitlines(keepends=True),
        want.splitlines(keepends=True),
        fromfile=f"{args.path} (committed)",
        tofile=f"{args.path} (generated)",
    )
    sys.stdout.writelines(diff)
    print(
        f"\n{args.path} is stale - regenerate with: "
        "PYTHONPATH=src python -m repro_torch.analysis.api_doc "
        "--write docs/API_torch.md"
    )
    return 1


if __name__ == "__main__":
    sys.exit(main())
