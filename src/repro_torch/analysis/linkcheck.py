"""Relative-link checker for the repo's markdown docs.

``python -m repro_torch.analysis.linkcheck README.md docs`` walks the given
markdown files (directories are scanned for ``*.md``), extracts every
inline link/image target, and exits nonzero when a *relative* target
does not exist on disk — the CI ``docs`` gate against stale
cross-references.

Scope is file existence only: external (``http(s)://``, ``mailto:``)
targets and same-file ``#anchors`` are skipped, and a ``#fragment``
suffix on a relative target is stripped before the existence check.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

__all__ = ["check_files", "iter_links", "main"]

_LINK_RE = re.compile(r"!?\[[^\]]*\]\(([^)\s]+)(?:\s+\"[^\"]*\")?\)")
_SKIP_PREFIXES = ("http://", "https://", "mailto:")


def iter_links(text: str):
    """Yield ``(line_number, target)`` for every inline markdown link."""
    fenced = False
    for lineno, line in enumerate(text.splitlines(), start=1):
        if line.lstrip().startswith("```"):
            fenced = not fenced
            continue
        if fenced:
            continue
        for m in _LINK_RE.finditer(line):
            yield lineno, m.group(1)


def _collect(paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for entry in sorted(os.listdir(p)):
                if entry.endswith(".md"):
                    files.append(os.path.join(p, entry))
        else:
            files.append(p)
    return files


def check_files(paths: list[str]) -> list[str]:
    """Broken-link messages (``file:line: target``) for the given paths."""
    problems: list[str] = []
    for path in _collect(paths):
        fh = open(path, encoding="utf-8")  # lint: disable=fault-coverage -- CLI
        with fh:
            text = fh.read()
        base = os.path.dirname(path)
        for lineno, target in iter_links(text):
            if target.startswith(_SKIP_PREFIXES) or target.startswith("#"):
                continue
            rel = target.split("#", 1)[0]
            if not os.path.exists(os.path.join(base, rel)):
                problems.append(f"{path}:{lineno}: broken link -> {target}")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.linkcheck",
        description="verify relative markdown links resolve on disk",
    )
    ap.add_argument(
        "paths",
        nargs="+",
        help="markdown files or directories (scanned for *.md)",
    )
    args = ap.parse_args(argv)
    problems = check_files(args.paths)
    for p in problems:
        print(p)
    n_files = len(_collect(args.paths))
    print(f"{len(problems)} broken link(s) in {n_files} file(s) checked")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
