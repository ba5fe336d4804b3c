"""CLI: ``python -m repro_torch.analysis [paths...]``.

Runs the registered AST checkers over every live (non-quarantined)
``.py`` file under the given paths and exits nonzero on any violation —
the CI ``static-analysis`` gate.  ``--plan plan.json`` instead verifies
a serialized :class:`~repro_torch.core.plan.ExecutionPlan` (same pass as
``qsim --verify``, for plan artifacts at rest).
"""

from __future__ import annotations

import argparse
import sys

from .lint import all_checkers, run_checkers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="BMQSim static analysis: project lint + plan verify",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help="files or directories to lint (e.g. src/repro_torch)",
    )
    ap.add_argument(
        "--select",
        metavar="NAMES",
        help="comma-separated checker names (default: all)",
    )
    ap.add_argument(
        "--list",
        action="store_true",
        help="list registered checkers and exit",
    )
    ap.add_argument(
        "--no-quarantine",
        action="store_true",
        help="also lint files matching analysis/quarantine.txt",
    )
    ap.add_argument(
        "--plan",
        metavar="PLAN_JSON",
        help="verify a serialized ExecutionPlan instead of linting",
    )
    args = ap.parse_args(argv)

    if args.list:
        for name, cls in sorted(all_checkers().items()):
            print(f"{name:16s} {cls.description}")
        return 0

    if args.plan:
        from ..core.plan import ExecutionPlan
        from .plan_check import verify_plan

        fh = open(args.plan, encoding="utf-8")  # lint: disable=fault-coverage -- CLI
        with fh:
            plan = ExecutionPlan.from_json(fh.read())
        findings = verify_plan(plan)
        for f in findings:
            print(f.render())
        errors = sum(f.severity == "error" for f in findings)
        summary = f"{errors} error(s), {len(findings) - errors} warning(s)"
        print(f"plan {plan.fingerprint[:12]}: {summary}")
        return 1 if errors else 0

    if not args.paths:
        ap.error("no paths given "
                 "(try: python -m repro_torch.analysis src/repro_torch)")
    select = None
    if args.select:
        select = [s.strip() for s in args.select.split(",") if s.strip()]
    violations, n_files, skipped = run_checkers(
        args.paths,
        select=select,
        use_quarantine=not args.no_quarantine,
    )
    for v in violations:
        print(v.render())
    tail = f", {len(skipped)} quarantined file(s) skipped" if skipped else ""
    print(f"{len(violations)} violation(s) in {n_files} file(s) checked{tail}")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
