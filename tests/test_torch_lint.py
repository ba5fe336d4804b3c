"""The static-analysis gate over the port: ``repro.analysis.lint``'s
registered checkers (fault-point coverage, lock discipline, jit purity —
vacuous on torch code, kept all the same — and the typed-error contract)
run over every file of ``src/repro_torch``, none quarantined, and find
nothing.  The checkers live in the JAX package (they import no JAX), so
this skips where that package cannot be imported."""
from pathlib import Path

import pytest

lint = pytest.importorskip("repro.analysis.lint")

PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
CHECKERS = ["fault-coverage", "lock-discipline", "jit-purity",
            "typed-errors"]


def test_every_checker_is_registered():
    assert set(CHECKERS) <= set(lint.all_checkers())


def test_the_port_has_no_violations():
    violations, n_files, skipped = lint.run_checkers([str(PORT)])
    assert violations == [], "\n".join(v.render() for v in violations)
    assert n_files == len(list(PORT.rglob("*.py"))) > 60
    assert skipped == []            # the quarantine covers none of it


@pytest.mark.parametrize("checker", CHECKERS)
def test_each_checker_passes_the_port(checker):
    violations, n_files, _ = lint.run_checkers([str(PORT)],
                                               select=[checker])
    assert violations == [], "\n".join(v.render() for v in violations)
    assert n_files > 60
