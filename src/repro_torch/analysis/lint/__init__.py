"""Project-specific AST lint framework (see ``base`` for conventions).

Importing this package registers the four shipped checkers:
fault-coverage, lock-discipline, jit-purity, typed-errors.
"""

from . import fault_coverage  # noqa: F401
from . import jit_purity  # noqa: F401
from . import lock_discipline  # noqa: F401
from . import typed_errors  # noqa: F401
from .base import (
    Checker,
    SourceFile,
    Violation,
    all_checkers,
    is_quarantined,
    load_quarantine,
    register,
    run_checkers,
)

__all__ = [
    "Checker",
    "SourceFile",
    "Violation",
    "all_checkers",
    "is_quarantined",
    "load_quarantine",
    "register",
    "run_checkers",
]
