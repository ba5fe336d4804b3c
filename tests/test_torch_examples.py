"""The Simulator's two examples on the port, ``examples/quickstart_torch.py``
and ``examples/qaoa_sim_torch.py``, run with ``--device cpu`` beside
``repro``'s ``examples/quickstart.py`` and ``examples/qaoa_sim.py`` with
the same arguments, both in process.

Held equal as printed: gates, stages, fidelity, peak and standard bytes,
memory reduction, distinct outcomes and |<0|psi>|, stage-fn compiles,
cache hits and spills, the best angles and the sampled counts.  ``<cut>``
within 1e-4 relative (``CUT_RTOL``).  The phase-time line is left out.
"""
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CUT_RTOL = 1e-4
QAOA_SMALL = ["--qubits", "12", "--block-bits", "7", "--sweep", "2"]
#: a primary tier of 0 bytes: every block spills.  (Under a budget that
#: some blocks fit, which blocks spill depends on what the store holds at
#: that moment, so the count moves with thread timing in both packages.)
QAOA_SPILL = QAOA_SMALL + ["--ram-mb", "1e-9"]
_NUM = re.compile(r"-?\d+(?:\.\d+)?")
_CUT = re.compile(r"<cut> = (-?\d+\.\d+)")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_port(name: str, argv: list) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _load(f"{name}_torch").main(argv + ["--device", "cpu"])
    return buf.getvalue().splitlines()


def run_repro(name: str, argv: list, monkeypatch) -> list[str]:
    pytest.importorskip("jax")
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _load(name).main()
    return buf.getvalue().splitlines()


def _split(lines: list[str]):
    """(lines held as printed, the <cut> values); timings dropped."""
    exact, cuts = [], []
    for ln in lines:
        if ln.startswith("phase times:"):
            continue
        m = _CUT.search(ln)
        if m:
            cuts.append(float(m.group(1)))
            ln = _CUT.sub("<cut> = _", ln)
        exact.append(ln)
    return exact, cuts


def test_quickstart_prints_repros_numbers(monkeypatch):
    got = run_port("quickstart", [])
    fid = next(ln for ln in got if ln.startswith("fidelity"))
    assert float(_NUM.findall(fid)[0]) >= 0.99999
    assert got == run_repro("quickstart", [], monkeypatch)


@pytest.mark.parametrize("argv", [QAOA_SMALL, QAOA_SPILL],
                         ids=["resident", "spilling"])
def test_qaoa_sim_prints_repros_numbers(monkeypatch, argv):
    got_exact, got_cuts = _split(run_port("qaoa_sim", argv))
    compiles = [int(m) for ln in got_exact
                for m in re.findall(r"compiles so far: (\d+)", ln)]
    assert len(compiles) == 2 and len(set(compiles)) == 1
    spills = int(re.search(r"spills=(\d+)", "\n".join(got_exact)).group(1))
    assert (spills > 0) == ("--ram-mb" in argv)
    want_exact, want_cuts = _split(run_repro("qaoa_sim", argv, monkeypatch))
    assert got_exact == want_exact
    assert len(got_cuts) == len(want_cuts) == 2
    for g, w in zip(got_cuts, want_cuts):
        assert abs(g - w) <= CUT_RTOL * abs(w)


def test_examples_default_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("quickstart_torch", "qaoa_sim_torch"):
        assert _load(name).run_device("cuda") == torch.device("cuda", 0)
        assert _load(name).run_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("quickstart_torch", "qaoa_sim_torch"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _load(name).main([])
