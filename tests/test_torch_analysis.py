"""The port's host tooling (``repro_torch.analysis``) against ``repro``'s.

* Every lint case of ``tests/test_analysis.py`` goes through both
  packages' checkers: the violations are equal as ``(checker, path,
  line)`` and their messages are equal once ``repro_torch.`` is read as
  ``repro.``.  The same holds over all of ``src/repro`` without the
  quarantine and over ``src/repro_torch`` (empty in both).  The port's
  quarantine is empty.
* ``linkcheck`` gives ``repro``'s results on the repo's docs and on a
  seeded file; ``api_doc`` keeps ``docs/API_torch.md`` equal to the live
  surface of ``repro_torch``; ``--plan`` gives ``repro``'s verdict and
  exit code on the same plan JSON, clean and tampered.
* The CLIs run in a process where importing ``jax`` or ``repro`` raises.

Every comparison is exact: the tooling is deterministic host code, so no
tolerance applies.  The ``repro`` side skips where ``repro`` cannot be
imported; the port's own expectations still run.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch import EngineConfig, Simulator, build_circuit
from repro_torch.analysis import api_doc, linkcheck
from repro_torch.analysis import lint as tlint
from repro_torch.analysis.__main__ import main as tmain

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
JAX_PKG = ROOT / "src" / "repro"
CHECKERS = ["fault-coverage", "lock-discipline", "jit-purity",
            "typed-errors"]


def _repro_lint():
    return pytest.importorskip("repro.analysis.lint")


def _key(v, port: bool):
    msg = v.message.replace("repro_torch.", "repro.") if port else v.message
    return (v.checker, v.path, v.line, msg)


def _agree(tv, rv):
    """The port's violations ``tv`` equal ``repro``'s ``rv``."""
    assert [_key(v, True) for v in tv] == [_key(v, False) for v in rv]


# ---------------------------------------------------------------------------
# the lint cases of tests/test_analysis.py, through both packages
# ---------------------------------------------------------------------------

#: id -> (source, checker or None for all, checkers the port must report)
LINT_CASES = {
    "pragma_without_reason": ("""\
        def spill(path):
            with open(path, "rb") as fh:  # lint: disable=fault-coverage
                return fh.read()
        """, None, ["fault-coverage", "pragma"]),
    "pragma_with_reason": ("""\
        def spill(path):
            with open(path, "rb") as fh:  # lint: disable=fault-coverage -- test fixture
                return fh.read()
        """, None, []),
    "fault_uninstrumented_io": ("""\
        def spill(path, blob):
            with open(path, "wb") as fh:
                fh.write(blob)
        """, "fault-coverage", ["fault-coverage"]),
    "fault_instrumented_io": ("""\
        from repro.faults import fault_point

        def spill(path, blob):
            fault_point("store.spill_write", blob)
            with open(path, "wb") as fh:
                fh.write(blob)
        """, "fault-coverage", []),
    "fault_def_annotation": ("""\
        # fault-covered: store.spill_write
        def spill(path, blob):
            with open(path, "wb") as fh:
                fh.write(blob)
        """, "fault-coverage", []),
    "fault_unknown_point": ("""\
        from repro.faults import fault_point

        def spill(path, blob):
            fault_point("store.bogus_point", blob)
            with open(path, "wb") as fh:
                fh.write(blob)
        """, "fault-coverage", ["fault-coverage"]),
    "fault_unknown_annotation": ("""\
        # fault-covered: not.a.point
        def spill(path, blob):
            with open(path, "wb") as fh:
                fh.write(blob)
        """, "fault-coverage", ["fault-coverage", "fault-coverage"]),
    "fault_codec_primitive": ("""\
        def roundtrip(planes, n, params):
            return encode_group_planes(planes, n, params)
        """, "fault-coverage", ["fault-coverage"]),
    "lock_unguarded": ("""\
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0   # guarded-by: _lock

            def bump(self):
                self.count += 1
        """, "lock-discipline", ["lock-discipline"]),
    "lock_with_block": ("""\
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0   # guarded-by: _lock

            def bump(self):
                with self._lock:
                    self.count += 1
        """, "lock-discipline", []),
    "lock_holds_lock": ("""\
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0   # guarded-by: _lock

            def _bump_locked(self):  # holds-lock: _lock
                self.count += 1
        """, "lock-discipline", []),
    "lock_nested_closure": ("""\
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0   # guarded-by: _lock

            def bump_twice(self):
                with self._lock:
                    def inner():
                        self.count += 1
                    inner()
                    inner()
        """, "lock-discipline", []),
    "jit_host_sync": ("""\
        import jax
        import numpy as np

        @jax.jit
        def f(x):
            return np.asarray(x)
        """, "jit-purity", ["jit-purity"]),
    "jit_call_graph": ("""\
        import jax

        def helper(x):
            return float(x)

        @jax.jit
        def f(x):
            return helper(x) + 1
        """, "jit-purity", ["jit-purity"]),
    "jit_static_values": ("""\
        import jax

        LANES = 4

        @jax.jit
        def f(x):
            return x * float(LANES) + int(len("ab"))
        """, "jit-purity", []),
    "jit_ok_pragma": ("""\
        import jax
        import numpy as np

        @jax.jit
        def f(x, perm):
            inv = np.argsort(np.asarray(perm))  # jit-ok: perm is static
            return x[inv]
        """, "jit-purity", []),
    "jit_unreachable": ("""\
        import jax
        import numpy as np

        def host_only(x):
            return np.asarray(x)

        @jax.jit
        def f(x):
            return x + 1
        """, "jit-purity", []),
    "typed_swallowed_broad": ("""\
        def f():
            try:
                g()
            except Exception:
                pass
        """, "typed-errors", ["typed-errors"]),
    "typed_bare_and_broad_raise": ("""\
        def f():
            try:
                g()
            except:
                raise
            raise Exception("boom")
        """, "typed-errors", ["typed-errors", "typed-errors"]),
    "typed_reraise": ("""\
        def f():
            try:
                g()
            except Exception:
                cleanup()
                raise
        """, "typed-errors", []),
    "typed_narrow": ("""\
        def f():
            try:
                g()
            except (OSError, ValueError):
                pass
        """, "typed-errors", []),
    "syntax_error": ("def f(:\n", None, ["parse"]),
}


@pytest.mark.parametrize("case", list(LINT_CASES))
def test_lint_case_matches_repro(tmp_path, case):
    source, checker, want = LINT_CASES[case]
    path = tmp_path / "snippet.py"
    path.write_text(textwrap.dedent(source))
    select = [checker] if checker else None
    tv, n_files, skipped = tlint.run_checkers(
        [str(path)], select=select, use_quarantine=False)
    assert sorted(v.checker for v in tv) == sorted(want)
    assert (n_files, skipped) == (0 if case == "syntax_error" else 1, [])
    rv, rn, rs = _repro_lint().run_checkers(
        [str(path)], select=select, use_quarantine=False)
    _agree(tv, rv)
    assert (n_files, skipped) == (rn, rs)


def test_registry_is_the_ports_own():
    names = set(tlint.all_checkers())
    assert set(CHECKERS) <= names
    rlint = _repro_lint()
    assert names == set(rlint.all_checkers())
    for name in CHECKERS:
        tcls, rcls = tlint.all_checkers()[name], rlint.all_checkers()[name]
        assert tcls is not rcls
        assert tcls.__module__.startswith("repro_torch.analysis.lint.")
        assert tcls.description == rcls.description
    from repro_torch.analysis.lint import base
    assert base._REGISTRY is not _repro_lint().base._REGISTRY


def test_unknown_checker_raises_as_repro(tmp_path):
    (tmp_path / "x.py").write_text("pass\n")
    msgs = []
    for lint in (tlint, _repro_lint()):
        with pytest.raises(ValueError, match="unknown checker") as exc:
            lint.run_checkers([str(tmp_path)], select=["no-such-checker"])
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_quarantine_walk_matches_repro(tmp_path):
    (tmp_path / "live.py").write_text("raise Exception('x')\n")
    dead = tmp_path / "deadwood"
    dead.mkdir()
    (dead / "old.py").write_text("raise Exception('x')\n")
    q = tmp_path / "quarantine.txt"
    q.write_text("deadwood  # dead scaffolding\n")
    tv, n, skipped = tlint.run_checkers(
        [str(tmp_path)], select=["typed-errors"], quarantine_path=str(q))
    assert n == 1 and len(skipped) == 1
    assert len(tv) == 1 and "live.py" in tv[0].path
    rv, rn, rs = _repro_lint().run_checkers(
        [str(tmp_path)], select=["typed-errors"], quarantine_path=str(q))
    _agree(tv, rv)
    assert (n, skipped) == (rn, rs)


def test_the_ports_quarantine_is_empty():
    assert tlint.load_quarantine() == []
    assert Path(tlint.base.DEFAULT_QUARANTINE).parent == PORT / "analysis"
    assert not tlint.is_quarantined(str(PORT / "models" / "moe.py"),
                                    tlint.load_quarantine())


def test_violation_render_is_clickable():
    v = tlint.Violation("typed-errors", "src/x.py", 7, "msg")
    assert v.render() == "src/x.py:7: [typed-errors] msg"


def test_the_jax_tree_without_quarantine_matches_repro():
    tv, n, skipped = tlint.run_checkers([str(JAX_PKG)],
                                        use_quarantine=False)
    assert tv and skipped == []
    rv, rn, rs = _repro_lint().run_checkers([str(JAX_PKG)],
                                            use_quarantine=False)
    _agree(tv, rv)
    assert (n, skipped) == (rn, rs)


def test_the_port_tree_is_clean_under_both():
    tv, n, skipped = tlint.run_checkers([str(PORT)])
    assert tv == [], "\n".join(v.render() for v in tv)
    assert n == len(list(PORT.rglob("*.py"))) and skipped == []
    rv, rn, _ = _repro_lint().run_checkers([str(PORT)])
    assert rv == [] and rn == n


# ---------------------------------------------------------------------------
# linkcheck
# ---------------------------------------------------------------------------

def _seeded_md(tmp_path):
    md = tmp_path / "doc.md"
    md.write_text(
        "see [other](other.md) and [web](https://example.com) and\n"
        "[anchor](#here) and [frag](other.md#sec) and [m](mailto:a@b)\n"
        "```\n[not a link](nope.md) in a fence\n```\n"
        "![img](pics/x.png \"title\")\n",
        encoding="utf-8")
    return md


def test_linkcheck_matches_repro(tmp_path, capsys):
    rlink = pytest.importorskip("repro.analysis.linkcheck")
    md = _seeded_md(tmp_path)
    cases = [[str(ROOT / "README.md"), str(ROOT / "docs")], [str(md)],
             [str(tmp_path)]]
    for paths in cases:
        assert linkcheck.check_files(paths) == rlink.check_files(paths)
        got = (linkcheck.main(paths), capsys.readouterr().out)
        want = (rlink.main(paths), capsys.readouterr().out)
        assert got == want
    assert linkcheck.check_files(cases[0]) == []
    assert len(linkcheck.check_files([str(md)])) == 3
    (tmp_path / "other.md").write_text("x", encoding="utf-8")
    assert linkcheck.check_files([str(md)]) == rlink.check_files([str(md)])
    assert len(linkcheck.check_files([str(md)])) == 1     # pics/x.png


# The repo's working records (progress notes, measurements, plans) are
# kept beside the code but are not part of what the docs document; a
# source archive may ship without them.  README.md and docs/ name them in
# text and never link to them, so the link check of the docs holds in
# such a tree too.
WORKING_RECORDS = ("PERF.md", "ROADMAP.md", "CHANGES.md", "ISSUE.md",
                   "PERF_LEDGER.jsonl")


def test_docs_link_to_no_working_record():
    linked = []
    for path in linkcheck._collect([str(ROOT / "README.md"),
                                    str(ROOT / "docs")]):
        text = Path(path).read_text(encoding="utf-8")
        for lineno, target in linkcheck.iter_links(text):
            rel = target.split("#", 1)[0]
            if not rel or target.startswith(("http://", "https://",
                                              "mailto:")):
                continue
            full = Path(os.path.normpath(Path(path).parent / rel))
            if full.parent == ROOT and full.name in WORKING_RECORDS:
                linked.append(f"{path}:{lineno}: {target}")
    assert linked == []


# ---------------------------------------------------------------------------
# api_doc
# ---------------------------------------------------------------------------

def test_committed_api_doc_matches_live_surface():
    committed = (ROOT / "docs" / "API_torch.md").read_text(encoding="utf-8")
    assert committed == api_doc.generate()


def test_api_doc_check_mode(tmp_path, capsys):
    good = tmp_path / "API_torch.md"
    good.write_text(api_doc.generate(), encoding="utf-8")
    assert api_doc.main(["--check", str(good)]) == 0
    stale = tmp_path / "stale.md"
    stale.write_text("# Public API reference\n\nold\n", encoding="utf-8")
    assert api_doc.main(["--check", str(stale)]) == 1
    assert "--write docs/API_torch.md" in capsys.readouterr().out
    assert api_doc.main(["--check", str(tmp_path / "absent.md")]) == 1


def test_api_doc_renders_every_export_stably():
    import repro_torch
    text = api_doc.generate()
    assert "docs/API.md" not in text
    for name in repro_torch.__all__:
        assert f"### `{name}`" in text
    assert "(no docstring)" not in text
    for block in text.split("```python")[1:]:
        sig = block.split("```")[0]
        assert sig.count("\n    *,\n") <= 1
        assert "0x" not in sig
    flat = [n for _, names in api_doc._sections() for n in names]
    assert flat == list(repro_torch.__all__)


# ---------------------------------------------------------------------------
# --plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plan_json():
    with Simulator(build_circuit("qft", 9), EngineConfig(
            local_bits=4, devices=[torch.device("cpu")])) as sim:
        return sim.compile(verify=False).to_json()


def _run_plan(main, path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--plan", str(path)])
    return rc, buf.getvalue()


def _tampered(plan_json, how):
    doc = json.loads(plan_json)
    if how == "predictions":        # test_tampered_predictions_are_caught
        doc["predicted"]["boundary_bytes"] += 1
    elif how == "gate_slice":       # test_analysis_cli_verifies_plan_artifact
        lo, hi = doc["stages"][0]["gate_slice"]
        doc["stages"][0]["gate_slice"] = [lo + 1, hi + 1]
    return json.dumps(doc)


@pytest.mark.parametrize("how,rc,code", [
    ("clean", 0, None), ("predictions", 1, "predictions"),
    ("gate_slice", 1, "gate-tiling")])
def test_plan_verdict_matches_repro(tmp_path, plan_json, how, rc, code):
    path = tmp_path / "plan.json"
    path.write_text(_tampered(plan_json, how))
    got = _run_plan(tmain, path)
    assert got[0] == rc
    if code is None:
        assert " 0 error(s), 0 warning(s)" in got[1].splitlines()[-1]
    else:
        assert f"[error] {code}: " in got[1]
    pytest.importorskip("jax")
    from repro.analysis.__main__ import main as rmain
    assert got == _run_plan(rmain, path)


def test_the_jax_plan_json_is_the_ports(plan_json):
    pytest.importorskip("jax")
    import repro
    with repro.Simulator(repro.build_circuit("qft", 9),
                         repro.EngineConfig(local_bits=4)) as sim:
        assert sim.compile(verify=False).to_json() == plan_json


# ---------------------------------------------------------------------------
# the CLIs without JAX
# ---------------------------------------------------------------------------

_NO_JAX = """\
import runpy, sys

class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name} is refused here")
        return None

sys.meta_path.insert(0, _Refuse())
sys.argv = ["analysis"] + sys.argv[2:]
try:
    runpy.run_module(sys.argv_module, run_name="__main__")
except SystemExit as e:
    rc = e.code
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("refused modules loaded:", loaded)
sys.exit(rc)
"""


def _no_jax(module: str, *args, cwd=ROOT):
    code = _NO_JAX.replace("sys.argv_module", repr(module))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-c", code, module, *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=240)


@pytest.mark.parametrize("module,args,last", [
    ("repro_torch.analysis", ["src/repro_torch"],
     f"0 violation(s) in {len(list(PORT.rglob('*.py')))} file(s) checked"),
    ("repro_torch.analysis.linkcheck", ["README.md", "docs"], None),
    ("repro_torch.analysis.api_doc", ["--check", "docs/API_torch.md"],
     "docs/API_torch.md is up to date with repro_torch.__all__"),
])
def test_cli_runs_where_jax_and_repro_are_refused(module, args, last):
    res = _no_jax(module, *args)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert lines[-1] == "refused modules loaded: []"
    if last is not None:
        assert lines[-2] == last
    else:
        assert lines[-2].startswith("0 broken link(s) in ")


def test_plan_cli_runs_where_jax_and_repro_are_refused(tmp_path, plan_json):
    path = tmp_path / "plan.json"
    path.write_text(plan_json)
    res = _no_jax("repro_torch.analysis", "--plan", str(path))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.splitlines()[-1] == "refused modules loaded: []"
    assert "0 error(s), 0 warning(s)" in res.stdout
