"""The port's fslint (``repro_torch.analysis``) and dry-run report
(``scripts/render_experiments_torch.py``) against the JAX package's
(``repro.analysis``, ``scripts/render_experiments.py``).

The seven rules the port shares with the JAX checker give the same
(rule, path, line, col, message) on every JAX fixture and on the JAX tree,
each rule over its JAX scope's files; the only difference is the ``format``
rule's f-string findings, which the JAX rule makes under Python 3.12 and
the port's drops.  The framework cases of ``tests/analysis/test_framework.py``
(suppressions, baseline, walking, CLI) give the same results on both
engines.  ``device-pointer``, the port's counterpart of ``donation``, has
its own fixture pair.  The default run over the port's tree is clean.  The
report renders the reference's tables, apart from its fits column.

Neither checker imports torch or jax; only the report's end-to-end case
runs the port's dry-run (a child process, torch on the CPU).
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tokenize
from pathlib import Path

import pytest

import repro.analysis.__main__ as jax_cli
import repro.analysis.engine as jax_engine
import repro.analysis.rules  # noqa: F401 - registers the JAX rules
import repro_torch.analysis.__main__ as port_cli
import repro_torch.analysis.engine as port_engine
import repro_torch.analysis.rules  # noqa: F401 - registers the port's rules
from repro.analysis.registry import RULES as JAX_RULES
from repro_torch.analysis.registry import RULES as PORT_RULES

ROOT = Path(__file__).resolve().parents[1]
JAX_FIXTURES = ROOT / "tests" / "analysis" / "fixtures"
FIXTURES = ROOT / "tests" / "torch_analysis_fixtures"
#: shared rule -> the stem of its JAX fixture pair
JAX_FIXTURE = {
    "aliasing": "aliasing",
    "determinism": "determinism",
    "format": "format",
    "frozen-stats": "stats",
    "gauge-keys": "gauges",
    "vacuous-gate": "gates",
    "wire-format": "wire",
}
SHARED = sorted(JAX_FIXTURE)
ENGINES = {"jax": (jax_engine, jax_cli), "port": (port_engine, port_cli)}
QUOTE_MESSAGE = "single-quoted string; the format gate's quote-style is \"double\""


def _findings(result) -> list[tuple]:
    return [(f.rule, f.path, f.line, f.col, f.message) for f in result.findings]


def _summary(result) -> tuple:
    return (
        _findings(result),
        [(s.path, s.line, s.rules, s.covers) for s in result.unused_suppressions],
        result.stale_baseline,
        result.files_scanned,
        result.rules_run,
        result.clean,
    )


def _rel(path: Path) -> str:
    return path.resolve().relative_to(ROOT).as_posix()


# -- the rule sets ---------------------------------------------------------------


def test_port_rules_are_the_jax_rules_with_device_pointer_for_donation():
    assert set(PORT_RULES) == set(JAX_RULES) - {"donation"} | {"device-pointer"}
    assert len(SHARED) == 7 and set(SHARED) == set(PORT_RULES) & set(JAX_RULES)


@pytest.mark.parametrize("name", sorted(PORT_RULES))
def test_every_port_scope_pattern_names_a_port_file(name):
    """A renamed port file cannot silently drop out of a rule's scope."""
    files = [
        _rel(f) for f in port_engine.iter_python_files(ROOT, port_engine.DEFAULT_ROOTS)
    ]
    rule = PORT_RULES[name]
    for pattern in rule.scope:
        assert any(rule.applies_to(f) and f.startswith(pattern.split("*")[0])
                   for f in files), pattern


# -- fixtures, rule by rule ------------------------------------------------------


@pytest.mark.parametrize("kind", ["bug", "fixed"])
@pytest.mark.parametrize("rule", SHARED)
def test_jax_fixture_findings_are_the_same_in_both_engines(rule, kind):
    path = str(JAX_FIXTURES / f"{JAX_FIXTURE[rule]}_{kind}.py")
    kw = dict(select=[rule], ignore_scope=True, baseline=None)
    jax, port = jax_engine.run([path], **kw), port_engine.run([path], **kw)
    assert _summary(port) == _summary(jax)
    assert bool(port.findings) == (kind == "bug")


def test_device_pointer_fires_on_temporaries():
    result = port_engine.run([str(FIXTURES / "device_pointer_bug.py")],
                             select=["device-pointer"], ignore_scope=True,
                             baseline=None)
    got = [(f.line, f.message.split(".data_ptr()")[0]) for f in result.findings]
    assert got == [
        (22, "values.contiguous()"),
        (23, "starts.to(torch.int32)"),
        (25, "torch.empty(n, dtype=torch.float64, device=values.device)"),
        (34, "tables[0]"),
        (34, "SCRATCH"),
    ]
    kinds = " | ".join(f.message for f in result.findings)
    assert kinds.count("a call's result") == 3
    assert "a subscript" in kinds and "'SCRATCH' is not bound" in kinds


def test_device_pointer_silent_on_the_shipped_wrapper_shape():
    result = port_engine.run([str(FIXTURES / "device_pointer_fixed.py")],
                             select=["device-pointer"], ignore_scope=True,
                             baseline=None)
    assert result.findings == [] and result.clean


def test_device_pointer_guards_the_kernel_wrappers(tmp_path):
    """Every kernel wrapper takes its addresses of names (the rule is clean
    on ``kernels/``); the lookup wrapper with one address taken of
    ``keys.contiguous()`` is flagged at that line."""
    ops = sorted((ROOT / "src" / "repro_torch" / "kernels").glob("*/ops.py"))
    assert len(ops) == 6
    uses = sum(f.read_text().count(".data_ptr()") for f in ops)
    assert uses > 13
    clean = port_engine.run(["src/repro_torch/kernels"], select=["device-pointer"],
                            baseline=None)
    assert clean.files_scanned >= 10 and clean.clean
    src = (ROOT / "src" / "repro_torch" / "kernels" / "online_lookup" / "ops.py").read_text()
    assert src.count("keys.data_ptr(), queries.data_ptr()") == 1
    broken = tmp_path / "ops.py"
    broken.write_text(src.replace("keys.data_ptr(), queries.data_ptr()",
                                  "keys.contiguous().data_ptr(), queries.data_ptr()"))
    result = port_engine.run([str(broken)], select=["device-pointer"],
                             ignore_scope=True, baseline=None)
    (finding,) = result.findings
    line = broken.read_text().splitlines()[finding.line - 1]
    assert "keys.contiguous().data_ptr()" in line


def test_every_port_rule_has_a_fixture_pair():
    for rule in SHARED:
        for kind in ("bug", "fixed"):
            assert (JAX_FIXTURES / f"{JAX_FIXTURE[rule]}_{kind}.py").is_file()
    for kind in ("bug", "fixed"):
        assert (FIXTURES / f"device_pointer_{kind}.py").is_file()
    assert set(PORT_RULES) == set(SHARED) | {"device-pointer"}


# -- the f-string fault of the reference -----------------------------------------


def test_fstring_fault_of_the_reference_and_its_repair():
    """Under 3.12 the JAX rule flags the ``'k'`` inside ``f"{d['k']}"`` and
    misses ``f'plain'``; the port's rule does the reverse (and both give the
    port's answer before 3.12, where an f-string is one STRING token)."""
    path = FIXTURES / "format_fstring.py"
    lines = path.read_text().splitlines()
    key = next((i + 1, ln.index("'k'")) for i, ln in enumerate(lines) if "'k'" in ln)
    plain = next((i + 1, ln.index("f'")) for i, ln in enumerate(lines)
                 if ln.startswith("PLAIN"))
    kw = dict(select=["format"], ignore_scope=True, baseline=None)
    jax = [(f.line, f.col) for f in jax_engine.run([str(path)], **kw).findings]
    port = [(f.line, f.col) for f in port_engine.run([str(path)], **kw).findings]
    assert port == [plain]
    assert jax == ([key] if sys.version_info >= (3, 12) else [plain])


@pytest.mark.parametrize("source, flagged", [
    ("x = f\"{d['k']}\"\n", False),
    ("x = f'plain'\n", True),
    ("x = f'{d[\"k\"]}'\n", False),
    ("x = f\"{f'{y}'}\"\n", False),
    ("x = f'''a\n{y}\nb'''\n", True),
    ("x = rf'\\d{y}'\n", True),
    ("x = 'k'\n", True),
    ("x = \"k\" f\"{y!r:>{w}}\"\n", False),
])
def test_format_judges_an_fstring_whole_by_its_own_quote(tmp_path, source, flagged):
    f = tmp_path / "mod.py"
    f.write_text(source)
    result = port_engine.run([str(f)], select=["format"], ignore_scope=True,
                             baseline=None)
    assert [x.message for x in result.findings] == ([QUOTE_MESSAGE] if flagged else [])
    if flagged:
        assert (result.findings[0].line, result.findings[0].col) == (1, 4)


# -- the JAX tree, rule by rule --------------------------------------------------


@pytest.fixture(scope="module")
def jax_tree():
    return jax_engine.iter_python_files(ROOT, jax_engine.DEFAULT_ROOTS)


def _fstring_spans(path: str) -> list[tuple]:
    spans, depth, start = [], 0, None
    with open(path) as fh:
        for tok in tokenize.generate_tokens(fh.readline):
            if tok.type == getattr(tokenize, "FSTRING_START", -1):
                depth += 1
                start = tok.start if depth == 1 else start
            elif tok.type == getattr(tokenize, "FSTRING_END", -1):
                depth -= 1
                if depth == 0:
                    spans.append((start, tok.end))
    return spans


def _inside_fstring(finding: tuple) -> bool:
    _, path, line, col, message = finding
    return message == QUOTE_MESSAGE and any(
        a < (line, col) < b for a, b in _fstring_spans(str(ROOT / path)))


@pytest.mark.parametrize("rule", SHARED)
def test_jax_tree_findings_are_the_same_in_both_engines(rule, jax_tree):
    """Each shared rule over the files of its JAX scope: the same findings,
    but for the format rule's quotes inside f-strings (Python 3.12's
    tokens), which the port drops, every one of them."""
    files = [str(f) for f in jax_tree if JAX_RULES[rule].applies_to(_rel(f))]
    assert files
    kw = dict(select=[rule], ignore_scope=True, baseline=None)
    jax = set(_findings(jax_engine.run(files, **kw)))
    port = set(_findings(port_engine.run(files, **kw)))
    if rule != "format":
        assert port == jax
        return
    assert port <= jax
    dropped = jax - port
    assert all(_inside_fstring(f) for f in dropped)
    assert {f for f in jax if _inside_fstring(f)} == dropped
    assert bool(dropped) == (sys.version_info >= (3, 12))


def test_jax_default_run_fails_only_by_the_fstring_fault():
    """The JAX package's own default run: every finding is a quote inside an
    f-string (the known baseline failure of
    ``tests/analysis/test_tree_clean.py``), none in a file of the port."""
    result = jax_engine.run()
    found = _findings(result)
    assert all(_inside_fstring(f) for f in found)
    assert not any(f[1].startswith(("src/repro_torch/", "tests/torch_analysis_fixtures/",
                                    "tests/test_torch_"))
                   or f[1].endswith("_torch.py") for f in found)
    assert result.unused_suppressions == [] and result.stale_baseline == []
    for f in FIXTURES.glob("*.py"):
        assert not any(r.applies_to(_rel(f)) for r in JAX_RULES.values())


# -- the framework, on both engines ----------------------------------------------

VIOLATION = "import time\n\n\ndef now_ms():\n    return time.time() * 1000.0\n"


def _det(eng, path, **kw):
    kw.setdefault("select", ["determinism"])
    kw.setdefault("ignore_scope", True)
    kw.setdefault("baseline", None)
    return eng.run([str(path)], **kw)


def _cli(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def case_violation_fires(eng, cli, tmp):
    f = tmp / "mod.py"
    f.write_text(VIOLATION)
    r = _det(eng, f)
    assert len(r.findings) == 1 and not r.clean
    return _summary(r)


def case_same_line_suppression(eng, cli, tmp):
    f = tmp / "mod.py"
    f.write_text(VIOLATION.replace(
        "time.time() * 1000.0", "time.time() * 1000.0  # fslint: disable=determinism"))
    r = _det(eng, f)
    assert r.findings == [] and r.unused_suppressions == [] and r.clean
    return _summary(r)


def case_comment_above_suppression(eng, cli, tmp):
    f = tmp / "mod.py"
    f.write_text(VIOLATION.replace(
        "    return time.time", "    # fslint: disable=determinism\n    return time.time"))
    r = _det(eng, f)
    assert r.findings == [] and r.unused_suppressions == []
    return _summary(r)


def case_unused_suppression(eng, cli, tmp):
    f = tmp / "mod.py"
    f.write_text("X = 1  # fslint: disable=determinism\n")
    r = _det(eng, f)
    assert r.findings == [] and not r.clean
    assert [s.rules for s in r.unused_suppressions] == [("determinism",)]
    return _summary(r)


def case_unselected_rule_suppression(eng, cli, tmp):
    f = tmp / "mod.py"
    f.write_text("X = 1  # fslint: disable=determinism\n")
    r = eng.run([str(f)], select=["wire-format"], ignore_scope=True, baseline=None)
    assert r.unused_suppressions == [] and r.clean
    return _summary(r)


def case_suppression_covers_only_its_rule(eng, cli, tmp):
    f = tmp / "mod.py"
    f.write_text(VIOLATION.replace(
        "time.time() * 1000.0", "time.time() * 1000.0  # fslint: disable=wire-format"))
    r = eng.run([str(f)], select=["determinism", "wire-format"], ignore_scope=True,
                baseline=None)
    assert len(r.findings) == 1 and len(r.unused_suppressions) == 1
    return _summary(r)


def case_baseline_subtracts(eng, cli, tmp):
    f = tmp / "mod.py"
    f.write_text(VIOLATION)
    first = _det(eng, f)
    baseline = tmp / "baseline.json"
    baseline.write_text(json.dumps({"version": 1, "findings": [
        {"rule": x.rule, "path": x.path, "message": x.message} for x in first.findings]}))
    second = _det(eng, f, baseline=baseline)
    assert len(first.findings) == 1 and second.findings == [] and second.clean
    return _summary(first), _summary(second)


def case_stale_baseline(eng, cli, tmp):
    f = tmp / "mod.py"
    f.write_text("X = 1\n")
    baseline = tmp / "baseline.json"
    baseline.write_text(json.dumps({"version": 1, "findings": [
        {"rule": "determinism", "path": "gone.py", "message": "x"}]}))
    r = _det(eng, f, baseline=baseline)
    assert r.stale_baseline == ["determinism::gone.py::x"] and not r.clean
    return _summary(r)


def case_committed_baseline_is_empty(eng, cli, tmp):
    data = json.loads(eng.DEFAULT_BASELINE.read_text())
    assert data["findings"] == []
    return data


def case_fixture_corpus_excluded(eng, cli, tmp):
    (subtree,) = eng.EXCLUDED_SUBTREES
    walked = eng.iter_python_files(eng.REPO_ROOT, [str(Path(subtree).parent)])
    assert walked
    assert not any(_rel(p).startswith(subtree + "/") for p in walked)
    target = sorted((eng.REPO_ROOT / subtree).glob("*_bug.py"))[0]
    assert eng.iter_python_files(eng.REPO_ROOT, [str(target)]) == [target]
    return True


def case_unparseable_file(eng, cli, tmp):
    f = tmp / "broken.py"
    f.write_text("def broken(:\n")
    r = _det(eng, f)
    assert [x.rule for x in r.findings] == ["parse-error"]
    return _summary(r)


def case_unknown_rule_raises(eng, cli, tmp):
    with pytest.raises(KeyError, match="unknown rule") as e:
        eng.run(select=["no-such-rule"], baseline=None)
    return str(e.value).split(" (known")[0]


def case_cli_clean_file(eng, cli, tmp):
    rc, out, _ = _cli(cli, ["--select=determinism", "--no-scope", "--baseline=",
                            str(JAX_FIXTURES / "determinism_fixed.py")])
    assert rc == 0 and "0 finding(s)" in out
    return rc, out


def case_cli_renders_findings(eng, cli, tmp):
    rc, out, _ = _cli(cli, ["--select=determinism", "--no-scope", "--baseline=",
                            str(JAX_FIXTURES / "determinism_bug.py")])
    assert rc == 1 and "[determinism]" in out and "determinism_bug.py" in out
    return rc, out


def case_cli_json_shape(eng, cli, tmp):
    rc, out, _ = _cli(cli, ["--format=json", "--select=wire-format", "--no-scope",
                            "--baseline=", str(JAX_FIXTURES / "wire_bug.py")])
    payload = json.loads(out)
    assert rc == 1 and payload["clean"] is False and payload["files_scanned"] == 1
    assert payload["rules_run"] == ["wire-format"] and len(payload["findings"]) == 3
    for finding in payload["findings"]:
        assert set(finding) == {"rule", "path", "line", "col", "message"}
    return rc, payload


def case_cli_unknown_rule(eng, cli, tmp):
    rc, _, err = _cli(cli, ["--select=no-such-rule"])
    assert rc == 2 and "unknown rule" in err
    return rc


def case_cli_write_baseline(eng, cli, tmp):
    baseline = tmp / "baseline.json"
    bug = str(JAX_FIXTURES / "determinism_bug.py")
    args = ["--select=determinism", "--no-scope", "--baseline", str(baseline)]
    rc1, _, _ = _cli(cli, args + ["--write-baseline", bug])
    written = json.loads(baseline.read_text())
    rc2, out, _ = _cli(cli, args + [bug])
    assert (rc1, rc2) == (0, 0) and len(written["findings"]) == 3
    assert "0 finding(s)" in out
    return written, out


def case_cli_list_rules(eng, cli, tmp):
    rc, out, _ = _cli(cli, ["--list-rules"])
    rules = JAX_RULES if eng is jax_engine else PORT_RULES
    assert rc == 0 and all(name in out for name in rules)
    return rc


FRAMEWORK = {name[5:]: fn for name, fn in dict(globals()).items()
             if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(FRAMEWORK))
def test_framework_case_is_the_same_in_both_engines(case, tmp_path):
    """Each case of the JAX framework tests run on both engines, in the same
    directory, one after the other: each passes its own assertions and the
    two give the same result."""
    results = {name: FRAMEWORK[case](eng, cli, tmp_path)
               for name, (eng, cli) in ENGINES.items()}
    assert results["port"] == results["jax"]


@pytest.mark.proc
def test_cli_select_in_a_fresh_interpreter():
    """The port's CLI registers its rules before it reads ``--select``; the
    JAX package's, started fresh, calls every rule unknown (exit 2)."""
    bug = str(JAX_FIXTURES / "determinism_bug.py")
    env_args = dict(cwd=ROOT, capture_output=True, text=True, timeout=60,
                    env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    runs = {pkg: subprocess.run(
        [sys.executable, "-m", f"{pkg}.analysis", "--select=determinism", "--no-scope",
         "--baseline=", bug], **env_args) for pkg in ("repro", "repro_torch")}
    assert runs["repro_torch"].returncode == 1
    assert "[determinism]" in runs["repro_torch"].stdout
    assert runs["repro"].returncode == 2
    assert "unknown rule 'determinism'" in runs["repro"].stderr


# -- the dogfood gate ------------------------------------------------------------


def test_default_run_over_the_port_is_clean():
    """``python -m repro_torch.analysis``: every rule on its scope, the
    committed (empty) baseline, suppression and baseline hygiene."""
    result = port_engine.run()
    problems = (
        [f.render() for f in result.findings]
        + [f"{s.path}:{s.line}: unused suppression {s.rules}"
           for s in result.unused_suppressions]
        + [f"stale baseline: {fp}" for fp in result.stale_baseline]
    )
    assert result.clean, "\n".join(problems)
    assert result.files_scanned > 100
    assert len(result.rules_run) == 8


@pytest.mark.proc
def test_checker_and_report_import_neither_torch_nor_jax_nor_repro():
    probe = ("import runpy, sys; sys.modules['jax'] = sys.modules['torch'] = None\n"
             "import repro_torch.analysis.__main__, repro_torch.analysis.rules\n"
             "from repro_torch.analysis import run\n"
             "r = run()\n"
             "report = runpy.run_path('scripts/render_experiments_torch.py', "
             "run_name='probe')\n"
             "assert report['dryrun_tables']({})['ERRORS'] == '(none)'\n"
             "bad = sorted(k for k in sys.modules if k == 'repro' "
             "or k.startswith(('repro.', 'numpy', 'torch.', 'jax.')))\n"
             "print(r.clean, bad)\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=60,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True []"


# -- the dry-run report ----------------------------------------------------------


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"_report_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reports():
    return (_load(ROOT / "scripts" / "render_experiments.py"),
            _load(ROOT / "scripts" / "render_experiments_torch.py"))


def _cell(arch, shape, mesh, kind, peak_gib, mu=1):
    return {"arch": arch, "shape": shape, "mesh": mesh, "kind": kind,
            "microbatches": mu, "memory": {"peak_bytes_per_dev": int(peak_gib * 2**30)},
            "roofline": {"compute_s": 0.0123, "memory_s": 0.0456, "collective_s": 0.0007,
                         "dominant": "memory", "useful_ratio": 0.8125}}


RESULTS = {
    "gemma-2b|train_4k|single": _cell("gemma-2b", "train_4k", "single", "train", 10.5, 4),
    "phi3-medium-14b|prefill_32k|single": _cell("phi3-medium-14b", "prefill_32k",
                                                "single", "prefill", 40.25),
    "deepseek-v3-671b|train_4k|single": _cell("deepseek-v3-671b", "train_4k", "single",
                                              "train", 96.0, 8),
    "gemma-2b|train_4k|multi": _cell("gemma-2b", "train_4k", "multi", "train", 6.0, 2),
    "qwen1.5-4b|long_500k|-": {"skip": True},
    "zamba2-7b|decode_32k|multi": {"error": "zamba2-7b|decode_32k|multi: exit 1: boom"},
}


def test_report_tables_are_the_references_but_the_fits_column(reports):
    ref, port = reports
    want, got = ref.dryrun_tables(RESULTS), port.dryrun_tables(RESULTS)
    assert set(got) == set(want)
    for name in want:
        if name != "ROOFLINE_SINGLE":
            assert got[name] == want[name], name
    rows_w = [r.split(" | ") for r in want["ROOFLINE_SINGLE"].splitlines()]
    rows_g = [r.split(" | ") for r in got["ROOFLINE_SINGLE"].splitlines()]
    fits = rows_w[0].index("fits v5e")
    assert rows_g[0][fits] == "fits H100"
    assert [r[:fits] + r[fits + 1:] for r in rows_g] == [
        r[:fits] + r[fits + 1:] for r in rows_w]
    by_arch = {r[0].strip("| "): (r[fits - 1], r[fits]) for r in rows_g[2:]}
    assert by_arch == {"deepseek-v3-671b": ("96.00", "N"), "gemma-2b": ("10.50", "y"),
                       "phi3-medium-14b": ("40.25", "y")}
    assert [r[fits] for r in rows_w[2:]] == ["N", "y", "N"]
    assert port.H100_HBM == 80 * 2**30


def test_report_puts_a_mesh_shape_cell_in_the_roofline_table(reports):
    _, port = reports
    tables = port.dryrun_tables({"gemma-2b|train_4k|1x1": _cell(
        "gemma-2b", "train_4k", "1x1", "train", 46.9)})
    assert tables["ROOFLINE_SINGLE"].splitlines()[2].startswith("| gemma-2b | train_4k |")
    assert tables["DRYRUN_MULTI"].count("\n") == 1


@pytest.mark.parametrize("missing", ["results", "doc", "marker"])
def test_report_raises_on_a_missing_input(reports, tmp_path, missing):
    _, port = reports
    results, doc = tmp_path / "dryrun.json", tmp_path / "EXPERIMENTS.md"
    blocks = port.dryrun_tables({})
    text = "".join(f"<!-- BEGIN:{k} -->\nold\n<!-- END:{k} -->\n" for k in blocks)
    if missing != "results":
        results.write_text(json.dumps(RESULTS))
    if missing != "doc":
        doc.write_text(text.replace("BEGIN:ERRORS", "BEGIN:NOTHING")
                       if missing == "marker" else text)
    before = doc.read_text() if doc.exists() else None
    error = ValueError if missing == "marker" else FileNotFoundError
    with pytest.raises(error):
        port.main(["--results", str(results), "--doc", str(doc)])
    assert (doc.read_text() if doc.exists() else None) == before


@pytest.mark.proc
def test_report_renders_a_port_dryrun_cell(reports, tmp_path):
    """A reduced gemma-2b train cell of the port's dry-run on a 1x1 mesh,
    through its CLI's ``--out``, rendered into a document's marked blocks;
    prose outside the markers stays."""
    pytest.importorskip("torch")
    from repro_torch.launch import dryrun

    _, port = reports
    results, doc = tmp_path / "dryrun.json", tmp_path / "EXPERIMENTS.md"
    dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k", "--mesh-shape", "1x1",
                 "--reduced", "--optimizer", "float32", "--out", str(results)])
    cell = json.loads(results.read_text())["gemma-2b|train_4k|1x1"]
    assert "error" not in cell
    names = list(port.dryrun_tables({}))
    doc.write_text("# prose\n" + "".join(
        f"<!-- BEGIN:{k} -->\nold\n<!-- END:{k} -->\nkept {k}\n" for k in names))
    port.main(["--results", str(results), "--doc", str(doc)])
    text = doc.read_text()
    assert "old" not in text and text.startswith("# prose\n")
    assert all(f"kept {k}" in text for k in names)
    row = next(ln for ln in text.splitlines() if ln.startswith("| gemma-2b |"))
    peak = cell["memory"]["peak_bytes_per_dev"] / 2**30
    assert row.split(" | ")[1:3] == ["train_4k", "train"]
    assert f"| {peak:.2f} | y | 1 |" in row
    assert "single-pod cells compiled: **1**" in text
