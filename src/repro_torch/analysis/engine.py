"""fslint engine: file walking, rule dispatch, suppressions, baseline.

The port's copy of the JAX package's ``repro/analysis/engine.py``, run over
the port's own tree.  Stdlib-only by design: nothing in
``repro_torch.analysis`` imports torch, numpy, jax or anything of the JAX
package, so the checker runs anywhere a bare CPython runs, before any
dependency is installed.

Pipeline per run:

1. Walk the requested roots for ``*.py`` files (skipping ``__pycache__``,
   hidden directories, ``results/``, and the deliberately-broken fixture
   corpus under ``tests/torch_analysis_fixtures``).  The default roots are
   the port's tree: ``src/repro_torch``, the ``*_torch.py`` scripts and
   examples, the ``test_torch_*.py`` tests and ``chip_smoke.py``; a root
   holding a glob pattern expands to the files it matches.
2. Pre-pass: build a ``ProjectContext`` over ALL scanned files — the
   cross-file facts rules need (frozen dataclass field sets for the
   frozen-stats rule).  The JAX engine also collected ``donate_argnums``
   positions for its donation rule; the port's counterpart,
   ``device-pointer``, judges each ``.data_ptr()`` inside its own function
   and needs no cross-file fact, so that pass is gone.
3. Per file: parse once (AST + tokens), run every rule whose scope matches,
   drop findings suppressed by an inline ``# fslint: disable=<rule>`` on the
   finding's line (or on a comment-only line directly above it).
4. Report unused suppressions — a disable comment whose rule ran on the file
   but suppressed nothing is dead weight that will hide a future regression,
   so it fails the run just like a finding.
5. Subtract the baseline (committed at
   ``src/repro_torch/analysis/baseline.json``, EMPTY — the port owes zero
   findings; the mechanism exists so a future emergency can land with a
   deliberate, visible debt).  Baseline entries that no longer match
   anything are reported as stale: the debt was paid, delete the entry.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
import tokenize
from pathlib import Path
from typing import Iterable

from .registry import Rule, active_rules

#: repo root inferred from this file living at src/repro_torch/analysis/engine.py
REPO_ROOT = Path(__file__).resolve().parents[3]
#: the port's tree: its package, its counterparts of the JAX package's
#: scripts, examples and tests, and the chip smoke script
DEFAULT_ROOTS = (
    "src/repro_torch",
    "scripts/*_torch.py",
    "examples/*_torch.py",
    "tests/test_torch_*.py",
    "chip_smoke.py",
)
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"
#: subtrees never scanned: the fixture corpus is deliberately-buggy code
#: (every rule's positive exemplar lives there), and results/ holds
#: generated artifacts
EXCLUDED_PARTS = ("__pycache__", "results")
EXCLUDED_SUBTREES = ("tests/torch_analysis_fixtures",)

_SUPPRESS_RE = re.compile(r"#\s*fslint:\s*disable=([A-Za-z0-9_,\- ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str  # repo-relative posix path
    line: int  # 1-based
    col: int  # 0-based
    message: str

    def fingerprint(self) -> str:
        """Baseline identity: deliberately line-number-free so unrelated
        edits above a baselined finding do not churn the baseline."""
        return f"{self.rule}::{self.path}::{self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: [{self.rule}] {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Suppression:
    """One inline ``# fslint: disable=rule[,rule...]`` comment."""

    path: str
    line: int  # line the comment sits on
    rules: tuple[str, ...]
    covers: tuple[int, ...]  # lines whose findings it silences


class FileContext:
    """Everything a rule may inspect about one file, parsed exactly once."""

    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=rel)
        self.tokens = list(
            tokenize.generate_tokens(io.StringIO(source).readline)
        )

    def finding(self, rule: str, node_or_line, message: str, col: int = 0) -> Finding:
        """Build a Finding anchored at an AST node (preferred) or line no."""
        if isinstance(node_or_line, int):
            line = node_or_line
        else:
            line = getattr(node_or_line, "lineno", 1)
            col = getattr(node_or_line, "col_offset", col)
        return Finding(rule=rule, path=self.rel, line=line, col=col, message=message)


class ProjectContext:
    """Cross-file facts, built in one pre-pass over every scanned file.

    ``frozen_dataclasses``: dataclass name -> frozenset of field names, for
    every ``@dataclass(frozen=True)`` in the scanned files (on the default
    run, the port's tree) — the frozen-stats rule matches returned dict
    literals against these.
    """

    def __init__(self) -> None:
        self.frozen_dataclasses: dict[str, frozenset[str]] = {}

    # -- collection -----------------------------------------------------------
    def collect(self, ctx: FileContext) -> None:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef) and _is_frozen_dataclass(node):
                fields = frozenset(
                    t.target.id
                    for t in node.body
                    if isinstance(t, ast.AnnAssign) and isinstance(t.target, ast.Name)
                )
                if fields:
                    self.frozen_dataclasses[node.name] = fields


def _is_frozen_dataclass(node: ast.ClassDef) -> bool:
    for deco in node.decorator_list:
        call = deco if isinstance(deco, ast.Call) else None
        if call is None:
            continue
        fn = call.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
        if name != "dataclass":
            continue
        for kw in call.keywords:
            if (
                kw.arg == "frozen"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
            ):
                return True
    return False


# -- suppressions -------------------------------------------------------------


def parse_suppressions(ctx: FileContext) -> list[Suppression]:
    """Inline disables.  A comment on a code line covers that line; a
    comment standing alone on its own line covers the line below it (for
    statements where appending the pragma would fight the formatter)."""
    out = []
    for tok in ctx.tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = tuple(
            r.strip() for r in m.group(1).split(",") if r.strip()
        )
        line = tok.start[0]
        comment_only = ctx.lines[line - 1].lstrip().startswith("#")
        covers = (line, line + 1) if comment_only else (line,)
        out.append(
            Suppression(path=ctx.rel, line=line, rules=rules, covers=covers)
        )
    return out


# -- baseline -----------------------------------------------------------------


def load_baseline(path: Path) -> list[dict]:
    data = json.loads(path.read_text())
    if not isinstance(data, dict) or "findings" not in data:
        raise SystemExit(f"{path}: baseline must be a JSON object with 'findings'")
    return data["findings"]


def baseline_fingerprints(entries: list[dict]) -> set[str]:
    return {
        f"{e['rule']}::{e['path']}::{e['message']}" for e in entries
    }


# -- walking ------------------------------------------------------------------


def iter_python_files(root: Path, paths: Iterable[str]) -> list[Path]:
    """Walk ``paths`` for ``*.py``.  A path holding a glob pattern
    (``scripts/*_torch.py``) stands for the files and directories it
    matches under ``root``.  Exclusions apply to the WALK only: a file named
    explicitly is always analyzed (that is how the fixture tests point the
    engine at the deliberately-buggy corpus the walk skips)."""
    seen: dict[Path, None] = {}
    for p in _expand(root, paths):
        base = (root / p) if not Path(p).is_absolute() else Path(p)
        if base.is_file():
            seen[base.resolve()] = None
            continue
        for f in sorted(base.rglob("*.py")):
            rel = _relpath(f.resolve(), root)
            parts = Path(rel).parts
            if set(parts) & set(EXCLUDED_PARTS):
                continue
            if any(part.startswith(".") for part in parts):
                continue
            if any(rel.startswith(sub + "/") for sub in EXCLUDED_SUBTREES):
                continue
            seen.setdefault(f.resolve(), None)
    return sorted(seen)


def _expand(root: Path, paths: Iterable[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if any(ch in p for ch in "*?[") and not Path(p).is_absolute():
            out.extend(str(m) for m in sorted(root.glob(p)))
        else:
            out.append(p)
    return out


def _relpath(f: Path, root: Path) -> str:
    try:
        return f.relative_to(root).as_posix()
    except ValueError:
        return f.as_posix()


# -- the run ------------------------------------------------------------------


@dataclasses.dataclass
class RunResult:
    findings: list[Finding]
    unused_suppressions: list[Suppression]
    stale_baseline: list[str]
    files_scanned: int
    rules_run: list[str]

    @property
    def clean(self) -> bool:
        return not (
            self.findings or self.unused_suppressions or self.stale_baseline
        )

    def as_dict(self) -> dict:
        return {
            "clean": self.clean,
            "files_scanned": self.files_scanned,
            "rules_run": self.rules_run,
            "findings": [f.as_dict() for f in self.findings],
            "unused_suppressions": [
                {"path": s.path, "line": s.line, "rules": list(s.rules)}
                for s in self.unused_suppressions
            ],
            "stale_baseline": self.stale_baseline,
        }


def run(
    paths: Iterable[str] | None = None,
    *,
    root: Path | None = None,
    select: Iterable[str] | None = None,
    ignore_scope: bool = False,
    baseline: Path | None = DEFAULT_BASELINE,
) -> RunResult:
    """Analyze ``paths`` (repo-relative; default: the port's tree) and return
    every unsuppressed, unbaselined finding plus suppression/baseline
    hygiene failures."""
    # rule modules register on import; deferred so engine import stays cheap
    from . import rules as _rules  # noqa: F401

    root = root or REPO_ROOT
    rules = active_rules(select)
    files = iter_python_files(root, paths or DEFAULT_ROOTS)

    contexts: list[FileContext] = []
    project = ProjectContext()
    findings: list[Finding] = []
    for f in files:
        rel = _relpath(f, root)
        try:
            ctx = FileContext(f, rel, f.read_text())
        except (SyntaxError, tokenize.TokenError, UnicodeDecodeError) as e:
            findings.append(
                Finding("parse-error", rel, 1, 0, f"cannot parse: {e}")
            )
            continue
        contexts.append(ctx)
        project.collect(ctx)

    unused: list[Suppression] = []
    for ctx in contexts:
        applicable = [
            r for r in rules if ignore_scope or r.applies_to(ctx.rel)
        ]
        if not applicable:
            continue
        raw = []
        for r in applicable:
            raw.extend(r.check(ctx, project))
        sups = parse_suppressions(ctx)
        used: set[int] = set()
        active_names = {r.name for r in applicable}
        for fd in sorted(raw, key=lambda f: (f.line, f.col)):
            hit = next(
                (
                    i
                    for i, s in enumerate(sups)
                    if fd.rule in s.rules and fd.line in s.covers
                ),
                None,
            )
            if hit is None:
                findings.append(fd)
            else:
                used.add(hit)
        for i, s in enumerate(sups):
            # a suppression is dead only relative to rules that actually ran
            # here; --select subsets must not misreport the others as unused
            checkable = [r for r in s.rules if r in active_names]
            if checkable and i not in used:
                unused.append(s)

    stale: list[str] = []
    if baseline is not None and baseline.exists():
        entries = load_baseline(baseline)
        allowed = baseline_fingerprints(entries)
        live = {f.fingerprint() for f in findings}
        findings = [f for f in findings if f.fingerprint() not in allowed]
        stale = sorted(allowed - live)

    return RunResult(
        findings=findings,
        unused_suppressions=unused,
        stale_baseline=stale,
        files_scanned=len(contexts),
        rules_run=[r.name for r in rules],
    )
