"""Analysis engine: rule registry, per-path config, waivers, reports.

Ported from ``repro/analysis/engine.py`` with its behaviour unchanged;
only the default waiver file differs (``analysis-waivers-torch.txt``,
the port's own, beside the JAX package's ``analysis-waivers.txt``).

The substrate's guarantees (fleet-vs-standalone bit-equivalence, cached
per-arch jit dispatch) rest on conventions — simulated-clock
discipline, seeded RNG streams, steppers that only touch the world via
yielded work items, one trace per arch signature — that no type checker
enforces. This package machine-checks them: each :class:`Rule` is an
AST check grounded in one such invariant (see ``docs/ANALYSIS.md`` for
the full table), the engine walks files, applies the per-path config
(which rule families run where), honors the explicit waiver file and
inline ``# noqa`` comments, and renders text/JSON reports.

Everything here is stdlib-only so ``python -m repro_torch.analysis``
runs in any environment (it needs neither torch nor jax).
"""
from __future__ import annotations

import ast
import fnmatch
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# violations and waivers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str               # repo-relative posix path
    line: int
    col: int                # 0-based (rendered 1-based)
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1} {self.rule} " \
               f"{self.message}"


@dataclass
class Waiver:
    """One line of the waiver file: ``<path-glob> <rule-glob> <reason>``.

    Globs are ``fnmatch``-style and ``*`` crosses ``/`` — so
    ``src/repro/launch/*`` waives the whole subtree. Every waiver must
    carry a one-line justification; unused waivers are reported so the
    file cannot silently rot.
    """
    pattern: str
    rule: str
    reason: str
    used: bool = False

    def matches(self, v: Violation) -> bool:
        return (fnmatch.fnmatchcase(v.path, self.pattern) and
                fnmatch.fnmatchcase(v.rule, self.rule))


def load_waivers(path) -> List[Waiver]:
    waivers: List[Waiver] = []
    text = Path(path).read_text()
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(None, 2)
        if len(parts) < 3:
            raise ValueError(
                f"{path}:{ln}: waiver needs '<path-glob> <rule-glob> "
                f"<justification>', got: {line!r}")
        waivers.append(Waiver(parts[0], parts[1], parts[2]))
    return waivers


# ---------------------------------------------------------------------------
# module model shared by all rules
# ---------------------------------------------------------------------------


class ModuleInfo:
    """Parsed module + the name-resolution helpers every rule needs."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self.imports = self._import_aliases(self.tree)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent

    @staticmethod
    def _import_aliases(tree: ast.AST) -> Dict[str, str]:
        """Local binding -> dotted origin (``np`` -> ``numpy``,
        ``perf_counter`` -> ``time.perf_counter``)."""
        aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
                    if a.asname:
                        aliases[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom):
                mod = ("." * node.level) + (node.module or "")
                for a in node.names:
                    if a.name == "*":
                        continue
                    aliases[a.asname or a.name] = f"{mod}.{a.name}"
        return aliases

    def qualname(self, node: ast.AST) -> Optional[str]:
        """Dotted origin of a Name/Attribute chain, import-resolved;
        None for anything more dynamic."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.imports.get(node.id, node.id))
        return ".".join(reversed(parts))

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------

RULES: Dict[str, "Rule"] = {}
WAIVER_FILE = "analysis-waivers-torch.txt"


def register(cls):
    """Class decorator: instantiate and add to the global registry."""
    rule = cls()
    if rule.id in RULES:
        raise ValueError(f"duplicate rule id: {rule.id}")
    RULES[rule.id] = rule
    return cls


class Rule:
    """One machine-checked invariant.

    ``default_paths`` are fnmatch globs (``*`` crosses ``/``) selecting
    where the rule applies; the per-path config can override either way.
    ``invariant`` names the substrate guarantee the rule protects — it
    is what a reader of a violation sees, so it should point at the
    contract (module/test) that breaks when the rule is ignored.
    """

    id: str = ""
    name: str = ""
    invariant: str = ""
    default_paths: Tuple[str, ...] = ("*",)

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        raise NotImplementedError

    def violation(self, mod: ModuleInfo, node: ast.AST,
                  message: str) -> Violation:
        return Violation(self.id, mod.path, getattr(node, "lineno", 1),
                         getattr(node, "col_offset", 0), message)


# ---------------------------------------------------------------------------
# per-path configuration
# ---------------------------------------------------------------------------

# (path-glob, rule-glob, enabled) — applied in order on top of each
# rule's default_paths; the LAST matching entry wins for a given rule.
DEFAULT_CONFIG: List[Tuple[str, str, bool]] = [
    # benches/tests measure host wall-clock by design and construct jit
    # functions freely in fixtures; determinism/tracing rules are about
    # the simulated-time substrate under src/.
    ("benchmarks/*", "DET*", False),
    ("tests/*", "DET*", False),
    ("tests/*", "TRC*", False),
    ("examples/*", "DET*", False),
    ("examples/*", "TRC*", False),
    # package __init__ modules re-export names on purpose
    ("*__init__.py", "GEN001", False),
]


def rule_applies(rule: Rule, path: str,
                 config: Sequence[Tuple[str, str, bool]]) -> bool:
    on = any(fnmatch.fnmatchcase(path, pat) for pat in rule.default_paths)
    for pat, rglob, enabled in config:
        if fnmatch.fnmatchcase(path, pat) and \
                fnmatch.fnmatchcase(rule.id, rglob):
            on = enabled
    return on


# ---------------------------------------------------------------------------
# running
# ---------------------------------------------------------------------------


@dataclass
class Report:
    violations: List[Violation] = field(default_factory=list)
    waived: List[Tuple[Violation, str]] = field(default_factory=list)
    unused_waivers: List[Waiver] = field(default_factory=list)
    checked_files: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "checked_files": self.checked_files,
            "violations": [vars(v) for v in self.violations],
            "waived": [{**vars(v), "reason": r} for v, r in self.waived],
            "unused_waivers": [
                {"pattern": w.pattern, "rule": w.rule, "reason": w.reason}
                for w in self.unused_waivers],
        }

    def render_text(self, *, show_waived: bool = False) -> str:
        out: List[str] = []
        for v in self.violations:
            out.append(v.render())
        if show_waived:
            for v, reason in self.waived:
                out.append(f"{v.render()} [waived: {reason}]")
        for w in self.unused_waivers:
            out.append(f"note: unused waiver {w.pattern} {w.rule} "
                       f"({w.reason})")
        by_rule: Dict[str, int] = {}
        for v in self.violations:
            by_rule[v.rule] = by_rule.get(v.rule, 0) + 1
        summary = ", ".join(f"{r}: {n}" for r, n in sorted(by_rule.items()))
        out.append(
            f"{self.checked_files} file(s) checked: "
            f"{len(self.violations)} violation(s)"
            + (f" [{summary}]" if summary else "")
            + (f", {len(self.waived)} waived" if self.waived else ""))
        return "\n".join(out)


def _noqa_rules(line: str) -> Optional[set]:
    """Rules silenced by an inline ``# noqa`` comment on ``line``:
    ``None`` if no noqa, empty set = all rules, else the named ones."""
    idx = line.find("# noqa")
    if idx < 0:
        return None
    rest = line[idx + len("# noqa"):]
    if rest.startswith(":"):
        names = rest[1:].split("#")[0]
        ids = {p.strip() for p in names.replace(",", " ").split()}
        return {i for i in ids if i} or set()
    return set()


def _select_rules(rule_globs: Optional[Sequence[str]]) -> List[Rule]:
    if not rule_globs:
        return list(RULES.values())
    picked = [r for rid, r in RULES.items()
              if any(fnmatch.fnmatchcase(rid, g) for g in rule_globs)]
    if not picked:
        raise ValueError(f"no rules match {list(rule_globs)!r}")
    return picked


def check_source(source: str, path: str, *,
                 config: Optional[Sequence[Tuple[str, str, bool]]] = None,
                 waivers: Sequence[Waiver] = (),
                 rules: Optional[Sequence[str]] = None,
                 report: Optional[Report] = None) -> List[Violation]:
    """Run all applicable rules on one module's source; returns the
    UNWAIVED violations (waived ones are recorded on ``report``)."""
    config = DEFAULT_CONFIG if config is None else config
    report = report if report is not None else Report()
    try:
        mod = ModuleInfo(path, source)
    except SyntaxError as e:
        v = Violation("PARSE000", path, e.lineno or 1, (e.offset or 1) - 1,
                      f"syntax error: {e.msg}")
        report.violations.append(v)
        return [v]
    found: List[Violation] = []
    seen = set()
    for rule in _select_rules(rules):
        if not rule_applies(rule, path, config):
            continue
        for v in rule.check(mod):
            if v in seen:       # nested steppers are scanned twice
                continue
            seen.add(v)
            found.append(v)
    found.sort(key=lambda v: (v.line, v.col, v.rule))
    out: List[Violation] = []
    for v in found:
        noqa = _noqa_rules(mod.line_text(v.line))
        if noqa is not None and (not noqa or v.rule in noqa):
            report.waived.append((v, "inline noqa"))
            continue
        waiver = next((w for w in waivers if w.matches(v)), None)
        if waiver is not None:
            waiver.used = True
            report.waived.append((v, waiver.reason))
            continue
        report.violations.append(v)
        out.append(v)
    return out


def collect_files(paths: Sequence[str], root: Path) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        fp = (root / p) if not os.path.isabs(p) else Path(p)
        if fp.is_file() and fp.suffix == ".py":
            files.append(fp)
        elif fp.is_dir():
            files.extend(f for f in sorted(fp.rglob("*.py"))
                         if "__pycache__" not in f.parts and
                         not any(part.startswith(".") for part in f.parts))
        else:
            raise FileNotFoundError(f"no such file or directory: {p}")
    uniq: List[Path] = []
    seen = set()
    for f in files:
        if f not in seen:
            seen.add(f)
            uniq.append(f)
    return uniq


def run_paths(paths: Sequence[str], *, root: Optional[Path] = None,
              config: Optional[Sequence[Tuple[str, str, bool]]] = None,
              waiver_file: Optional[Path] = None,
              rules: Optional[Sequence[str]] = None) -> Report:
    """Analyze files/directories; returns the aggregate :class:`Report`.

    ``root`` anchors repo-relative paths (default: cwd). The waiver
    file defaults to ``<root>/analysis-waivers-torch.txt`` when present.
    """
    root = Path(root) if root is not None else Path.cwd()
    if waiver_file is None:
        cand = root / WAIVER_FILE
        waiver_file = cand if cand.exists() else None
    waivers = load_waivers(waiver_file) if waiver_file else []
    report = Report()
    for f in collect_files(paths, root):
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        check_source(f.read_text(), rel, config=config, waivers=waivers,
                     rules=rules, report=report)
        report.checked_files += 1
    report.unused_waivers = [w for w in waivers if not w.used]
    report.violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return report
