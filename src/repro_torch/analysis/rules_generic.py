"""Generic hygiene rules — the local mirror of the CI ruff gate.

Ported from ``repro/analysis/rules_generic.py`` as it is.

CI runs ``ruff check`` (config in ``pyproject.toml``) on every PR; this
module re-implements the finding classes we gate on with stdlib ``ast``
so ``python -m repro_torch.analysis`` reproduces them on machines where ruff
isn't installed (the analysis suite has zero dependencies). Rule ids
map to their ruff cousins:

  GEN001  unused import                (F401)
  GEN002  mutable default argument     (B006)
  GEN003  builtin shadowed by binding  (A001/A002)
  GEN004  ambiguous single-letter name (E741)
  GEN005  redefinition of unused def   (F811)
  GEN006  local assigned but never used (F841)

These are deliberately conservative approximations (no false positives
on this tree is the bar; ruff remains the authority in CI).
"""
from __future__ import annotations

import ast
import builtins
from typing import Dict, Iterator, List, Set, Tuple

from repro_torch.analysis.engine import ModuleInfo, Rule, Violation, register

MUTABLE_DEFAULTS = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.SetComp,
                    ast.DictComp)
MUTABLE_CTORS = {"list", "dict", "set", "bytearray", "defaultdict",
                 "OrderedDict", "Counter", "deque"}
AMBIGUOUS = {"l", "I", "O"}
SHADOWABLE = (set(dir(builtins)) -
              {"_", "__name__", "__doc__", "__spec__", "__loader__",
               "__package__", "__debug__", "__build_class__",
               "__import__", "copyright", "credits", "license"})


def _function_scopes(tree: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _bound_names(node: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
    """(name, node) pairs this statement binds (assign/for/with/args)."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        for a in (node.args.posonlyargs + node.args.args +
                  node.args.kwonlyargs):
            yield a.arg, a
        for a in (node.args.vararg, node.args.kwarg):
            if a is not None:
                yield a.arg, a
    elif isinstance(node, ast.Lambda):
        for a in (node.args.posonlyargs + node.args.args +
                  node.args.kwonlyargs):
            yield a.arg, a
    elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
        yield node.id, node
    elif isinstance(node, (ast.Global, ast.Nonlocal)):
        for n in node.names:
            yield n, node


@register
class UnusedImportRule(Rule):
    id = "GEN001"
    name = "unused-import"
    invariant = ("imports document real dependencies; stale ones hide "
                 "layering violations and slow cold start (ruff F401)")

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        bindings: List[Tuple[str, ast.AST, str]] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    name = a.asname or a.name.split(".")[0]
                    bindings.append((name, node, a.name))
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    bindings.append((a.asname or a.name, node, a.name))
        if not bindings:
            return
        used: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Name) and \
                    isinstance(node.ctx, ast.Load):
                used.add(node.id)
            elif isinstance(node, ast.Constant) and \
                    isinstance(node.value, str):
                # covers __all__ entries and string annotations
                used.add(node.value)
        for name, node, original in bindings:
            if name not in used and name != "_":
                yield self.violation(
                    mod, node, f"`{original}` imported but unused")


@register
class MutableDefaultRule(Rule):
    id = "GEN002"
    name = "mutable-default-arg"
    invariant = ("default values are evaluated once and shared across "
                 "calls; a mutable default leaks state between "
                 "invocations (ruff B006)")

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        for fn in _function_scopes(mod.tree):
            for default in (list(fn.args.defaults) +
                            [d for d in fn.args.kw_defaults
                             if d is not None]):
                bad = isinstance(default, MUTABLE_DEFAULTS)
                if not bad and isinstance(default, ast.Call) and \
                        isinstance(default.func, ast.Name):
                    bad = default.func.id in MUTABLE_CTORS
                if bad:
                    yield self.violation(
                        mod, default,
                        f"mutable default argument in `{fn.name}`; "
                        "default to None and create inside the body "
                        "(or use a tuple/frozenset)")


@register
class BuiltinShadowRule(Rule):
    id = "GEN003"
    name = "builtin-shadow"
    invariant = ("rebinding a builtin changes behavior at a distance "
                 "for the rest of the scope (ruff A001/A002)")

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            for name, at in _bound_names(node):
                if name not in SHADOWABLE:
                    continue
                # class attributes live in the class namespace and don't
                # shadow builtins for readers (ruff A001/A002 semantics)
                scope = node
                while scope in mod.parents:
                    scope = mod.parents[scope]
                    if isinstance(scope, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.Lambda)):
                        break
                    if isinstance(scope, ast.ClassDef):
                        scope = None
                        break
                if scope is None:
                    continue
                yield self.violation(
                    mod, at,
                    f"binding `{name}` shadows the builtin; pick a "
                    "non-colliding name")


@register
class AmbiguousNameRule(Rule):
    id = "GEN004"
    name = "ambiguous-name"
    invariant = ("`l`, `I`, `O` are typographically ambiguous with "
                 "1/0 (ruff E741)")

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            for name, at in _bound_names(node):
                if name in AMBIGUOUS:
                    yield self.violation(
                        mod, at,
                        f"ambiguous variable name `{name}`")


@register
class DuplicateDefRule(Rule):
    id = "GEN005"
    name = "duplicate-def"
    invariant = ("a redefinition silently discards the first body "
                 "(ruff F811)")

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        scopes: List[List[ast.stmt]] = [mod.tree.body]
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                scopes.append(node.body)
        for body in scopes:
            seen: Dict[str, ast.AST] = {}
            for stmt in body:
                if not isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef)):
                    continue
                # @property/@x.setter and @overload pairs are legitimate
                if getattr(stmt, "decorator_list", None):
                    continue
                if stmt.name in seen:
                    yield self.violation(
                        mod, stmt,
                        f"`{stmt.name}` redefined (first definition at "
                        f"line {seen[stmt.name].lineno} is dead)")
                seen[stmt.name] = stmt


@register
class UnusedLocalRule(Rule):
    id = "GEN006"
    name = "unused-local"
    invariant = ("a local assigned and never read is dead weight or a "
                 "bug (ruff F841)")

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        for fn in _function_scopes(mod.tree):
            loads: Set[str] = set()
            escaped: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Name) and \
                        isinstance(node.ctx, ast.Load):
                    loads.add(node.id)
                elif isinstance(node, (ast.Global, ast.Nonlocal)):
                    escaped.update(node.names)
                elif isinstance(node, ast.AugAssign) and \
                        isinstance(node.target, ast.Name):
                    loads.add(node.target.id)
            own: List[ast.AST] = []
            stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
            while stack:
                node = stack.pop()
                own.append(node)
                # class bodies are their own namespace (attrs, not locals)
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda, ast.ClassDef)):
                    continue
                stack.extend(ast.iter_child_nodes(node))
            for node in own:
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and \
                            not tgt.id.startswith("_") and \
                            tgt.id not in loads and \
                            tgt.id not in escaped:
                        yield self.violation(
                            mod, tgt,
                            f"local `{tgt.id}` in `{fn.name}` is "
                            "assigned but never used")
