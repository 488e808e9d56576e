"""Stepper-purity rules: steppers talk to the world only via work items.

Ported from ``repro/analysis/rules_stepper.py`` as it is; the port's
``core/stepper.py`` keeps the same contract.

``core/stepper.py``'s contract: an executor stepper is a generator that
yields ``ScoreDemand``/``UploadTick``/``VerifyDemand`` and receives
answers via ``send()``. That narrow waist is what lets the
``FleetScheduler`` interleave N steppers, batch their scoring, stretch
their uplink ticks, and route their verification through the shared
``OracleService`` while staying bit-identical to standalone ``drive()``
runs (``tests/test_fleet.py``). A stepper that scores or verifies
directly, mutates module globals, or does host I/O bypasses the waist:
the fleet can no longer reorder or batch it without changing results.

Detection: a function is treated as a stepper iff it yields a direct
``ScoreDemand(...)``/``UploadTick(...)``/``VerifyDemand(...)`` call
somewhere in its own scope (sub-steppers composed with ``yield from``
are visited as their own functions). Purity is enforced over the stepper's whole subtree,
nested helpers included — a closure that scores eagerly is just as
impure as the generator itself.
"""
from __future__ import annotations

import ast
from typing import Iterator, List

from repro_torch.analysis.engine import ModuleInfo, Rule, Violation, register

WORK_ITEMS = {"ScoreDemand", "UploadTick", "VerifyDemand"}

# the scoring substrate a stepper must reach only via `yield ScoreDemand`
SCORING_ATTRS = {"score", "score_crops", "score_demands"}
SCORING_NAMES = {"get_runtime", "set_runtime", "OperatorRuntime",
                 "score_frames"}

# cloud verification a stepper must reach only via `yield VerifyDemand`
# (a direct call bypasses the shared OracleService's slot batching and
# admission control, and pins the stepper to one env's answer path)
VERIFY_ATTRS = {"cloud_verify"}

IO_NAMES = {"open", "print", "input", "breakpoint", "exec", "eval",
            "compile"}
IO_PREFIXES = ("os.", "subprocess.", "shutil.", "socket.", "requests.",
               "urllib.", "http.")
IO_PURE_PREFIXES = ("os.path.",)      # path arithmetic, no effects
PATH_IO_ATTRS = {"write_text", "write_bytes", "read_text", "read_bytes",
                 "unlink", "touch", "mkdir", "rmdir", "rename", "symlink"}


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Nodes in ``fn``'s own scope — nested function bodies excluded."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _work_item_name(call: ast.Call) -> str:
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def is_stepper(fn: ast.AST) -> bool:
    for node in _own_nodes(fn):
        if isinstance(node, ast.Yield) and isinstance(node.value, ast.Call):
            if _work_item_name(node.value) in WORK_ITEMS:
                return True
    return False


def steppers(mod: ModuleInfo) -> Iterator[ast.AST]:
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                is_stepper(node):
            yield node


@register
class StepperDirectScoringRule(Rule):
    id = "STP001"
    name = "stepper-direct-scoring"
    invariant = ("steppers request inference via `yield ScoreDemand` and "
                 "cloud verification via `yield VerifyDemand`; a direct "
                 "OperatorRuntime/QuerySession.score or env.cloud_verify "
                 "call bypasses the FleetScheduler's cross-query batching "
                 "(ScoreBatcher / OracleService) and breaks the drive()-"
                 "equivalence contract in core/stepper.py")

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        for fn in steppers(mod):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                if isinstance(func, ast.Attribute) and \
                        func.attr in SCORING_ATTRS:
                    yield self.violation(
                        mod, node,
                        f"stepper `{fn.name}` calls `.{func.attr}(...)` "
                        "directly; yield a ScoreDemand and let "
                        "drive() or the FleetScheduler answer it")
                elif isinstance(func, ast.Attribute) and \
                        func.attr in VERIFY_ATTRS:
                    yield self.violation(
                        mod, node,
                        f"stepper `{fn.name}` calls `.{func.attr}(...)` "
                        "directly; yield a VerifyDemand and let "
                        "drive() or the shared OracleService answer it")
                else:
                    q = mod.qualname(func)
                    last = q.rsplit(".", 1)[-1] if q else ""
                    if last in SCORING_NAMES:
                        yield self.violation(
                            mod, node,
                            f"stepper `{fn.name}` reaches the scoring "
                            f"substrate via `{last}`; steppers must "
                            "run alike under drive() and the fleet (yield "
                            "work items)")


@register
class StepperGlobalMutationRule(Rule):
    id = "STP002"
    name = "stepper-global-mutation"
    invariant = ("steppers keep all state in locals/closure so N "
                 "interleaved queries cannot observe each other; a "
                 "`global` write makes results depend on fleet "
                 "interleaving order")

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        for fn in steppers(mod):
            for node in ast.walk(fn):
                if isinstance(node, ast.Global):
                    yield self.violation(
                        mod, node,
                        f"stepper `{fn.name}` declares "
                        f"`global {', '.join(node.names)}`; module "
                        "state shared across interleaved queries breaks "
                        "bit-equivalence (keep state per-query)")


@register
class StepperIORule(Rule):
    id = "STP003"
    name = "stepper-io"
    invariant = ("steppers touch the outside world only via yielded "
                 "work items (the bit-equivalence waist in "
                 "core/stepper.py); host I/O is invisible to the "
                 "scheduler and unreproducible between drive() and "
                 "the fleet")

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        for fn in steppers(mod):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                q = mod.qualname(func)
                if isinstance(func, ast.Name) and func.id in IO_NAMES:
                    yield self.violation(
                        mod, node,
                        f"stepper `{fn.name}` performs host I/O via "
                        f"`{func.id}(...)`; report through Progress or "
                        "move the effect out of the stepper")
                elif q and q.startswith(IO_PREFIXES) and \
                        not q.startswith(IO_PURE_PREFIXES):
                    yield self.violation(
                        mod, node,
                        f"stepper `{fn.name}` calls `{q}` (host "
                        "side effect); steppers must only yield work "
                        "items")
                elif isinstance(func, ast.Attribute) and \
                        func.attr in PATH_IO_ATTRS:
                    yield self.violation(
                        mod, node,
                        f"stepper `{fn.name}` does filesystem I/O via "
                        f"`.{func.attr}(...)`; steppers must only "
                        "yield work items")
