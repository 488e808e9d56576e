"""Determinism rules: simulated-time code must not read ambient state.

Ported from ``repro/analysis/rules_determinism.py`` (DET001, DET002 as
they are), with one rule of the port's own: DET003, every ``torch``
draw under ``src/repro_torch`` takes an explicit ``generator=``.

The substrate's headline guarantee — a fleet run is bit-identical to
the same queries run standalone (``tests/test_fleet.py``), and a seeded
rerun is bit-identical to the first — holds only because every clock is
simulated (``UploadTick`` durations from the hardware cost models) and
every random draw derives from spec seeds (``VideoSpec.seed`` fanned
out with per-executor salts). One ``time.time()`` or unseeded
``default_rng()`` anywhere in ``src/`` silently breaks both.

Real-host tools (``launch/`` compile timing, benchmark wall-clock) are
exempt via the waiver file / per-path config — wall-clock is their
*measurement*, not part of the simulated substrate.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import ModuleInfo, Rule, Violation, register

WALLCLOCK_CALLS = {
    "time.time", "time.time_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns",
    "time.clock_gettime", "time.clock_gettime_ns",
}

# suffix-matched so `datetime.now`, `datetime.datetime.now`, and the
# `from datetime import datetime` alias all resolve
DATETIME_SUFFIXES = ("datetime.now", "datetime.utcnow", "datetime.today",
                     "date.today")

# module-level numpy RNG: draws mutate the shared global BitGenerator,
# so results depend on everything else that has drawn from it
AMBIENT_NP_RANDOM = {
    "seed", "random", "rand", "randn", "randint", "random_sample",
    "ranf", "sample", "uniform", "normal", "standard_normal", "choice",
    "permutation", "shuffle", "integers", "beta", "binomial", "poisson",
    "exponential", "gamma", "random_integers",
}

AMBIENT_MODULES = {"random", "secrets"}


@register
class WallClockRule(Rule):
    id = "DET001"
    name = "determinism-wallclock"
    invariant = ("simulated-clock discipline: executor time comes from "
                 "UploadTick/cost models, never the host clock — a "
                 "wall-clock read makes seeded runs irreproducible and "
                 "breaks fleet-vs-standalone bit-equivalence")
    default_paths = ("src/*",)

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            q = mod.qualname(node.func)
            if q is None:
                continue
            if q in WALLCLOCK_CALLS:
                yield self.violation(
                    mod, node,
                    f"wall-clock read `{q}()` in simulated-time code; "
                    "derive time from the hardware cost models "
                    "(UploadTick seconds) or move the timing into a "
                    "waived real-host tool")
            elif any(q == s or q.endswith("." + s)
                     for s in DATETIME_SUFFIXES):
                yield self.violation(
                    mod, node,
                    f"wall-clock read `{q}()` in simulated-time code; "
                    "simulated runs must not observe the host date")


@register
class UnseededRngRule(Rule):
    id = "DET002"
    name = "determinism-entropy"
    invariant = ("seeded RNG streams: every random draw derives from "
                 "spec seeds (VideoSpec.seed x per-executor salt), so "
                 "reruns and fleet interleavings reproduce bit-for-bit")
    default_paths = ("src/*",)

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.split(".")[0] in AMBIENT_MODULES:
                        yield self.violation(
                            mod, node,
                            f"stdlib `{a.name}` draws from ambient "
                            "process-global state; use "
                            "np.random.default_rng(<spec-derived seed>) "
                            "or a seeded torch.Generator")
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0 and node.module and \
                        node.module.split(".")[0] in AMBIENT_MODULES:
                    yield self.violation(
                        mod, node,
                        f"stdlib `{node.module}` draws from ambient "
                        "process-global state; use seeded "
                        "np.random.default_rng / a seeded torch.Generator")
            elif isinstance(node, ast.Call):
                q = mod.qualname(node.func)
                if q == "numpy.random.default_rng":
                    first = node.args[0] if node.args else None
                    seed_kw = next((k.value for k in node.keywords
                                    if k.arg == "seed"), None)
                    seed = first if first is not None else seed_kw
                    if seed is None or (isinstance(seed, ast.Constant)
                                        and seed.value is None):
                        yield self.violation(
                            mod, node,
                            "unseeded np.random.default_rng(): entropy "
                            "must derive from spec seeds "
                            "(e.g. default_rng(spec.seed * K + salt))")
                elif q and q.startswith("numpy.random.") and \
                        q.rsplit(".", 1)[-1] in AMBIENT_NP_RANDOM:
                    yield self.violation(
                        mod, node,
                        f"`{q}()` uses numpy's process-global RNG; "
                        "draw from a seeded Generator instead")


# torch draws that read the process's default generator unless given one
TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
               "randn_like", "randint_like", "normal", "bernoulli",
               "multinomial", "poisson"}
TORCH_INPLACE_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                       "exponential_", "geometric_", "log_normal_",
                       "cauchy_"}


@register
class TorchDefaultGeneratorRule(Rule):
    id = "DET003"
    name = "determinism-torch-generator"
    invariant = ("explicit generators: every torch draw in the port takes "
                 "generator= (seeded from the spec or the caller), so a "
                 "draw never depends on what else has drawn from the "
                 "process's default generator (seeded reruns and the "
                 "fleet's bit-equivalence with standalone runs)")
    default_paths = ("src/repro_torch/*",)

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or any(
                    k.arg == "generator" for k in node.keywords):
                continue
            func = node.func
            q = mod.qualname(func)
            if q and q.startswith("torch.") and \
                    q.rsplit(".", 1)[-1] in TORCH_DRAWS and \
                    q.count(".") == 1:
                yield self.violation(
                    mod, node,
                    f"`{q}()` draws from torch's default generator; pass "
                    "generator= (a torch.Generator seeded from the spec)")
            elif isinstance(func, ast.Attribute) and \
                    func.attr in TORCH_INPLACE_DRAWS:
                yield self.violation(
                    mod, node,
                    f"`.{func.attr}()` draws from torch's default "
                    "generator; pass generator=")
