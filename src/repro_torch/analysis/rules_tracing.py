"""Launch-hygiene rules for the port: build once, never wait on the card
in a hot body.

The counterpart of ``repro/analysis/rules_tracing.py``, whose rules
guard ``jax.jit``'s compilation cache and traced code. The port runs
eager PyTorch: what it builds once and caches is a kernel's shared
library (``kernels/build.load``), a ``torch.compile``d function or a
captured CUDA graph, and what stalls its hot paths is the host waiting
for the card:

  TRC001  a kernel module loaded (``build.load(...)``), a
          ``torch.compile(...)`` or a CUDA graph (``torch.cuda.CUDAGraph``,
          ``torch.cuda.graph``) built inside a loop or comprehension: each
          iteration pays the build (or its cache lookup and a fresh graph
          capture) where one built before the loop would do.
  TRC002  a host sync inside a hot body: ``.item()``, ``.tolist()``,
          ``.cpu()``, ``.numpy()``, ``.to("cpu")`` (or ``device="cpu"``)
          and ``torch.cuda.synchronize()``. The host then waits for every
          queued launch before it can queue the next, so the card idles
          between them. The hot bodies are ``HOT_BODIES``: the decode tick
          and the model's forward passes, the MoE dispatch, the kernel
          wrappers, and the scoring runtime's launch body.

The JAX rules TRC003 (hashable static arguments) and TRC004 (buffer
donation) have no counterpart: an eager PyTorch call has no static
arguments that key a compilation cache, and no donation; a PyTorch
function reuses an input's memory only when it writes it in place.
"""
from __future__ import annotations

import ast
import fnmatch
from typing import Iterator, Tuple

from repro_torch.analysis.engine import ModuleInfo, Rule, Violation, register

LOOPS = (ast.For, ast.While, ast.AsyncFor)
COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
BUILD_CALLS = {"torch.compile", "torch.cuda.CUDAGraph", "torch.cuda.graph",
               "torch.cuda.make_graphed_callables"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
SYNC_CALLS = {"torch.cuda.synchronize", "torch.cuda.current_stream.synchronize"}

# (path glob, function-name globs): the bodies that run once a token, a
# layer or a dispatch, where no host sync may stand
HOT_BODIES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("src/repro_torch/models/transformer.py",
     ("decode_step", "forward_hidden", "prefill", "forward",
      "train_forward", "decode")),
    ("src/repro_torch/models/attention.py", ("forward", "decode")),
    ("src/repro_torch/models/moe.py", ("moe_ffn", "route", "aux_losses")),
    ("src/repro_torch/kernels/rmsnorm.py", ("*",)),
    ("src/repro_torch/kernels/flash_attention.py", ("*",)),
    ("src/repro_torch/kernels/decode_attention.py", ("*",)),
    ("src/repro_torch/kernels/moe_gmm.py", ("*",)),
    ("src/repro_torch/kernels/conv_scorer.py", ("*",)),
    ("src/repro_torch/kernels/scorer_head.py", ("*",)),
    ("src/repro_torch/core/runtime.py",
     ("_scorer_body", "_launch", "_dispatch", "_dispatch_chunk",
      "_dispatch_group")),
)


def _builds(mod: ModuleInfo, call: ast.Call) -> bool:
    q = mod.qualname(call.func)
    if q is None:
        return False
    if q in BUILD_CALLS:
        return True
    # kernels/build.py's load, however it is imported
    return q.endswith("kernels.build.load") or q == "build.load"


@register
class BuildInLoopRule(Rule):
    id = "TRC001"
    name = "launch-build-in-loop"
    invariant = ("build once, launch many: a kernel library, a compiled "
                 "function or a CUDA graph is built before the loop that "
                 "launches it (kernels/build.load caches by source hash; "
                 "a build per iteration pays nvcc or a graph capture "
                 "again)")
    default_paths = ("src/repro_torch/*", "benchmarks/*")

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and _builds(mod, node)):
                continue
            anc = node
            while anc in mod.parents:
                anc = mod.parents[anc]
                if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda)):
                    break
                if isinstance(anc, LOOPS + COMPREHENSIONS):
                    yield self.violation(
                        mod, node,
                        f"`{mod.qualname(node.func)}(...)` inside a loop "
                        "builds (or looks up and captures) every "
                        "iteration; build it once before the loop")
                    break


def hot_functions(mod: ModuleInfo):
    """The function definitions of ``mod`` that ``HOT_BODIES`` names."""
    globs = [names for pat, names in HOT_BODIES
             if fnmatch.fnmatchcase(mod.path, pat)]
    if not globs:
        return
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                any(fnmatch.fnmatchcase(node.name, g)
                    for names in globs for g in names):
            yield node


def _to_cpu(call: ast.Call) -> bool:
    """``.to("cpu")``, ``.to(torch.device("cpu"))`` or ``.to(device=
    "cpu")``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    cands = list(call.args[:1]) + [k.value for k in call.keywords
                                   if k.arg == "device"]
    for c in cands:
        if isinstance(c, ast.Call) and c.args:
            c = c.args[0]
        if isinstance(c, ast.Constant) and c.value == "cpu":
            return True
    return False


@register
class HostSyncInHotBodyRule(Rule):
    id = "TRC002"
    name = "launch-host-sync"
    invariant = ("the decode tick, the forward passes, the kernel "
                 "wrappers and the scoring runtime's launch body queue "
                 "launches without waiting for the card; a host sync there "
                 "drains the queue every call and leaves the card idle "
                 "between launches")
    default_paths = ("src/repro_torch/*",)

    def check(self, mod: ModuleInfo) -> Iterator[Violation]:
        for fn in hot_functions(mod):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                q = mod.qualname(func)
                if isinstance(func, ast.Attribute) and \
                        func.attr in SYNC_METHODS:
                    yield self.violation(
                        mod, node,
                        f"`.{func.attr}()` in hot body `{fn.name}` waits "
                        "for the card; keep the value on the device or read "
                        "it outside the hot path")
                elif _to_cpu(node):
                    yield self.violation(
                        mod, node,
                        f"`.to('cpu')` in hot body `{fn.name}` copies to "
                        "the host and waits for the card")
                elif q in SYNC_CALLS:
                    yield self.violation(
                        mod, node,
                        f"`{q}()` in hot body `{fn.name}` drains the "
                        "card's queue")
