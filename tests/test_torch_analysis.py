"""The port's analyzer (``repro_torch.analysis``) against the JAX package's.

On the rules both have (DET001, DET002, GEN*, STP*) the two analyzers
find the same violations, line and column, over ``src/repro``, over
``src/repro_torch`` and over ``tests/test_analysis.py``'s fixture
snippets. Each rule of the port's own (TRC001 and TRC002 for eager
PyTorch, DET003) fires on a fixture and not on its fixed form, and
``src/repro_torch`` is clean under the port's rules and waivers.
"""
from pathlib import Path

import pytest

from repro import analysis as jan
from repro_torch import analysis as tan
from repro_torch.analysis.__main__ import main as tcli
from test_analysis import FIXTURES

ROOT = Path(__file__).resolve().parent.parent
SHARED = ["DET001", "DET002", "GEN*", "STP*"]


def _found(violations):
    return [(v.rule, v.path, v.line, v.col) for v in violations]


@pytest.mark.parametrize("i", range(len(FIXTURES)))
def test_shared_rules_agree_on_the_fixtures(i):
    _, bad, good = FIXTURES[i]
    for src in (bad, good):
        for path in ("src/repro/core/x.py", "src/repro_torch/core/x.py",
                     "tests/x.py"):
            assert _found(tan.check_source(src, path, rules=SHARED)) == \
                _found(jan.check_source(src, path, rules=SHARED))


@pytest.mark.parametrize("tree", ["src/repro", "src/repro_torch"])
def test_shared_rules_agree_on_the_trees(tree):
    waivers = ROOT / "analysis-waivers.txt"
    j = jan.run_paths([tree], root=ROOT, rules=SHARED, waiver_file=waivers)
    t = tan.run_paths([tree], root=ROOT, rules=SHARED, waiver_file=waivers)
    assert _found(t.violations) == _found(j.violations)
    assert [(_found([v])[0], r) for v, r in t.waived] == \
        [(_found([v])[0], r) for v, r in j.waived]
    assert t.checked_files == j.checked_files > 10


HOT = "src/repro_torch/models/transformer.py"
KERNEL = "src/repro_torch/kernels/rmsnorm.py"
TORCH_FIXTURES = [
    # (rule, path, must fire, must not fire)
    ("TRC001", "src/repro_torch/core/x.py",
     "from repro_torch.kernels import build\n\n"
     "def f(names, sigs):\n    return [build.load(n, sigs) for n in names]\n",
     "from repro_torch.kernels import build\n\n"
     "def f(name, sigs):\n    return build.load(name, sigs)\n"),
    ("TRC001", "src/repro_torch/core/x.py",
     "import torch\n\ndef f(fns, x):\n    out = []\n"
     "    for fn in fns:\n        out.append(torch.compile(fn)(x))\n"
     "    return out\n",
     "import torch\n\ndef f(fn, xs):\n    g = torch.compile(fn)\n"
     "    return [g(x) for x in xs]\n"),
    ("TRC001", "src/repro_torch/core/x.py",
     "import torch\n\ndef f(n):\n    while n:\n"
     "        g = torch.cuda.CUDAGraph()\n        n -= 1\n    return g\n",
     "import torch\n\ndef f(n):\n    g = torch.cuda.CUDAGraph()\n"
     "    while n:\n        n -= 1\n    return g\n"),
    ("TRC002", HOT,
     "def decode_step(model, caches, tokens, pos):\n"
     "    n = int(pos.max().item())\n    return n\n",
     "def decode_step(model, caches, tokens, pos):\n"
     "    return pos.max()\n"),
    ("TRC002", HOT,
     "import torch\n\ndef forward_hidden(model, tokens):\n"
     "    torch.cuda.synchronize()\n    return tokens\n",
     "import torch\n\ndef sample(logits):\n"
     "    torch.cuda.synchronize()\n    return logits.cpu()\n"),
    ("TRC002", KERNEL,
     "def rmsnorm(x, scale, eps):\n    return x.to('cpu').numpy()\n",
     "def rmsnorm(x, scale, eps):\n    return x.to('cuda')\n"),
    ("TRC002", "src/repro_torch/core/runtime.py",
     "class R:\n    def _launch(self, x):\n        return x.tolist()\n",
     "class R:\n    def to_np(self, x):\n        return x.tolist()\n"),
    ("DET003", "src/repro_torch/core/x.py",
     "import torch\n\ndef f(n):\n    return torch.randn(n)\n",
     "import torch\n\ndef f(n, g):\n    return torch.randn(n, generator=g)\n"),
    ("DET003", "src/repro_torch/core/x.py",
     "import torch\n\ndef f(t):\n    t.uniform_(0, 1)\n"
     "    return torch.randperm(5)\n",
     "import torch\n\ndef f(t, g):\n    t.uniform_(0, 1, generator=g)\n"
     "    return torch.randperm(5, generator=g)\n"),
]


@pytest.mark.parametrize("rule,path,bad,good", TORCH_FIXTURES,
                         ids=[f"{r}-{i}" for i, (r, *_) in
                              enumerate(TORCH_FIXTURES)])
def test_port_rule_fixture(rule, path, bad, good):
    assert rule in {v.rule for v in tan.check_source(bad, path)}
    assert rule not in {v.rule for v in tan.check_source(good, path)}


def test_every_port_rule_has_a_fixture_and_the_jax_ones_are_named():
    covered = {r for r, *_ in TORCH_FIXTURES} | \
        {r for r, _, _ in FIXTURES if not r.startswith("TRC")}
    assert set(tan.RULES) == covered
    assert "TRC003" not in tan.RULES and "TRC004" not in tan.RULES


def test_port_tree_is_clean_under_its_rules_and_waivers(capsys):
    report = tan.run_paths(["src/repro_torch"], root=ROOT)
    assert report.ok, "\n" + report.render_text()
    assert not report.unused_waivers
    assert tcli(["src/repro_torch", "--root", str(ROOT)]) == 0
    assert tcli(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "TRC003, TRC004" in out and "DET003" in out
