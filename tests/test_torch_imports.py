"""The port stands alone: it imports neither JAX nor the JAX package.

Checked twice: statically, by walking every import of ``src/repro_torch``
and ``chip_smoke.py``; and at run time, in a fresh interpreter where
``jax`` and ``repro`` cannot be imported.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
    sorted((ROOT / "examples").glob("torch_*.py"))
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_repro_import_in_the_port_source():
    assert len(MODULES) >= 20 and "repro_torch.core.ranking" in MODULES
    assert {"repro_torch.kernels.build", "repro_torch.kernels.rmsnorm",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.decode_attention",
            "repro_torch.kernels.moe_gmm", "repro_torch.models.moe",
            "repro_torch.kernels.scorer_head",
            "repro_torch.configs.granite_moe_3b_a800m",
            "repro_torch.configs.h2o_danube_1_8b",
            "repro_torch.models.transformer", "repro_torch.models.convert",
            "repro_torch.serving.engine", "repro_torch.core.filtering",
            "repro_torch.core.counting", "repro_torch.core.baselines",
            "repro_torch.core.fleet", "repro_torch.serving.oracle_service",
            "repro_torch.serving.fleet", "repro_torch.models.ssm",
            "repro_torch.models.xlstm", "repro_torch.train.optimizer",
            "repro_torch.train.train_step", "repro_torch.train.checkpoint",
            "repro_torch.train.data", "repro_torch.train.elastic",
            "repro_torch.launch.train", "repro_torch.launch.mesh",
            "repro_torch.parallel.sharding",
            "repro_torch.parallel.ops", "repro_torch.launch.dryrun",
            "repro_torch.launch.specs", "repro_torch.launch.op_analysis",
            "repro_torch.kernels.count",
            "repro_torch.analysis", "repro_torch.analysis.__main__",
            "repro_torch.analysis.engine",
            "repro_torch.analysis.rules_determinism",
            "repro_torch.analysis.rules_generic",
            "repro_torch.analysis.rules_stepper",
            "repro_torch.analysis.rules_tracing"} <= set(MODULES)
    assert {"torch_quickstart.py", "torch_zc2_text_query.py"} <= {
        p.name for p in FILES}
    bad = []
    for path in FILES:
        for name in _imported(ast.parse(path.read_text())):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


_BLOCKED = r"""
import importlib, importlib.abc, runpy, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("repro", "jaxlib"):
            raise ImportError(f"the port imported {name}")
        return None

sys.modules["jax"] = None
sys.meta_path.insert(0, Refuse())
for mod in sys.argv[2:]:
    importlib.import_module(mod)
runpy.run_path(sys.argv[1], run_name="chip_smoke_as_module")
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               or m == "repro" for m in sys.modules if sys.modules[m])
print("ok", len(sys.argv) - 2)
"""


def test_port_imports_with_jax_and_repro_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(ROOT / "chip_smoke.py"),
         *MODULES],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok", str(len(MODULES))]


def test_default_device_is_the_card(monkeypatch):
    """``OperatorRuntime()`` and the LM entry points on a host without
    CUDA raise and name ``device="cpu"``; they never quietly pick the
    CPU."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.runtime import OperatorRuntime
    from repro_torch.models import transformer
    from repro_torch.models.convert import params_from_jax
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("h2o-danube-1.8b")
    moe_cfg = get_smoke_config("granite-moe-3b-a800m")
    for entry in (OperatorRuntime, lambda: transformer.init_model(cfg),
                  lambda: transformer.init_model(moe_cfg),
                  lambda: transformer.init_caches(cfg, 1, 8),
                  lambda: params_from_jax(cfg, {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
