"""repro_torch.analysis — repo-aware static analysis for the port.

Ported from ``repro.analysis``, with no JAX in it. The determinism
(DET001, DET002), stepper-purity (STP*) and generic (GEN*) rules are the
JAX package's as they are; DET003 (every ``torch`` draw takes an
explicit ``generator=``) is the port's own; the tracing rules are
rewritten for eager PyTorch (``rules_tracing``: TRC001 no kernel build,
``torch.compile`` or CUDA graph inside a loop; TRC002 no host sync in
the port's hot bodies). The JAX rules TRC003 and TRC004 have no
counterpart here.

Usage::

    python -m repro_torch.analysis src/repro_torch
    python -m repro_torch.analysis --list-rules

Waivers: ``analysis-waivers-torch.txt`` at the repo root, the format of
the JAX package's ``analysis-waivers.txt``.
"""
from repro_torch.analysis.engine import (DEFAULT_CONFIG, RULES, ModuleInfo,
                                         Report, Rule, Violation, Waiver,
                                         check_source, load_waivers,
                                         register, rule_applies, run_paths)
from repro_torch.analysis import (rules_determinism, rules_generic,
                                  rules_stepper, rules_tracing)

__all__ = [
    "DEFAULT_CONFIG", "RULES", "ModuleInfo", "Report", "Rule",
    "Violation", "Waiver", "check_source", "load_waivers", "register",
    "rule_applies", "run_paths",
    "rules_determinism", "rules_generic", "rules_stepper",
    "rules_tracing",
]
