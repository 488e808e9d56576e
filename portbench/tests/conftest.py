import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import portbench.run  # noqa: E402,F401  (a run's environment: cuBLAS, caches)
import pytest  # noqa: E402
import torch  # noqa: E402

# the configurations cut to a size the CPU runs in seconds: every width
# shrunk alike, the kinds of layer and the dispatch as published, the
# port's numerics at these widths
SMALL = {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "vocab_size": 256, "num_local_experts": 8, "num_experts_per_tok": 2}
TRAIN_SMALL = {"seq_len": 64, "batch": 2}


def small(cfg_name: str, capacity_factor: float = 1.25, **extra):
    cfg = dict(SMALL, **extra)
    cfg["as_run"] = {"embedding_multiplier": 8.0, "attention_multiplier": 0.25,
                     "residual_multiplier": 1.0, "logits_scaling": 1.0,
                     "capacity_factor": capacity_factor}
    if cfg_name.startswith("h2o"):
        cfg["sliding_window"] = 32
    return cfg


@pytest.fixture(autouse=True)
def few_threads():
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


@pytest.fixture
def card():
    """The NVIDIA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
