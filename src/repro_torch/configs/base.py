"""Config system: model architecture + input-shape cells.

Every assigned architecture is a ``ModelConfig`` built in its own
``src/repro/configs/<id>.py`` file and registered here. Input shapes are
``ShapeCell``s; the (arch x shape) grid drives smoke tests, the multi-pod
dry-run, and the roofline table.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# Block pattern vocabulary (see models/transformer.py)
#   mixer:  attn | attn_window | mamba | mlstm | slstm
#   ffn:    dense | moe | none   (xLSTM blocks fold their FFN into the mixer)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockSpec:
    mixer: str = "attn"          # attn | attn_window | mamba | mlstm | slstm
    ffn: str = "dense"           # dense | moe | none
    window: Optional[int] = None  # for attn_window


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # Block pattern: repeated period of BlockSpecs; len(pattern) must divide
    # num_layers. A uniform arch has a single-entry pattern.
    pattern: Sequence[BlockSpec] = field(default_factory=lambda: (BlockSpec(),))

    # MoE
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: Optional[int] = None   # expert hidden size (defaults d_ff)
    num_shared_experts: int = 0
    capacity_factor: float = 1.25

    # Mamba (hybrid archs)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: Optional[int] = None  # defaults ceil(d_model/16)

    # xLSTM
    mlstm_expand: int = 2
    slstm_ff_expand: float = 4.0 / 3.0

    # positions / rope
    rope_theta: float = 10_000.0
    max_seq_len: int = 32_768

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True

    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    num_prefix_embeds: int = 0   # vlm: patch embeddings prepended (stub input)

    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_chunk: int = 512       # seq-chunked xent to bound logits memory

    # does this arch have a sub-quadratic long-context path?
    subquadratic: bool = False

    def __post_init__(self):
        assert self.num_layers % len(self.pattern) == 0, (
            f"{self.name}: pattern period {len(self.pattern)} must divide "
            f"num_layers {self.num_layers}")
        assert self.num_heads % max(self.num_kv_heads, 1) == 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def num_periods(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def resolved_d_ff_expert(self) -> int:
        return self.d_ff_expert if self.d_ff_expert is not None else self.d_ff

    @property
    def resolved_dt_rank(self) -> int:
        if self.mamba_dt_rank is not None:
            return self.mamba_dt_rank
        return -(-self.d_model // 16)

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced copy for smoke tests (same family, tiny dims)."""
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class ShapeCell:
    """One input-shape cell of the (arch x shape) grid."""
    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeCell("train_4k",    "train",   4_096,   256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768,  32),
    "decode_32k":  ShapeCell("decode_32k",  "decode",  32_768,  128),
    "long_500k":   ShapeCell("long_500k",   "decode",  524_288, 1),
}

ARCH_IDS = (
    "h2o-danube-1.8b",
    "gemma3-12b",
    "granite-20b",
    "phi4-mini-3.8b",
    "xlstm-125m",
    "granite-moe-3b-a800m",
    "llama4-maverick-400b-a17b",
    "musicgen-large",
    "llava-next-34b",
    "jamba-v0.1-52b",
)

_MODULE_FOR = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
               for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(_MODULE_FOR[arch_id])
    return mod.config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(_MODULE_FOR[arch_id])
    return mod.smoke_config()


def cells_for(arch_id: str):
    """All (arch, shape) cells. long_500k only for sub-quadratic archs."""
    cfg = get_config(arch_id)
    out = []
    for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        if s == "long_500k" and not cfg.subquadratic:
            continue  # documented skip: pure full-attention arch
        out.append(SHAPES[s])
    return out


def all_cells():
    for a in ARCH_IDS:
        for s in cells_for(a):
            yield a, s
