"""The dense SwiGLU feed-forward network: (silu(h wg) * (h wu)) wo."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.transformer import mm


def forward(cfg, w, h: torch.Tensor, precision: str):
    """h (B, S, d) -> (y, lb_loss, z_loss); a dense FFN has no aux loss."""
    y = mm(F.silu(mm(h, w["ffn.wg"], precision)) * mm(h, w["ffn.wu"], precision),
           w["ffn.wo"], precision)
    zero = torch.zeros((), device=h.device)
    return y, zero, zero
