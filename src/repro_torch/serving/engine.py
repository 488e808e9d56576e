"""Batched serving engine: continuous batching over fixed decode slots.

Ported from ``repro/serving/engine.py``. The engine owns ``slots``
concurrent sequences: new requests claim free slots, prefill runs per
request, each decode tick advances every slot at once, and a finished
sequence frees its slot at once for a waiting request. Each slot's cache
holds every layer's state: attention's k, v ring and the recurrent
mixers' states and conv tails. On the card every norm, prefill
attention, decode attention and MoE expert product of the model runs a
hand-written CUDA kernel (``kernels/csrc``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import Device, resolve_device
from repro_torch.models import transformer


def _leaves(cache: Dict) -> List[torch.Tensor]:
    """A layer's cache tensors in a fixed order (a state tuple's in
    order)."""
    out = []
    for name in sorted(cache):
        t = cache[name]
        out.extend(t if isinstance(t, tuple) else (t,))
    return out


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False      # hit the KV ring before max_new tokens


class ServeEngine:
    """Serves ``model`` (``models/transformer.py``) on ``device``: the
    card unless the caller asks for the CPU. The model must already be
    on that device.

    Greedy decoding (``temperature <= 0``) takes the argmax, as the JAX
    package does. With ``temperature > 0`` each token is drawn from a
    ``torch.Generator`` seeded from ``(seed, rid, step)``, so a request's
    tokens depend on the request alone and not on which requests share
    the batch (the JAX package's invariant); the draws are not the JAX
    package's ``fold_in`` draws."""

    def __init__(self, model: transformer.Transformer, *, slots: int = 4,
                 cache_len: int = 512, temperature: float = 0.0,
                 seed: int = 0, device: Device = None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model is on {model.device}; the engine "
                             f"serves on {self.device}")
        self.model = model
        self.cfg = model.cfg
        self.slots = slots
        self.cache_len = cache_len
        self.temperature = temperature
        self.seed = seed
        self.caches = transformer.init_caches(self.cfg, slots, cache_len,
                                              model.device)
        self.active: Dict[int, Optional[Request]] = {i: None
                                                     for i in range(slots)}
        self.pos = np.zeros(slots, np.int64)
        self.queue: List[Request] = []
        self.requests: Dict[int, Request] = {}   # rid -> Request, all ever
        self._next_rid = 1000

    # -- API -----------------------------------------------------------------

    def submit(self, prompt, max_new: int, rid: Optional[int] = None) -> int:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or len(prompt) == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if len(prompt) >= self.cache_len:
            raise ValueError(
                f"prompt length {len(prompt)} must leave KV-ring room "
                f"(cache_len={self.cache_len}) for generation")
        transformer.check_prompt_length(self.cfg, len(prompt))
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        elif rid in self.requests:
            raise ValueError(f"duplicate rid: {rid}")
        self._next_rid = max(self._next_rid, rid + 1)
        req = Request(rid, prompt, max_new)
        self.queue.append(req)
        self.requests[rid] = req
        return rid

    def run(self, max_ticks: int = 10_000) -> Dict[int, List[int]]:
        """Drive to completion; returns rid -> generated tokens."""
        results: Dict[int, List[int]] = {}
        for _ in range(max_ticks):
            self._admit(results)
            if not any(r is not None for r in self.active.values()):
                if not self.queue:
                    break
                continue
            self._tick(results)
        return results

    # -- internals -------------------------------------------------------------

    def _admit(self, results: Dict[int, List[int]]) -> None:
        for slot, r in self.active.items():
            if r is None and self.queue:
                req = self.queue.pop(0)
                self._prefill_into(slot, req)
                if len(req.out) >= req.max_new:      # max_new == 1
                    req.done = True
                    results[req.rid] = req.out
                else:
                    self.active[slot] = req

    def _prefill_into(self, slot: int, req: Request) -> None:
        """Per-request prefill. Writes the prompt's cache into ``slot``'s
        rows of the engine's cache, in place, leaf by leaf, as the JAX
        engine's ``splice`` does: a leaf whose rows (its first axis after
        the slot) match is copied whole (recurrent states); otherwise its
        last rows go first and the rest are zeroed. So attention's ring
        rows [0, S) hold the prompt (rolled into ring order when S
        exceeds a window) and the rest are zeroed, which decode masks by
        position; and a conv tail of a prompt under K-1 tokens keeps its
        rows at the front, zeros after them (F6 in ROADMAP.md: the JAX
        engine's rule, kept for parity). Then samples the request's first
        token from the prefill logits (ticks feed out[-1] and never
        re-process the last prompt token)."""
        S = len(req.prompt)
        toks = torch.as_tensor(req.prompt[None, :].astype(np.int64),
                               device=self.model.device)
        logits, caches = transformer.prefill(self.model, toks)
        for engine_c, new_c in zip(self.caches, caches):
            for tgt, src in zip(_leaves(engine_c), _leaves(new_c)):
                tgt = tgt[slot]
                src = src[0, -tgt.shape[0]:]
                tgt[:src.shape[0]].copy_(src)
                tgt[src.shape[0]:].zero_()
        # submit() guarantees S < cache_len; the clamp keeps the ring
        # write position in range even for subclasses that relax it
        self.pos[slot] = min(S, self.cache_len - 1)
        req.out.append(self._sample(logits[:, -1], [req])[0])

    def _sample(self, logits: torch.Tensor, reqs: List[Request]) -> List[int]:
        """One token per request from its own (V,) row of ``logits``."""
        if self.temperature <= 0:
            return logits.argmax(dim=-1).tolist()
        rows = (logits.float() / self.temperature).softmax(dim=-1).cpu()
        out = []
        for row, req in zip(rows, reqs):
            entropy = [x % 2 ** 64 for x in (self.seed, req.rid, len(req.out))]
            g = torch.Generator().manual_seed(int(
                np.random.SeedSequence(entropy).generate_state(1)[0]))
            out.append(int(torch.multinomial(row, 1, generator=g)))
        return out

    def _tick(self, results: Dict[int, List[int]]) -> None:
        """One decode step over every slot, idle slots included (they
        feed token 0), as the JAX engine's jitted ``decode_step`` runs
        it. The batching is part of the result: an MoE layer routes the
        tokens of one forward together, and capacity drops make a
        token's output depend on the others, so prefill stays per
        request and the tick takes all slots, for the greedy tokens to
        match the JAX engine's."""
        last = np.zeros((self.slots, 1), np.int64)
        for slot, r in self.active.items():
            if r is not None:
                last[slot, 0] = (r.out[-1] if r.out else r.prompt[-1])
        dev = self.model.device
        logits, self.caches = transformer.decode_step(
            self.model, self.caches, torch.as_tensor(last, device=dev),
            torch.as_tensor(self.pos, device=dev))
        live = [(slot, r) for slot, r in self.active.items() if r is not None]
        rows = torch.as_tensor([slot for slot, _ in live], device=dev)
        toks = self._sample(logits[rows, -1], [r for _, r in live])
        for (slot, r), tok in zip(live, toks):
            r.out.append(tok)
            self.pos[slot] += 1
            if len(r.out) >= r.max_new or self.pos[slot] >= self.cache_len:
                r.done = True
                # the ring ran out before the token budget: the output
                # is complete-as-generated but shorter than asked — say
                # so instead of silently freeing the slot
                r.truncated = len(r.out) < r.max_new
                results[r.rid] = r.out
                self.active[slot] = None     # slot freed immediately
