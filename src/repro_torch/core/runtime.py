"""OperatorRuntime — the shared batched scoring engine (§7 fast path).

The port of ``repro/core/runtime.py``. Scoring goes through three
dispatch layers with the JAX package's rules, so a batch takes the same
layer and the same padded shape in both packages:

  * **lean small-shape dispatch** — below ``small_flops`` useful FLOPs
    per dispatch the batch is padded only up to a multiple of
    ``small_quant`` rows;
  * **bucketed single dispatch** — larger batches are zero-padded to
    power-of-two buckets (min 64, max ``chunk``);
  * **stacked superbatch dispatch** — ``ScoreBatcher`` fuses up to
    ``group_max`` same-(signature, bucket) chunks from *different*
    queries into one ``(group, bucket, …)`` dispatch over the members'
    stacked params (the JAX package's ``jax.vmap`` style): each conv
    layer is one launch of the grouped conv kernel for the whole group,
    and the dense and head layers one launch of the grouped
    scorer-head kernel.

All three layers run the same arithmetic: on the card every conv layer
launches the hand-written kernel (``kernels/conv_scorer.py``), and the
dense and head layers launch ``kernels/scorer_head.py``; both reduce
each output in an order that depends neither on the row count nor on
the group, so padding rows cannot perturb real rows and the layers
agree bit for bit.

PyTorch runs eagerly, so there is no compilation cache. The counterpart
of the JAX package's one trace per (signature, shape) is the first
dispatch of a (layer, signature, shape): ``trace_count``, ``n_compiled``
and ``TraceGuard`` count those, with the JAX package's meaning, so the
fleet's tracing assertions hold unchanged. ``calls`` counts dispatches
as in the JAX package. On the card each dispatch's input is copied from
page-locked host memory without waiting for the copy (``_dispatch``),
and results stay on the device (``ScoreHandle``) until they are
consumed: PyTorch's launches are asynchronous, and ``.cpu()`` is the
synchronisation point.

With a device mesh (``OperatorRuntime(mesh=...)``, a 1-D ``("data",)``
mesh of ``launch/mesh.make_scoring_mesh``) a stacked superbatch whose
group divides the mesh is split on its group axis, as the JAX package
places it (``parallel/sharding.superbatch_spec``): each slot scores its
share of the members on its own device, one grouped launch a layer, and
the results come back in member order. Each member's computation is
unchanged, so the bits are the single device's. Not ported yet:
CUDA-graph capture per (signature, shape).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.operators import softplus
from repro_torch.kernels import ops as kops
from repro_torch.parallel import sharding as shd

ArchSig = Tuple[int, int, int, int]

CHUNK = 1024          # frames per dispatch (bounds crop-cache pressure)
MIN_BUCKET = 64       # smallest padded batch shape (bucketed path)
# Useful FLOPs per dispatch below which the lean small-shape path runs;
# the JAX package's default, kept so both packages pick the same layer.
SMALL_FLOPS = 3e8
# Small-shape batches are quantized up to a multiple of this (instead of
# a power of two); 1 disables quantization (exact shapes).
SMALL_QUANT = 32


def arch_signature(arch) -> ArchSig:
    """Shape-relevant part of an OperatorArch: the input region changes
    *which pixels* are cropped, not the computation."""
    return (arch.conv_layers, arch.channels, arch.dense, arch.input_size)


def sig_flops(sig: ArchSig) -> float:
    """Per-frame inference FLOPs of a signature — the cost model of
    ``OperatorArch.flops`` restated over the signature fields (region
    variants share it), used to pick a dispatch layer per batch."""
    layers, channels, dense, size = sig
    s, c_in, total = size, 3, 0.0
    for _ in range(layers):
        total += 2.0 * s * s * channels * 9 * c_in
        c_in = channels
        s = max(1, (s + 1) // 2)
    total += 2.0 * (s * s * c_in) * dense + 2.0 * dense * 2
    return total


def sig_str(sig: ArchSig) -> str:
    """Stable human-readable key for an arch signature (reports)."""
    return f"L{sig[0]}c{sig[1]}d{sig[2]}s{sig[3]}"


def tree_map(fn, params):
    """``fn`` of every tensor of a params tree (dicts, lists, tensors)."""
    if isinstance(params, dict):
        return {k: tree_map(fn, v) for k, v in params.items()}
    if isinstance(params, list):
        return [tree_map(fn, v) for v in params]
    return fn(params)


def _first_leaf(params) -> torch.Tensor:
    while not isinstance(params, torch.Tensor):
        params = next(iter(params.values())) if isinstance(params, dict) \
            else params[0]
    return params


def same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name one device (the current one)."""
    def index(d):
        if d.index is not None or d.type != "cuda":
            return d.index or 0
        return torch.cuda.current_device()
    return a.type == b.type and index(a) == index(b)


def stack_params(params: List[dict]) -> dict:
    """The members' params stacked leaf by leaf on a new leading axis
    (the JAX package's ``tree_map(jnp.stack)`` over the group)."""
    first = params[0]
    if isinstance(first, dict):
        return {k: stack_params([p[k] for p in params]) for k in first}
    if isinstance(first, list):
        return [stack_params([p[i] for p in params])
                for i in range(len(first))]
    return torch.stack(params)


class OperatorRuntime:
    """Batched operator scoring on one device or over a device mesh.

    ``device``: None means the card (``torch.device("cuda")``); where
    there is none the constructor raises and asks for ``device="cpu"``.
    On the card the conv layers run the CUDA kernel; on the CPU its plain
    version. ``small_flops``/``small_quant`` tune the small-shape path.
    ``calls`` counts dispatches on every path (one fused superbatch = one
    call), so dispatch numbers are comparable between ``score_crops``
    and ``ScoreBatcher`` scoring and with the JAX package.

    ``mesh``: an optional 1-D ``("data",)`` mesh
    (``launch/mesh.make_scoring_mesh``; its devices may repeat). When it
    holds more than one slot, a stacked superbatch whose group divides
    the slots is split on its group axis: slot k scores members ``[k·g/n,
    (k+1)·g/n)`` on its device, its input slice copied there (from
    page-locked memory on the card) and its members' params with it,
    one grouped launch a layer; the slots' launches are all queued
    before any result is read. A group that does not divide runs whole
    on slot 0, recorded for ``sharding_fallbacks()``. Flat (small and
    bucketed) batches stay on slot 0 unless ``shard_frames=True``, which
    splits their frames the same way. Every member's and frame's bits
    are the single device's, and the trace accounting records each
    dispatch's global (layer, signature, shape), not a slot's share. The
    runtime's ``device`` is slot 0's.
    """

    def __init__(self, *, device: kops.Device = None, chunk: int = CHUNK,
                 min_bucket: int = MIN_BUCKET,
                 small_flops: float = SMALL_FLOPS,
                 small_quant: int = SMALL_QUANT,
                 mesh=None, shard_frames: bool = False):
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        if self.mesh is not None:
            if device is not None and not same_device(
                    torch.device(device), self.mesh.devices[0]):
                raise ValueError(f"device {device} is not the mesh's slot 0 "
                                 f"({self.mesh.devices[0]})")
            device = self.mesh.devices[0]
        self.device = kops.resolve_device(device)
        self.device_count = self.mesh.size if self.mesh is not None else 1
        self.shard_frames = bool(shard_frames)
        self._fallbacks: List[tuple] = []   # (axis, dim, mapped) records
        # members' params copied to a slot's device: (id, device) ->
        # (params, copy), dropped at every ScoreBatcher flush
        self._placed: Dict[tuple, tuple] = {}
        # dispatch parts scored a slot, by layer (an unsplit dispatch is
        # one part on slot 0; a superbatch part is one grouped launch a
        # layer)
        self.slot_parts = {kind: [0] * self.device_count
                           for kind in ("small", "bucketed", "super")}
        self.conv = kops.conv_scorer_fn(self.device)
        self.chunk = int(chunk)
        self.min_bucket = int(min_bucket)
        self.small_flops = float(small_flops)
        self.small_quant = max(int(small_quant), 1)
        # the counterpart of the JAX package's jit traces: the (layer,
        # signature, shape) of every first dispatch
        self._seen: Set[tuple] = set()
        self._traces: Dict[ArchSig, int] = {}
        self._group_traces: Dict[ArchSig, int] = {}
        # (sig, shape-key) -> trace count; the invariant TraceGuard
        # asserts is that no key ever reaches 2
        self._shape_traces: Dict[Tuple[ArchSig, tuple], int] = {}
        # sig -> dispatch-shape vocabulary actually used
        self._shape_vocab: Dict[ArchSig, set] = {}
        self.calls = 0
        self.frames_scored = 0       # real (caller-requested) frames
        self.frames_padded = 0       # zero rows added for shape stability
        self.small_calls = 0
        self.bucketed_calls = 0
        self.super_calls = 0
        self.pinned_copies = 0       # inputs copied from page-locked memory

    # -- the scorer ----------------------------------------------------------

    def _scorer_body(self, params: dict, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The per-batch ``(params, x) -> (probs, counts)`` computation.
        With a leading member axis on x and on every param (a stacked
        superbatch), each layer is one grouped launch for all members,
        member g scored with its own params."""
        h = x
        for c in params["convs"]:
            h = self.conv(h, c["w"], c["b"])
        out = kops.scorer_head(h.reshape(h.shape[:-3] + (-1,)),
                               params["dense"]["w"], params["dense"]["b"],
                               params["head"]["w"], params["head"]["b"])
        return torch.sigmoid(out[..., 0]), softplus(out[..., 1])

    def _record_trace(self, sig: ArchSig, shape_key: tuple,
                      *, grouped: bool = False) -> None:
        """Called at the first dispatch of a (layer, signature, shape),
        the port's counterpart of a trace, so the counters tally what
        the JAX package compiles, not dispatches."""
        if grouped:
            self._group_traces[sig] = self._group_traces.get(sig, 0) + 1
        else:
            self._traces[sig] = self._traces.get(sig, 0) + 1
        key = (sig, shape_key)
        self._shape_traces[key] = self._shape_traces.get(key, 0) + 1

    def trace_count(self, arch=None) -> int:
        if arch is None:
            return sum(self._traces.values())
        return self._traces.get(arch_signature(arch), 0)

    @property
    def n_compiled(self) -> int:
        """Distinct (layer, signature[, n]) keys dispatched: the JAX
        package's count of jitted functions (bucketed and superbatch one
        per signature, small one per signature and quantized size)."""
        return len({(kind, sig, shape[0]) if kind == "small" else
                    (kind, sig) for kind, sig, shape in self._seen})

    def shape_vocab(self) -> Dict[str, List[tuple]]:
        """sig-string -> sorted dispatch shapes used so far."""
        return {sig_str(sig): sorted(shapes)
                for sig, shapes in self._shape_vocab.items()}

    def dispatch_stats(self) -> Dict[str, int]:
        """Per-path dispatch accounting for reports."""
        return {
            "calls": self.calls,
            "small_calls": self.small_calls,
            "bucketed_calls": self.bucketed_calls,
            "super_calls": self.super_calls,
            "frames_scored": self.frames_scored,
            "frames_padded": self.frames_padded,
        }

    def mesh_info(self) -> Dict[str, object]:
        """Where scoring ran, in the JAX package's keys."""
        return {
            "device_count": self.device_count,
            "mesh_shape": (dict(self.mesh.shape)
                           if self.mesh is not None else None),
            "sharded": self.mesh is not None,
        }

    def sharding_fallbacks(self) -> list:
        """Summarized divisibility fallbacks hit so far (dims that ran
        whole on slot 0 instead of splitting), ``explain_fallbacks`` over
        the raw records."""
        return shd.explain_fallbacks(self._fallbacks)

    # -- dispatch layers -----------------------------------------------------

    def _bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b <<= 1
        return min(b, self.chunk)

    def is_small(self, sig: ArchSig, n: int) -> bool:
        """Does a batch of ``n`` frames take the lean small-shape path?

        Judged on the batch's *padded* (quantized) size, not ``n``, as in
        the JAX package, which keeps the small and bucketed shape
        vocabularies disjoint. Monotone in ``n`` per signature."""
        return self._quantize_small(n) * sig_flops(sig) < self.small_flops

    def _quantize_small(self, n: int) -> int:
        q = self.small_quant
        return max(1, ((n + q - 1) // q) * q) if n else 0

    def _pad_rows(self, x: np.ndarray, to: int) -> np.ndarray:
        m = x.shape[0]
        if m >= to:
            return x
        self.frames_padded += to - m
        return np.concatenate(
            [x, np.zeros((to - m,) + x.shape[1:], np.float32)])

    def _dispatch(self, sig: ArchSig, params, x: np.ndarray, *, kind: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``_launch`` of a dispatch that is not split (one slot), its
        (probs, counts); a superbatch's ``params`` may be the members'
        stacked params."""
        if kind == "super" and not isinstance(params, list):
            params = [tree_map(lambda t, g=g: t[g], params)
                      for g in range(x.shape[0])]
        (out,) = self._launch(sig, params, x, kind=kind)
        return out

    def _launch(self, sig: ArchSig, params, x: np.ndarray, *, kind: str
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Every dispatch funnels through here: counts calls, records the
        shape vocabulary and the first dispatch of each (layer,
        signature, shape), moves the input to the device (from
        page-locked memory on the card) and runs the scorer body. A
        superbatch's ``params`` are the members' params, a list.
        Returns one (probs, counts) of device tensors a slot the
        dispatch was split over, in order (the launches are queued, not
        finished)."""
        self.calls += 1
        if kind == "small":
            self.small_calls += 1
        elif kind == "super":
            self.super_calls += 1
        else:
            self.bucketed_calls += 1
        shape = tuple(x.shape)
        self._shape_vocab.setdefault(sig, set()).add(shape)
        if (kind, sig, shape) not in self._seen:
            self._seen.add((kind, sig, shape))
            self._record_trace(sig, shape, grouped=(kind == "super"))
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        if self.device.type == "cuda":
            # From pageable memory the copy would hold the host until it
            # is done. The page-locked block comes from PyTorch's caching
            # host allocator, which reuses blocks and does not hand one
            # out again before the copy queued from it has finished.
            xt = xt.pin_memory()
            self.pinned_copies += 1
        slots = self._slots(shape, kind)
        per = shape[0] // slots
        outs = []
        for k in range(slots):
            dev = self.mesh.devices[k] if slots > 1 else self.device
            sl = slice(k * per, (k + 1) * per)
            p = [self._on(m, dev) for m in params[sl]] if kind == "super" \
                else self._on(params, dev)
            xs = xt[sl] if slots > 1 else xt
            xs = xs.to(dev, non_blocking=dev.type == "cuda")
            with torch.no_grad():
                outs.append(self._scorer_body(
                    stack_params(p) if kind == "super" else p, xs))
            self.slot_parts[kind][k] += 1
        return outs

    def _slots(self, shape: tuple, kind: str) -> int:
        """How many slots a dispatch of ``shape`` is split over: the
        mesh's data axis where its spec shards dim 0, else 1."""
        if self.mesh is None:
            return 1
        if kind == "super":
            spec = shd.superbatch_spec(shape, self.mesh, self._fallbacks)
        elif self.shard_frames:
            spec = shd.frames_spec(shape, self.mesh, self._fallbacks)
        else:
            return 1
        return self.device_count if spec[0] is not None else 1

    def _on(self, params, dev: torch.device):
        """``params`` on ``dev``: themselves where they are there, else a
        copy, made once a (params, device) until the next flush."""
        if same_device(_first_leaf(params).device, dev):
            return params
        key = (id(params), str(dev))
        hit = self._placed.get(key)
        if hit is None or hit[0] is not params:
            hit = (params, tree_map(lambda t: t.to(dev), params))
            self._placed[key] = hit
        return hit[1]

    def release_placed(self) -> None:
        """Drop the params copied to other slots' devices."""
        self._placed.clear()

    def _dispatch_chunk(self, sig: ArchSig, params, x: np.ndarray):
        """One chunk through the lean or bucketed layer (padding as the
        layer dictates); returns ``_launch``'s parts."""
        m = x.shape[0]
        if self.is_small(sig, m):
            n = self._quantize_small(m)
            return self._launch(sig, params, self._pad_rows(x, n),
                                kind="small")
        return self._launch(sig, params, self._pad_rows(x, self._bucket(m)),
                            kind="bucketed")

    # -- scoring -------------------------------------------------------------

    def score_crops(self, params: dict, arch, crops
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Score pre-cropped inputs -> (presence_prob, count) as float64
        numpy. ``calls`` advances once per dispatch (= per chunk)."""
        x = np.asarray(crops, np.float32)
        n = x.shape[0]
        probs = np.empty(n, np.float64)
        counts = np.empty(n, np.float64)
        if n == 0:
            return probs, counts
        sig = arch_signature(arch)
        self.frames_scored += n
        for i in range(0, n, self.chunk):
            xb = x[i:i + self.chunk]
            m = xb.shape[0]
            p, c = _Out(self._dispatch_chunk(sig, params, xb)).to_np()
            probs[i:i + m] = p[:m]
            counts[i:i + m] = c[:m]
        return probs, counts

    def score(self, trained, bank, idxs) -> Tuple[np.ndarray, np.ndarray]:
        """Score frame indices of a ``TrainedOp`` via a FrameBank,
        cropping chunk-by-chunk (keeps peak memory at one chunk)."""
        batcher = ScoreBatcher(self, group_max=1)
        handle = batcher.submit(trained, bank, idxs)
        batcher.flush()
        return handle.result()

    # -- cross-query demand aggregation ---------------------------------------

    def score_demands(self, demands, *, group_max: int = 8
                      ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Score many queries' demands with fewer, larger dispatches.

        ``demands``: list of ``(trained, bank, idxs)`` — one per query.
        Batch facade over ``ScoreBatcher``: submit everything, flush,
        resolve. Returns ``[(probs, counts)]`` aligned with ``demands``.
        """
        batcher = ScoreBatcher(self, group_max=group_max)
        handles = [batcher.submit(trained, bank, idxs)
                   for trained, bank, idxs in demands]
        batcher.flush()
        return [h.result() for h in handles]


# -- fused dispatch + on-device results ---------------------------------------


class _Out:
    """One dispatch's device output, one (probs, counts) a slot it was
    split over; copied to float64 numpy once, on first consumption, the
    slots' parts joined in order — the copy waits for the launches, so
    until then the devices work while the host goes on. ``on_consume``
    (if given) fires once, at that first conversion (the ScoreBatcher's
    in-flight count).
    """

    __slots__ = ("parts", "_np", "_cb")

    def __init__(self, parts, on_consume: Optional[Callable] = None):
        self.parts = parts
        self._np: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._cb = on_consume

    def to_np(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._np is None:
            self._np = tuple(np.concatenate(
                [t.cpu().numpy() for t in ts]).astype(np.float64)
                for ts in zip(*self.parts))
            self.parts = None               # free the device buffers
            if self._cb is not None:
                self._cb()
                self._cb = None
        return self._np


class ScoreHandle:
    """Future-like per-demand result. ``result()`` waits for (and
    converts) the device tensors; everything before that is async."""

    def __init__(self, n: int):
        self._probs = np.empty(n, np.float64)
        self._counts = np.empty(n, np.float64)
        self._parts: List[Tuple[int, int, _Out, Optional[int]]] = []
        self._chunks = 0          # chunks submitted, incl. undispatched
        self._done: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @property
    def dispatched(self) -> bool:
        """All chunks issued to the device (results may still be in
        flight — that is the point)."""
        return len(self._parts) == self._chunks

    def _add_part(self, off: int, m: int, out: _Out,
                  row: Optional[int]) -> None:
        self._parts.append((off, m, out, row))

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        """(probs, counts) float64 numpy, one entry per index."""
        if self._done is None:
            if not self.dispatched:
                raise RuntimeError(
                    "ScoreHandle.result() before all chunks dispatched; "
                    "flush the ScoreBatcher first")
            for off, m, out, row in self._parts:
                p, c = out.to_np()
                if row is not None:
                    p, c = p[row], c[row]
                self._probs[off:off + m] = p[:m]
                self._counts[off:off + m] = c[:m]
            self._parts = []
            self._done = (self._probs, self._counts)
        return self._done


class ScoreBatcher:
    """Accumulates score demands and issues fused dispatches eagerly.

    ``submit`` cuts a demand into chunks immediately (host-side crop +
    pad), sends small chunks straight through the lean layer, and
    queues bucketed chunks per (signature, bucket). Three watermarks
    turn queues into dispatches, as in the JAX package:

      * **group_max** — a queue reaching ``group_max`` dispatches
        immediately as one stacked superbatch;
      * **bucket complete** — ``fire_complete(possible_sigs)``
        dispatches the queues whose signature can no longer grow;
      * **flush** — dispatches every remainder (singles go through the
        bucketed layer).

    ``in_flight`` counts dispatches whose results have not been
    consumed yet.
    """

    def __init__(self, runtime: OperatorRuntime, *, group_max: int = 8):
        self.rt = runtime
        self.group_max = max(int(group_max), 1)
        self._queues: Dict[Tuple[ArchSig, int], List[tuple]] = {}
        self.eager_dispatches = 0    # issued before flush(), any watermark
        self.watermark_fires = {"group_max": 0, "bucket_complete": 0}
        self.in_flight = 0           # dispatched, results not yet consumed

    def pending(self) -> int:
        """Chunks queued but not yet dispatched."""
        return sum(len(q) for q in self._queues.values())

    def _out(self, parts) -> _Out:
        """Wrap one dispatch's device tensors with in-flight tracking."""
        self.in_flight += 1
        return _Out(parts, on_consume=self._consumed)

    def _consumed(self) -> None:
        self.in_flight -= 1

    def submit(self, trained, bank, idxs) -> ScoreHandle:
        """Enqueue one demand; returns its handle (resolve after the
        batcher is flushed)."""
        rt = self.rt
        arch = trained.arch
        sig = arch_signature(arch)
        idxs = np.asarray(idxs, np.int64)
        handle = ScoreHandle(len(idxs))
        if len(idxs) == 0:
            return handle
        rt.frames_scored += len(idxs)
        for i in range(0, len(idxs), rt.chunk):
            sel = idxs[i:i + rt.chunk]
            x = np.asarray(bank.crops(sel, arch.region, arch.input_size),
                           np.float32)
            m = x.shape[0]
            handle._chunks += 1
            if self.group_max == 1 or rt.is_small(sig, m):
                out = self._out(rt._dispatch_chunk(sig, trained.params, x))
                handle._add_part(i, m, out, None)
                continue
            b = rt._bucket(m)
            q = self._queues.setdefault((sig, b), [])
            q.append((handle, i, m, trained.params, rt._pad_rows(x, b)))
            if len(q) >= self.group_max:
                self._dispatch_group(sig, q)
                self._queues[(sig, b)] = []
                self.eager_dispatches += 1
                self.watermark_fires["group_max"] += 1
        return handle

    def fire_complete(self, possible_sigs: Optional[Set[ArchSig]]) -> None:
        """The bucket-complete watermark: dispatch every queue whose
        signature is *not* in ``possible_sigs``. ``None`` means the
        caller cannot rule anything out: no-op."""
        if possible_sigs is None:
            return
        for (sig, _b), q in list(self._queues.items()):
            if q and sig not in possible_sigs:
                self._dispatch_group(sig, q)
                self._queues[(sig, _b)] = []
                self.eager_dispatches += 1
                self.watermark_fires["bucket_complete"] += 1

    def flush(self) -> None:
        """Dispatch every queued partial group; afterwards all submitted
        handles are resolvable."""
        for (sig, _b), q in self._queues.items():
            if q:
                self._dispatch_group(sig, q)
        self._queues.clear()
        self.rt.release_placed()

    def _dispatch_group(self, sig: ArchSig, group: List[tuple]) -> None:
        rt = self.rt
        if len(group) == 1:
            handle, off, m, params, x = group[0]
            out = self._out(rt._launch(sig, params, x, kind="bucketed"))
            handle._add_part(off, m, out, None)
            return
        xs = np.stack([g[4] for g in group])
        out = self._out(rt._launch(sig, [g[3] for g in group], xs,
                                   kind="super"))
        for row, (handle, off, m, _params, _x) in enumerate(group):
            handle._add_part(off, m, out, row)


# -- trace accounting ---------------------------------------------------------


class RetraceError(AssertionError):
    """A (arch signature, batch shape) was traced more than once."""


class TraceGuard:
    """Asserts the one-trace-per-(arch signature, batch shape) invariant
    over a code region, as in the JAX package.

    The port has no jit: a "trace" is the first dispatch of a (layer,
    signature, shape) (``OperatorRuntime._record_trace``). Dispatch
    shapes are bucketed or quantized, so each (signature, shape) should
    be new at most once; a second trace of one means two dispatch layers
    reached the same shape, or the shape vocabulary lost its bound. ::

        with TraceGuard(runtime) as guard:
            ... score ...
        # raises RetraceError on exit if any (sig, shape) retraced
        guard.traces_per_arch   # {"L2c8d16s25": 3, ...} for reports
    """

    def __init__(self, runtime: Optional[OperatorRuntime] = None):
        self.runtime = runtime
        self._before: Dict[Tuple[ArchSig, tuple], int] = {}

    def __enter__(self) -> "TraceGuard":
        if self.runtime is None:
            self.runtime = get_runtime()
        self._before = dict(self.runtime._shape_traces)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.check()
        return False

    @property
    def new_traces(self) -> Dict[Tuple[ArchSig, tuple], int]:
        """(sig, shape-key) -> traces recorded inside the region."""
        out: Dict[Tuple[ArchSig, tuple], int] = {}
        for key, n in self.runtime._shape_traces.items():
            delta = n - self._before.get(key, 0)
            if delta:
                out[key] = delta
        return out

    @property
    def traces_per_arch(self) -> Dict[str, int]:
        """sig-string -> traces inside the region, summed over shapes."""
        out: Dict[str, int] = {}
        for (sig, _shape), delta in self.new_traces.items():
            key = sig_str(sig)
            out[key] = out.get(key, 0) + delta
        return out

    def check(self) -> None:
        """Raise RetraceError if any (sig, shape) traced inside the
        region had already been traced (or traced twice inside it)."""
        bad = []
        for key, delta in self.new_traces.items():
            total = self._before.get(key, 0) + delta
            if total > 1:
                sig, shape = key
                bad.append(f"  {sig_str(sig)} shape={shape}: "
                           f"{total} traces ({delta} in guarded region)")
        if bad:
            raise RetraceError(
                "retrace detected — each (arch signature, batch shape) "
                "must trace exactly once per runtime:\n" + "\n".join(bad))


# -- process-global runtime ---------------------------------------------------

_RUNTIME: Optional[OperatorRuntime] = None


def get_runtime() -> OperatorRuntime:
    """The shared per-process runtime (on the card)."""
    global _RUNTIME
    if _RUNTIME is None:
        _RUNTIME = OperatorRuntime()
    return _RUNTIME


def set_runtime(rt: Optional[OperatorRuntime]) -> Optional[OperatorRuntime]:
    """Swap the process-global runtime (tests, or ``device="cpu"``);
    returns the previous one so callers can restore it."""
    global _RUNTIME
    prev, _RUNTIME = _RUNTIME, rt
    return prev
