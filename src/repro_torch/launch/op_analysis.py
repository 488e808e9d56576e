"""Op-level cost count of a step: FLOPs, bytes and collectives.

The counterpart of ``repro/launch/hlo_analysis.py``, which reads the
FLOPs, bytes and collectives of a step from the HLO text XLA compiled it
to. HLO text is an XLA artifact with no PyTorch counterpart: the port
runs eager ops, one at a time, and no compiler ever sees the whole step.
So this module counts the ops themselves, as they run, on any device
(``meta`` included, where nothing is computed):

* **aten ops**, through a ``TorchDispatchMode`` (``OpCounter``), per op:
  FLOPs of ``mm``, ``addmm``, ``bmm`` and ``baddbmm`` as 2·M·N·K,
  convolutions by their taps, reductions as 1 per input value, data
  movement (copies, gathers, scatters, sorts, fills) as none, views and
  allocations as nothing at all, and every other op as 1 per output
  value; bytes as each distinct storage the op reads or writes, counted
  once an op (a view by the elements it spans; an indexed read or write
  by the rows it moves, not the whole tensor it indexes). This is the
  eager analogue of HloCostAnalysis's top-level bytes: eager PyTorch
  fuses nothing, so each op's operands and results cross memory. The
  mode sits below autograd, so it sees the backward and the recompute of
  every checkpointed (rematerialised) block, as the HLO count does. Ops
  on tensors of another device (the CPU scalars of the optimizer's
  schedule) are not the step's device work and are left out.
* **hand-written kernels**, which the mode cannot see (``build.launch``
  is a raw-pointer call): each kernel module has a ``cost(...) ->
  (flops, bytes)`` from its shapes, and its wrapper reports it through
  ``kernels/count.py`` whenever a counter is active, on every device
  (the card's launch, the CPU's plain version, ``meta``'s empty result),
  with the aten ops of the wrapper's own body not counted. So a step
  counts the same on ``meta``, the CPU and the card.
* **collectives the step calls**, as they run: each of
  ``parallel/ops.py``'s collectives (the model axis's; FSDP's weight
  gathers over "data" and its gradients' reduce-scatters, which run as
  n all-gathers, one for each rank's float32 slice; the ``gather_sum``
  of the loss and of each MoE layer's router statistics) reports its
  kind and its output bytes through ``kernels/count.collective`` (on
  ``meta`` nothing is sent, the receive buffers are only shaped), so a step
  counts its own collectives, a rematerialised block's again in its
  backward;
* **the gradient sums after the backward**, from the port's own plan
  (``collective_plan``): the float32 buckets that
  ``train/train_step.sum_gradients`` all-gathers for the weights every
  data rank holds whole, and over a pod axis the sliced weights' sum,
  by type as the JAX ``collectives``.

Counts are Python integers, so two counts of one step compare exactly.
"""
from __future__ import annotations

import contextlib
import math
from collections import defaultdict
from typing import Dict, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import count as kernel_count
from repro_torch.train import train_step as steps

MATMULS = {"mm", "addmm", "bmm", "baddbmm"}
CONVS = {"convolution", "convolution_backward"}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
              "logsumexp", "_softmax", "_log_softmax", "norm",
              "linalg_vector_norm", "cumsum", "cumprod", "var", "std",
              "var_mean", "std_mean", "any", "all", "argmax", "argmin",
              "_softmax_backward_data", "_log_softmax_backward_data"}
# ops that move data and compute nothing
MOVES = {"copy_", "_to_copy", "clone", "cat", "stack", "roll", "flip",
         "constant_pad_nd", "repeat", "sort", "topk", "fill_", "zero_",
         "zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
         "new_zeros", "new_ones", "new_full", "arange", "slice_scatter",
         "select_scatter", "as_strided_scatter", "masked_fill_",
         "lift_fresh_copy"}
# ops that read (gather) or write (scatter) rows of a tensor they index:
# op -> (the indexed argument's position, whether the op writes it)
INDEXED = {"index": (0, False), "_unsafe_index": (0, False),
           "index_select": (0, False), "gather": (0, False),
           "embedding": (0, False), "index_put_": (0, True),
           "index_put": (0, True), "_index_put_impl_": (0, True),
           "index_add_": (0, True), "index_add": (0, True),
           "scatter": (0, True), "scatter_": (0, True),
           "scatter_add": (0, True), "scatter_add_": (0, True),
           "index_copy_": (0, True), "index_fill_": (0, True)}
# allocations and metadata: nothing read, nothing computed
# (``_unsafe_view`` is a view its schema does not mark as one)
FREE = {"empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "detach", "alias", "lift_fresh", "resize_",
        "set_", "_local_scalar_dense", "record_stream", "_unsafe_view"}
# ops whose scratch buffer is the device kernel's own (full-size on the
# CPU and meta, empty on CUDA): only the leading results or operands
# count, so a step counts the same on every device
SCRATCH = {"log_sigmoid_forward": ("outputs", 1),
           "log_sigmoid_backward": ("inputs", 2)}
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

def _view_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a tensor view spans (a broadcast dim of
    stride 0 once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors: List[torch.Tensor]) -> int:
    """Each distinct storage once: the union of its views' elements,
    at most the storage."""
    views: Dict[int, Dict[tuple, int]] = {}
    cap: Dict[int, int] = {}
    for t in tensors:
        s = t.untyped_storage()
        key = s._cdata
        cap[key] = s.nbytes()
        views.setdefault(key, {})[(t.storage_offset(), tuple(t.shape),
                                   t.stride())] = _view_bytes(t)
    return sum(min(cap[k], sum(v.values())) for k, v in views.items())


def _matmul_flops(name: str, args) -> int:
    if name == "mm":
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "addmm":
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _conv_flops(name: str, args, out) -> int:
    """2 operations a tap (Cin/groups x the kernel's spatial size) of
    each output value; the backward as much for each gradient it
    computes."""
    if name == "convolution":
        w = args[1]
        return 2 * out.numel() * w.shape[1] * math.prod(w.shape[2:])
    dy, w, mask = args[0], args[2], args[10]
    fwd = 2 * dy.numel() * w.shape[1] * math.prod(w.shape[2:])
    return fwd * sum(bool(m) for m in mask[:2])


def _flop_class(tensors: List[torch.Tensor]) -> str:
    """The peak an op's operations are held to: ``bfloat16`` when a
    floating operand is bf16 or fp16 (the tensor cores' dense rate),
    else ``float32`` (the CUDA cores'; integer work included)."""
    for t in tensors:
        if t.dtype in (torch.bfloat16, torch.float16):
            return "bfloat16"
    return "float32"


class OpCounter(TorchDispatchMode):
    """Counts the aten ops that run on ``device_type`` while it is the
    active mode, and the kernels reported through ``kernels/count.py``
    (``add_kernel``; ``paused`` above 0 while a kernel wrapper's own aten
    ops run). Totals:
    ``flops``, ``bytes``, ``flops_by_class``; tables: ``op_flops``,
    ``op_bytes``, ``op_calls`` by aten op, ``kernels`` by kernel."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.op_flops: Dict[str, int] = defaultdict(int)
        self.op_bytes: Dict[str, int] = defaultdict(int)
        self.op_calls: Dict[str, int] = defaultdict(int)
        self.flops_by_class: Dict[str, int] = defaultdict(int)
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.collectives: Dict[str, Dict[str, int]] = {}
        self.paused = 0

    # -- aten ops -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if name in FREE or getattr(func, "is_view", False):
            return
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if name in SCRATCH:
            which, n = SCRATCH[name]
            ins, outs = (ins, outs[:n]) if which == "outputs" else \
                (ins[:n], outs)
        ins = [t for t in ins if t.device.type == self.device_type]
        outs = [t for t in outs if t.device.type == self.device_type]
        if not ins and not outs:
            return
        if name in INDEXED:
            nbytes = self._indexed_bytes(name, args, ins, outs)
        else:
            nbytes = _storage_bytes(ins + outs)
        if name in MATMULS:
            flops = _matmul_flops(name, args)
        elif name in CONVS:
            flops = _conv_flops(name, args, outs[0] if outs else None)
        elif name in REDUCTIONS:
            flops = ins[0].numel() if ins else 0
        elif name in MOVES or name in INDEXED:
            flops = 0
        else:
            flops = sum(t.numel() for t in outs)
        self.op_calls[name] += 1
        self.op_flops[name] += flops
        self.op_bytes[name] += nbytes
        self.flops_by_class[_flop_class(ins + outs)] += flops

    @staticmethod
    def _indexed_bytes(name, args, ins, outs) -> int:
        """An indexed op moves as many of the indexed tensor's elements
        as it reads or writes (the output's, or the values'), not the
        whole tensor; its other operands and results count whole."""
        pos, writes = INDEXED[name]
        target = args[pos]
        rest = [t for t in ins + outs if t is not target and
                not (writes and t.untyped_storage()._cdata ==
                     target.untyped_storage()._cdata)]
        if writes:
            moved = max((t.numel() for t in rest
                         if t.dtype == target.dtype), default=0)
        else:
            moved = max((t.numel() for t in outs), default=0)
        return _storage_bytes(rest) + moved * target.element_size()

    # -- hand-written kernels -----------------------------------------------

    def add_kernel(self, name: str, flops: int, nbytes: int,
                   flop_class: str) -> None:
        row = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                             "bytes": 0})
        row["calls"] += 1
        row["flops"] += int(flops)
        row["bytes"] += int(nbytes)
        self.flops_by_class[flop_class] += int(flops)

    def add_collective(self, kind: str, nbytes: int) -> None:
        row = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
        row["count"] += 1
        row["bytes"] += int(nbytes)

    # -- totals ---------------------------------------------------------------

    @property
    def flops(self) -> int:
        return sum(self.op_flops.values()) + \
            sum(k["flops"] for k in self.kernels.values())

    @property
    def bytes(self) -> int:
        return sum(self.op_bytes.values()) + \
            sum(k["bytes"] for k in self.kernels.values())

    def tables(self, top: int = 8) -> Dict[str, Dict[str, int]]:
        """The largest ``top`` entries of FLOPs and of bytes, over aten
        ops and kernels (a kernel under ``kernel:<name>``), as the JAX
        ``reanalyze``'s ``op_flops_top`` and ``op_bytes_top``."""
        flops = dict(self.op_flops)
        nbytes = dict(self.op_bytes)
        for k, row in self.kernels.items():
            flops[f"kernel:{k}"] = row["flops"]
            nbytes[f"kernel:{k}"] = row["bytes"]

        def largest(d):
            return dict(sorted(((k, v) for k, v in d.items() if v),
                               key=lambda kv: (-kv[1], kv[0]))[:top])
        return {"op_flops_top": largest(flops),
                "op_bytes_top": largest(nbytes)}

    def summary(self) -> dict:
        """Integers only: the totals, the FLOPs by peak class, every
        kernel's calls, FLOPs and bytes, the collectives' count and bytes
        by kind, and the aten op calls."""
        return {"flops": self.flops, "bytes": self.bytes,
                "flops_by_class": dict(sorted(self.flops_by_class.items())),
                "kernels": {k: dict(v) for k, v in
                            sorted(self.kernels.items())},
                "collectives": {k: dict(v) for k, v in
                                sorted(self.collectives.items())},
                "op_calls": dict(sorted(self.op_calls.items()))}


@contextlib.contextmanager
def count(device_type: str) -> Iterator[OpCounter]:
    """Count what runs on ``device_type`` inside the block."""
    counter = OpCounter(device_type)
    kernel_count.ACTIVE.append(counter)
    try:
        with counter:
            yield counter
    finally:
        kernel_count.ACTIVE.pop()


# -- collectives --------------------------------------------------------------

def collective_plan(model, ranks: int, train: bool,
                    data: int = 1) -> dict:
    """The collectives that follow one training step's backward on a
    mesh whose batch axes span ``ranks`` processes and whose "data" axis
    slices the weights over ``data`` of them, by type, as the JAX
    ``collectives``: for each, its count and its output bytes a device.
    The gradient buckets of ``train_step.sum_gradients`` (float32, each
    an all-gather of its ranks' parts): the weights every data rank
    holds whole over all ``ranks``, and the sliced ones (``model.
    data_dims``, already reduce-scattered over "data" in the backward)
    over the pod axis's ``ranks / data`` replicas of each slice. What
    the step calls itself is counted as it runs, not here. Serving sends
    nothing after the step."""
    out = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}
    if train:
        gather = out["all-gather"]
        sliced = model.data_dims
        for n_ranks, numels in (
                (ranks, [p.numel() for n, p in model.named_parameters()
                         if n not in sliced]),
                (ranks // data, [p.numel() for n, p in
                                 model.named_parameters() if n in sliced])):
            if n_ranks < 2 or not sum(numels):
                continue
            for bucket in steps.gradient_buckets(numels):
                gather["count"] += 1
                gather["bytes"] += n_ranks * 4 * sum(n for _, _, n in bucket)
    out["total_bytes"] = sum(v["bytes"] for v in out.values()
                             if isinstance(v, dict))
    return out
