"""Does a training step's gradient depend on what the process ran before?

    PYTHONPATH=src python -m benchmarks.torch_step_bits [--layers 2]

granite-moe-3b-a800m at full width, cut to ``--layers`` layers, one batch
of 4 x 1024 synthetic tokens, the loss and every parameter's gradient by
autograd through the port's kernels, in PyTorch's deterministic mode as
``train_step.deterministic`` sets it: in bf16 compute (as
``launch.train`` runs the published config) and in float32 (as
``chip_smoke.py``'s parity step runs it). For each type, in one process:

1. the step fresh;
2. the step again after other work: odd-sized allocations held across
   it (the caching allocator then hands out other addresses), matmuls of
   other shapes, a no-grad forward and a training step at other batches;
3. the step with ``torch.utils.deterministic.fill_uninitialized_memory``
   on (fresh tensors filled with NaN: a NaN in a gradient names a reader
   of memory it never wrote);
4. the step with ``warn_only=False``: every operation without a
   deterministic path raises; the first one is printed.

Steps 1 and 2 also record a fingerprint of every PyTorch operation's
output in call order (``TorchDispatchMode``; the port's own kernels are
called through ctypes and show in the first operation that reads their
output), and the first operation whose output bits differ is printed.
Each gradient's fingerprint is compared with step 1's. Before all that, it
asks which float ``cumsum`` calls raise in deterministic mode on the card
(along the last and a non-last axis). Needs a CUDA card.
"""
from __future__ import annotations

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs.base import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train import train_step as steps  # noqa: E402

ARCH = "granite-moe-3b-a800m"
BATCH, SEQ = 4, 1024
# operations whose output is not yet written
UNWRITTEN = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided")


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def fingerprint(t: torch.Tensor) -> torch.Tensor:
    """Two sums over the tensor's bits (its values' sum and
    their squares' sum, as integers): a last-bit change moves them."""
    flat = t.detach().contiguous().view(-1)
    if flat.numel() == 0:
        return torch.zeros(2, dtype=torch.float64, device=t.device)
    if flat.dtype == torch.bool:
        flat = flat.to(torch.uint8)
    elif flat.is_floating_point() or flat.is_complex():
        flat = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}[flat.element_size()])
    v = flat.to(torch.float64)
    return torch.stack([flat.sum(dtype=torch.int64).to(torch.float64),
                        v.square().sum()])


class Fingerprints(TorchDispatchMode):
    """Records (operation, output shapes) and a fingerprint of every
    tensor output of every operation dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.names, self.prints = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in UNWRITTEN:
            return out
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if isinstance(o, torch.Tensor):
                self.names.append(f"{func} -> {tuple(o.shape)} {o.dtype}")
                self.prints.append(fingerprint(o))
        return out

    def table(self) -> np.ndarray:
        return torch.stack(self.prints).cpu().numpy() if self.prints \
            else np.zeros((0, 2))


def make(dtype: str, layers: int, device, smoke: bool = False):
    cfg = (get_smoke_config if smoke else get_config)(ARCH).scaled(
        num_layers=layers, compute_dtype=dtype)
    model = tf.init_model(cfg, torch.Generator(device=device).manual_seed(0),
                          device, trainable=True)
    rng = np.random.default_rng(0)
    batch = steps.to_batch({
        "tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)),
        "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ))}, device)
    return cfg, model, batch


def grads_of(model, batch, mode=None):
    for p in model.parameters():
        p.grad = None
    with steps.deterministic(), (mode or contextlib.nullcontext()):
        loss = tf.train_loss(model, batch)
        loss.backward()
    grads = {n: fingerprint(p.grad) for n, p in model.named_parameters()}
    grads_of.nonfinite = [n for n, p in model.named_parameters()
                          if not torch.isfinite(p.grad).all()]
    for p in model.parameters():
        p.grad = None
    sync()
    return loss.detach().clone(), grads


def other_work(cfg, model, device, seed: int):
    """Allocations of odd sizes (half of them kept, returned to the
    caller so that they stay allocated), matmuls of other shapes, a
    no-grad forward of the model and a training step at other batches."""
    rng = np.random.default_rng(seed)
    junk = [torch.empty(int(n), dtype=torch.uint8, device=device)
            for n in rng.integers(1, 40_000_000 if device.type == "cuda"
                                  else 4000, 48)]
    kept = junk[::2]
    del junk
    for m, k, n in ((37, 1536, 333), (1000, 77, 1536), (4095, 1536, 513)):
        a = torch.randn(m, k, device=device, dtype=torch.bfloat16)
        b = torch.randn(k, n, device=device, dtype=torch.bfloat16)
        (a @ b).float().sum().item()
    with torch.no_grad():
        tokens = torch.randint(0, cfg.vocab_size, (3, 333), device=device)
        tf.forward_hidden(model, tokens)
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), device=device)
    grads_of(model, {"tokens": tokens, "labels": tokens})
    sync()
    return kept


def compare(ref_grads, grads) -> list:
    """Names of the parameters whose gradient's fingerprint differs from
    ``ref_grads``'s, in parameter order, with the two fingerprints."""
    return [(n, ref_grads[n].tolist(), grads[n].tolist()) for n in ref_grads
            if not torch.equal(ref_grads[n], grads[n])]


def first_difference(a: Fingerprints, b: Fingerprints) -> str:
    ta, tb = a.table(), b.table()
    n = min(len(ta), len(tb))
    same_names = a.names[:n] == b.names[:n]
    diff = np.nonzero(np.any(ta[:n] != tb[:n], axis=1))[0]
    head = (f"{len(ta)} and {len(tb)} recorded outputs, the operation "
            f"sequence {'the same' if same_names else 'different'}")
    if len(diff) == 0:
        return head + "; every output's bits equal"
    i = int(diff[0])
    ctx = "\n".join(f"    [{j}] {a.names[j]}" for j in range(max(0, i - 6),
                                                          i + 1))
    return (head + f"; {len(diff)} outputs differ, the first at [{i}]:\n"
            + ctx + (f"\n    (run 2 there: {b.names[i]})"
                     if b.names[i] != a.names[i] else ""))


def cumsum_probe(device) -> None:
    x = torch.randn(4, 256, 6, device=device)
    for dim in (1, -1):
        try:
            torch.use_deterministic_algorithms(True)
            torch.cumsum(x, dim=dim)
            torch.cuda.synchronize()
            print(f"cumsum float32 dim {dim} of (4, 256, 6): no error")
        except RuntimeError as e:
            print(f"cumsum float32 dim {dim} of (4, 256, 6): raises: "
                  f"{str(e).splitlines()[0]}")
        finally:
            torch.use_deterministic_algorithms(False)


def run(dtype: str, layers: int, device, smoke: bool = False) -> dict:
    cfg, model, batch = make(dtype, layers, device, smoke)
    grads_of(model, batch)   # builds the kernels, warms the libraries
    first = Fingerprints()
    loss1, g1 = grads_of(model, batch, first)
    loss1b, g1b = grads_of(model, batch)
    kept = other_work(cfg, model, device, seed=1)
    second = Fingerprints()
    loss2, g2 = grads_of(model, batch, second)
    loss2b, g2b = grads_of(model, batch)
    out = {"repeat": compare(g1, g1b), "after_other_work": compare(g1, g2),
           "after_other_work_untraced": compare(g1, g2b)}
    print(f"{dtype}: {len(g1)} gradients; loss fresh {float(loss1)!r}, "
          f"again {float(loss1b)!r}, after other work {float(loss2)!r} / "
          f"{float(loss2b)!r}")
    for k, v in out.items():
        print(f"  {k}: {len(v)} gradients differ" +
              "".join(f"\n    {n}: {a} against {b}" for n, a, b in v[:12]))
    print("  first operation whose output differs (fresh against after "
          "other work): " + first_difference(first, second))
    kept.clear()   # the held allocations are let go
    del first, second
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    det = torch.utils.deterministic
    det_fill = det.fill_uninitialized_memory

    @contextlib.contextmanager
    def filled():
        # steps.deterministic turns the fill off; the patch keeps it on
        real = steps.deterministic

        @contextlib.contextmanager
        def keep_fill():
            with real():
                det.fill_uninitialized_memory = True
                yield
        steps.deterministic = keep_fill
        try:
            yield
        finally:
            steps.deterministic = real
            det.fill_uninitialized_memory = det_fill

    with filled():
        loss3, g3 = grads_of(model, batch)
    nan = grads_of.nonfinite
    print(f"  with fill_uninitialized_memory: loss {float(loss3)!r}; "
          f"non-finite gradients {nan[:12]}; differing from fresh "
          f"{len(compare(g1, g3))}")

    @contextlib.contextmanager
    def strict():
        real = steps.deterministic

        @contextlib.contextmanager
        def raising():
            with real():
                torch.use_deterministic_algorithms(True)
                yield
        steps.deterministic = raising
        try:
            yield
        finally:
            steps.deterministic = real

    with strict():
        try:
            loss4, g4 = grads_of(model, batch)
            print(f"  warn_only=False: no operation raised; differing from "
                  f"fresh {len(compare(g1, g4))}")
        except RuntimeError as e:
            print(f"  warn_only=False: raised: {str(e).splitlines()[0]}")
    torch.use_deterministic_algorithms(False)
    del model
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (a rehearsal, with --device cpu)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=False).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')}")
    if device.type == "cuda":
        cumsum_probe(device)
    bad = 0
    for dtype in args.dtypes.split(","):
        out = run(dtype, args.layers, device, args.smoke)
        bad += sum(len(v) for v in out.values())
    print(f"gradients differing in all: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
