"""Fault-tolerant checkpointing, the JAX package's semantics and layout.

Ported from ``repro/train/checkpoint.py``:
  * atomic two-phase commit: write to ``step_N.tmp/`` -> fsync -> rename
    to ``step_N/`` -> update ``LATEST`` (a crash never leaves a partial
    checkpoint looking valid);
  * per-leaf .npy files keyed by the leaf's path in the saved tree (for
    a training run ``params/<named_parameters name>`` and
    ``opt/step``, ``opt/m/<name>``, ``opt/v/<name>``) and a
    ``manifest.json``; restore is structure-checked, partial restores
    fail loudly;
  * the data-pipeline cursor and optimizer step are part of the payload,
    so a resumed run continues the exact sample stream;
  * ``keep`` rotation bounds disk; ``restore_latest`` tolerates a
    corrupt newest checkpoint by falling back to the previous one.

Under data parallelism (``group``: a ``torch.distributed`` process
group) rank 0 writes and every rank waits at a barrier until it has, so
no rank runs ahead of a checkpoint that a restart would read; every
rank restores from the same directory.

A tree is nested dicts and NamedTuples (``OptState``) whose leaves are
tensors, NumPy arrays or Python numbers. NumPy has no bfloat16: a
bfloat16 tensor is stored as its 16 bits (int16) with ``bfloat16`` as
its dtype in the manifest. A restored tensor takes the device and type
of the like-tree's leaf.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _items(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return tree._asdict().items()
    if isinstance(tree, Mapping):
        return tree.items()
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflatten(like, leaves: Dict[str, Any], prefix: str = ""):
    items = _items(like)
    if items is None:
        return leaves[prefix]
    out = {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else str(k))
           for k, v in items}
    return type(like)(**out) if isinstance(like, tuple) else out


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, want):
    if isinstance(want, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device=want.device, dtype=want.dtype)
    if isinstance(want, (bool, int, float)):
        return type(want)(arr.item())
    return arr.astype(np.asarray(want).dtype)


def save(ckpt_dir: str, step: int, tree, *, extra: Optional[dict] = None,
         keep: int = 3, group=None) -> Path:
    """Atomic checkpoint save. Returns the committed directory. With a
    process ``group``, rank 0 saves and every rank returns after it has."""
    if group is not None:
        import torch.distributed as dist
        if dist.get_rank(group) == 0:
            save(ckpt_dir, step, tree, extra=extra, keep=keep)
        dist.barrier(group=group)
        return Path(ckpt_dir) / f"step_{step:09d}"
    root = Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f"step_{step:09d}.tmp"
    final = root / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    files = set()
    for key, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        fname = re.sub(r"[^\w\-\[\]]", "_", key) + ".npy"
        if fname in files:
            raise ValueError(f"two leaves map to the file {fname}")
        files.add(fname)
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # commit
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest = root / "LATEST"
    with open(latest, "w") as f:
        f.write(final.name)
        f.flush()
        os.fsync(f.fileno())
    # rotate
    ckpts = sorted(p for p in root.iterdir()
                   if p.is_dir() and re.fullmatch(r"step_\d{9}", p.name))
    for old in ckpts[:-keep]:
        shutil.rmtree(old)
    return final


def _load_dir(path: Path, like_tree) -> Tuple[Any, dict]:
    with open(path / "manifest.json") as f:
        manifest = json.load(f)
    flat_like = _flatten(like_tree)
    if set(flat_like) != set(manifest["leaves"]):
        missing = set(flat_like) ^ set(manifest["leaves"])
        raise ValueError(f"checkpoint/tree structure mismatch: "
                         f"{sorted(missing)[:5]}")
    leaves = {}
    for key, info in manifest["leaves"].items():
        arr = np.load(path / info["file"])
        want = flat_like[key]
        if tuple(arr.shape) != tuple(np.shape(want)):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{arr.shape} vs {tuple(np.shape(want))}")
        leaves[key] = _from_numpy(arr, info["dtype"], want)
    return _unflatten(like_tree, leaves), manifest


def restore_latest(ckpt_dir: str, like_tree) -> Optional[Tuple[Any, dict]]:
    """Restore the newest valid checkpoint (fall back past corrupt ones)."""
    root = Path(ckpt_dir)
    if not root.exists():
        return None
    ckpts = sorted((p for p in root.iterdir()
                    if p.is_dir() and re.fullmatch(r"step_\d{9}", p.name)),
                   reverse=True)
    for path in ckpts:
        try:
            return _load_dir(path, like_tree)
        except Exception as e:  # noqa: BLE001 — corrupt ckpt: fall back
            print(f"[checkpoint] {path.name} unusable ({e}); falling back")
    return None
