"""Checkpointing: atomic, resumable, failure-tolerant (PyTorch port of
``repro.train.checkpoint``, in the same on-disk format).

* atomic commit: the arrays go to ``<tag>_step<n>_shard<i>.npz.tmp`` and
  the manifest to ``.manifest.json.tmp``, then ``os.replace`` commits the
  npz first and the manifest last, so a crash mid-write never leaves a
  manifest that names a torn file;
* the manifest holds the step, the tree paths as the JAX package's
  ``jax.tree_util.keystr`` writes them (``['params']['embed']``), each
  leaf's dtype and shape, and the npz file's sha256;
* leaves are written in the JAX package's flattening order (dict keys
  sorted), as ``a0``, ``a1``, ...; dtypes numpy cannot hold (bf16, fp8)
  are stored as a same-width unsigned integer view beside their dtype
  string, as the JAX package's ``_encode`` does. So a checkpoint written
  by either package restores in the other;
* ``latest_step`` takes the newest checkpoint whose manifest is complete;
  ``restore_latest`` also checks the digest and steps back past a
  checkpoint whose file is corrupt;
* ``emergency`` writes its own tag, which retention never deletes;
  retention keeps the last ``keep`` scheduled checkpoints.

Leaves cross as numpy arrays on the host: saving copies each tensor from
its device (and allocates nothing there); restoring makes tensors on
the device the caller names.
"""
from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

_TORCH_UINT = {1: torch.uint8, 2: torch.uint16, 4: torch.uint32,
               8: torch.uint64}


def _flatten(tree, prefix: str = ""):
    """(keystr path, leaf) pairs in the JAX package's order: dict keys
    sorted, sequences by index; ``None`` and empty containers hold no
    leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def _rebuild(like, leaves: dict, prefix: str = ""):
    """``like``'s structure with each leaf taken from ``leaves`` by
    path."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(like))
    if like is None:
        return None
    return leaves[prefix]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _encode(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host numpy array of ``t`` and its dtype string; a dtype numpy
    cannot hold is stored as its same-width unsigned integer view."""
    name = _dtype_name(t)
    t = t.detach().contiguous()
    if name not in np.sctypeDict or np.dtype(name).kind not in "fiub?":
        t = t.view(_TORCH_UINT[t.element_size()])
    return t.cpu().numpy(), name


def _decode(arr: np.ndarray, dtype_str: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if str(arr.dtype) != dtype_str:
        t = t.view(getattr(torch, dtype_str))
    return t.to(device)


def _file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, shard_id: int = 0):
        self.dir = directory
        self.keep = keep
        self.shard_id = shard_id
        os.makedirs(directory, exist_ok=True)

    # -- paths -------------------------------------------------------------
    def _base(self, step: int, tag: str = "ckpt") -> str:
        return os.path.join(self.dir,
                            f"{tag}_step{step:010d}_shard{self.shard_id}")

    def _manifest_path(self, base: str) -> str:
        return base + ".manifest.json"

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state: dict, tag: str = "ckpt") -> str:
        """Write ``state`` (nested dicts, lists and tuples of tensors)
        as checkpoint ``step``; returns its base path."""
        base = self._base(step, tag)
        flat = list(_flatten(state))
        names = [f"a{i}" for i in range(len(flat))]
        encoded = [_encode(t) for _, t in flat]
        tmp_npz = base + ".npz.tmp"
        with open(tmp_npz, "wb") as f:
            np.savez(f, **{n: a for n, (a, _) in zip(names, encoded)})
        manifest = {
            "step": step,
            "tag": tag,
            "time": time.time(),
            "paths": [p for p, _ in flat],
            "names": names,
            "dtypes": [d for _, d in encoded],
            "shapes": [list(t.shape) for _, t in flat],
            "sha256": _file_digest(tmp_npz),
            "complete": True,
        }
        tmp_mani = self._manifest_path(base) + ".tmp"
        with open(tmp_mani, "w") as f:
            json.dump(manifest, f)
        # atomic commit: npz first, manifest last (manifest = commit point)
        os.replace(tmp_npz, base + ".npz")
        os.replace(tmp_mani, self._manifest_path(base))
        self._gc(tag)
        return base

    def emergency(self, step: int, state: dict) -> str:
        """Panic save on a failure: its own tag, never deleted by the
        regular retention."""
        return self.save(step, state, tag="emergency")

    # -- restore -------------------------------------------------------------
    def _steps(self, tag: str) -> list[int]:
        steps = []
        for fn in os.listdir(self.dir):
            if fn.startswith(f"{tag}_step") and fn.endswith(".manifest.json"):
                try:
                    with open(os.path.join(self.dir, fn)) as f:
                        m = json.load(f)
                    if m.get("complete"):
                        steps.append(m["step"])
                except (json.JSONDecodeError, KeyError):
                    continue  # torn manifest -> not a valid checkpoint
        return steps

    def latest_step(self, tag: str = "ckpt") -> int | None:
        steps = self._steps(tag)
        return max(steps) if steps else None

    def restore(self, step: int, like: dict, tag: str = "ckpt", *,
                device="cuda") -> dict:
        """Checkpoint ``step`` in the structure of ``like`` (tensors,
        meta tensors included, or anything with ``shape`` and
        ``dtype``), its tensors made on ``device``. Raises ``IOError``
        when the file fails its digest and ``ValueError`` when a path,
        shape or dtype differs from ``like``."""
        base = self._base(step, tag)
        with open(self._manifest_path(base)) as f:
            manifest = json.load(f)
        npz_path = base + ".npz"
        if _file_digest(npz_path) != manifest["sha256"]:
            raise IOError(f"checkpoint {base} failed integrity check")
        want = dict(_flatten(like))
        if sorted(want) != sorted(manifest["paths"]):
            raise ValueError(f"checkpoint {base} holds paths "
                             f"{manifest['paths']}, expected {sorted(want)}")
        leaves = {}
        with np.load(npz_path) as data:
            for path, name, dtype in zip(manifest["paths"], manifest["names"],
                                         manifest["dtypes"]):
                t = _decode(data[name], dtype, device)
                ref = want[path]
                if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
                    raise ValueError(
                        f"checkpoint leaf {path}: {tuple(t.shape)} {t.dtype} "
                        f"!= {tuple(ref.shape)} {ref.dtype}")
                leaves[path] = t
        return _rebuild(like, leaves)

    def restore_latest(self, like: dict, tag: str = "ckpt", *,
                       device="cuda") -> tuple[int, dict] | None:
        """The newest checkpoint of ``tag`` or of an emergency save (the
        later of the two; the emergency one when both have the step)
        whose file passes its digest, as ``(step, state)``; ``None``
        when there is none."""
        cands = [(s, t) for t in (tag, "emergency") for s in self._steps(t)]
        for step, t in sorted(cands, reverse=True):
            try:
                return step, self.restore(step, like, tag=t, device=device)
            except IOError:
                continue   # corrupt file -> the next older checkpoint
        return None

    # -- retention -----------------------------------------------------------
    def _gc(self, tag: str) -> None:
        if tag != "ckpt":
            return
        manis = sorted(fn for fn in os.listdir(self.dir)
                       if fn.startswith("ckpt_step")
                       and fn.endswith(".manifest.json"))
        excess = manis[:-self.keep] if self.keep else []
        for fn in excess:
            base = os.path.join(self.dir, fn[:-len(".manifest.json")])
            for suffix in (".manifest.json", ".npz"):
                try:
                    os.remove(base + suffix)
                except FileNotFoundError:
                    pass
