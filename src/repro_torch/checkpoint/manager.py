"""Fault-tolerant checkpointing: save/restore with atomic manifests, the
port's copy of the JAX package's ``checkpoint/manager.py``.

Layout (one directory per step):
    <root>/step_000042/
        manifest.json           # step, per-model leaf files, shapes, dtypes
        <model>__<leaf-path>.npy
    <root>/LATEST               # atomic pointer (rename)

  * the manifest is written last and the LATEST pointer renamed atomically,
    so a crash mid-save never corrupts the restorable state
  * ``save_async`` snapshots to host memory synchronously and writes to disk
    on a background thread, overlapping I/O with the next train step
  * leaf paths are the JAX package's (dict keys sorted, list indices), so a
    checkpoint written by either package restores in the other where the
    trees agree

Where it differs from the JAX file: trees are nested dicts and lists of
torch tensors and Python scalars (the port's parameter and AdamW trees);
a bf16 leaf is stored as its 16-bit pattern (``uint16``) with
``"bfloat16"`` as its manifest dtype, since numpy has no bf16 without
``ml_dtypes``; a ``parallel/layout.ShardedTensor`` leaf is gathered and
stored whole; a restored tensor lands on its template leaf's device with
the template's ``requires_grad`` (a sharded template leaf: on its layout),
or, with ``shardings``, on the layout given for it, as
``jax.device_put(arr, sharding)`` places it.
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.parallel.layout import ShardedTensor

BF16 = "bfloat16"


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    """{leaf path: leaf} in the order of ``jax.tree.leaves`` (dict keys
    sorted; None is an empty subtree, as in JAX)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix[:-1]: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{k}/"))
    return flat


def _rebuild(tree, loaded: dict, prefix: str = ""):
    """``tree`` with each leaf replaced by ``loaded[its path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, loaded, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, loaded, f"{prefix}{i}/") for i, v in enumerate(tree))
    return loaded[prefix[:-1]]


def _to_host(leaf) -> np.ndarray:
    """A leaf as the numpy array that is written: a bf16 tensor as its
    16-bit pattern."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _itemsize(dtype: str) -> int:
    return 2 if dtype == BF16 else np.dtype(dtype).itemsize


def _from_host(arr: np.ndarray, dtype: str, like, layout=None):
    """The restored leaf: placed on ``layout`` when one is given (or the
    template leaf is sharded: on its layout), a tensor on ``like``'s device
    (with its ``requires_grad``) when the template leaf is a tensor, else a
    Python scalar or the array.  A bf16 leaf is read as its 16-bit pattern:
    the port writes ``uint16``, the JAX package ``np.save``s an
    ``ml_dtypes.bfloat16`` array, which loads back as the void dtype
    ``|V2``."""
    if dtype == BF16 and arr.dtype.itemsize == 2:
        arr = arr.view(np.uint16)
    if layout is None and isinstance(like, ShardedTensor):
        layout = like.layout
    if layout is not None:
        t = torch.from_numpy(np.array(arr))
        return ShardedTensor.place(t.view(torch.bfloat16) if dtype == BF16 else t, layout)
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(arr))
        if dtype == BF16:
            t = t.view(torch.bfloat16)
        t = t.to(like.device)
        return t.requires_grad_(like.requires_grad) if t.is_floating_point() else t
    if isinstance(like, (int, float)):
        return type(like)(arr)
    return arr


class CheckpointManager:
    def __init__(self, root: str | pathlib.Path, keep: int = 3):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, trees: dict[str, Any], extra: dict | None = None):
        """Synchronous save of named trees (e.g. {"actor": params, ...})."""
        self.wait()
        self._write(step, trees, extra)

    def _write(self, step: int, trees: dict[str, Any], extra: dict | None):
        tmp = self.root / f".tmp_step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "models": {}, "extra": extra or {}}
        for name, tree in trees.items():
            flat = _flatten(tree)
            keys = {}
            for key, leaf in flat.items():
                bf16 = (isinstance(leaf, (torch.Tensor, ShardedTensor))
                        and leaf.dtype == torch.bfloat16)
                arr = _to_host(leaf)
                fn = f"{name}__{re.sub('[^A-Za-z0-9_.]', '_', key)}.npy"
                np.save(tmp / fn, arr)
                keys[key] = {"file": fn, "shape": list(arr.shape),
                             "dtype": BF16 if bf16 else str(arr.dtype)}
            manifest["models"][name] = keys
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self.root / f"step_{step:09d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._update_latest(step)
        self._gc()

    def save_async(self, step: int, trees: dict[str, Any],
                   extra: dict | None = None):
        """Snapshot to host memory now; write to disk in the background,
        overlapping checkpoint I/O with the next training step."""
        self.wait()
        def snapshot(v):
            if isinstance(v, ShardedTensor):
                return v.gather("cpu")
            return v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v
        host = {name: _rebuild(tree, {k: snapshot(v) for k, v in _flatten(tree).items()})
                for name, tree in trees.items()}
        t = threading.Thread(target=self._write, args=(step, host, extra),
                             daemon=True)
        self._thread = t
        t.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _update_latest(self, step: int):
        ptr = self.root / "LATEST.tmp"
        ptr.write_text(str(step))
        ptr.rename(self.root / "LATEST")

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def list_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.root.iterdir()
                      if p.is_dir() and p.name.startswith("step_"))

    def valid_step(self, step: int) -> bool:
        """Torn-write detection: a step is restorable only if its manifest
        parses and every referenced .npy exists with at least the payload
        size the manifest promises (a crash mid-write leaves a truncated
        file; the .npy header adds bytes on top of the raw data, so
        ``st_size >= payload`` is a safe lower bound)."""
        d = self.root / f"step_{step:09d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
        except (OSError, ValueError):
            return False
        try:
            for keys in manifest.get("models", {}).values():
                for meta in keys.values():
                    f = d / meta["file"]
                    expect = int(np.prod(meta["shape"])) * \
                        _itemsize(meta["dtype"])
                    if not f.is_file() or f.stat().st_size < expect:
                        return False
        except (OSError, KeyError, TypeError, ValueError):
            return False
        return True

    def valid_steps(self) -> list[int]:
        return [s for s in self.list_steps() if self.valid_step(s)]

    def latest_step(self) -> Optional[int]:
        ptr = self.root / "LATEST"
        if ptr.exists():
            s = int(ptr.read_text().strip())
            if self.valid_step(s):
                return s
        # LATEST missing, stale, or pointing at a torn write: fall back to
        # the newest step that validates
        steps = self.valid_steps()
        return steps[-1] if steps else None

    def restore(self, template: dict[str, Any], step: Optional[int] = None,
                shardings: Optional[dict[str, Any]] = None
                ) -> tuple[int, dict[str, Any], dict]:
        """Restore named trees.  ``template`` provides tree structure and
        each leaf's device; ``shardings`` (optional, {name: layout tree of
        the same structure}) places each leaf on its ``Layout``: restoring
        into another mesh or plan reshards on the way in.

        With ``step=None``, candidate steps are tried newest-first and a
        partial/corrupt checkpoint (torn write the validation missed) is
        skipped in favour of the previous one; an explicitly requested
        ``step`` raises instead of silently restoring something else."""
        if step is not None:
            return self._restore_step(template, step, shardings)
        candidates = self.valid_steps()
        latest = self.latest_step()
        if latest is not None and latest in candidates:
            # honour the pointer first, then walk backwards
            candidates = [s for s in candidates if s != latest] + [latest]
        last_err: Optional[Exception] = None
        for s in reversed(candidates):
            try:
                return self._restore_step(template, s, shardings)
            except (OSError, KeyError, ValueError) as err:
                last_err = err
        raise FileNotFoundError(
            f"no restorable checkpoint under {self.root}"
            + (f" (last error: {last_err})" if last_err else ""))

    def _restore_step(self, template: dict[str, Any], step: int,
                      shardings: Optional[dict[str, Any]] = None
                      ) -> tuple[int, dict[str, Any], dict]:
        d = self.root / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        out = {}
        for name, tree in template.items():
            keys = manifest["models"][name]
            layouts = _flatten(shardings[name]) if shardings is not None else {}
            loaded = {key: _from_host(np.load(d / keys[key]["file"]),
                                      keys[key]["dtype"], leaf, layouts.get(key))
                      for key, leaf in _flatten(tree).items()}
            out[name] = _rebuild(tree, loaded)
        return step, out, manifest.get("extra", {})
