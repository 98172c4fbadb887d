"""Training checkpoints in the reference's on-disk format.

One ``.npy`` a leaf of the reference's tree (``0__layers__attn__wq.npy``
holds the stacked (L, dm, h, dh) array of ``(params, opt_state)``; bf16 as
its ``uint16`` view) and a ``manifest.json`` with each leaf's path, file,
shape, dtype and sha256.  So a checkpoint written by either package loads
in the other.

* atomic: written under ``step_XXXXXXXX.tmp`` and renamed; a crash mid-way
  never leaves a torn latest checkpoint;
* durable: each file and the manifest are fsync'd, and the directory after
  the rename (the rename is only durable once the root is);
* verified: a leaf whose digest differs from the manifest's raises
  :class:`~repro_torch.runtime.faults.CorruptSegment` (a manifest without
  digests loads unchecked);
* the last 3 checkpoints are kept.

A tree is anything ``core.tree.flatten`` walks: a model (its reference
leaves), an ``OptState``, tuples, dicts, tensors.  Each leaf is stacked on
the host alone, one at a time.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.convert import array_from_tensor, tensor_from_array
from repro_torch.core.tree import flatten
from repro_torch.runtime.faults import CorruptSegment, Fault

KEEP = 3


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _step_dirs(root: str) -> list[str]:
    return sorted(d for d in os.listdir(root)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def save_checkpoint(root: str, step: int, tree,
                    extra_meta: dict | None = None) -> str:
    """Write ``tree`` as checkpoint ``step`` under ``root``; returns its
    directory."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra_meta or {}}
    for path, leaf in flatten(tree):
        fn = path.replace("/", "__") + ".npy"
        arr = array_from_tensor(leaf.full())
        dtype = "bfloat16" if leaf.dtype == torch.bfloat16 else str(arr.dtype)
        buf = io.BytesIO()
        np.save(buf, arr)
        data = buf.getvalue()
        with open(os.path.join(tmp, fn), "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({"path": path, "file": fn,
                                   "shape": list(arr.shape), "dtype": dtype,
                                   "sha256": hashlib.sha256(data).hexdigest()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_path(root)
    for d in _step_dirs(root)[:-KEEP]:
        shutil.rmtree(os.path.join(root, d))
    return final


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in _step_dirs(root)]
    return max(steps) if steps else None


def load_checkpoint(root: str, template, step: int | None = None):
    """Read checkpoint ``step`` (the latest by default) into the tensors of
    ``template``, in place, each cast to its tensor's dtype.  Returns
    (template, step, extra_meta)."""
    step = step if step is not None else latest_step(root)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {e["path"]: e for e in manifest["leaves"]}
    for path, leaf in flatten(template):
        e = by_name[path]
        with open(os.path.join(d, e["file"]), "rb") as f:
            data = f.read()
        want = e.get("sha256")
        if want is not None:
            got = hashlib.sha256(data).hexdigest()
            if got != want:
                raise CorruptSegment(Fault(
                    kind="corruption", store=d,
                    message=f"checkpoint leaf {e['file']} digest mismatch "
                            f"(manifest {want[:12]}…, file {got[:12]}…) — "
                            f"refusing to resume from rotted bytes"))
        arr = np.load(io.BytesIO(data))
        full = tensor_from_array(
            arr, "cpu", view_as=torch.bfloat16
            if e["dtype"] == "bfloat16" else None).reshape(leaf.shape)
        rows = full if leaf.stacked else full[None]
        with torch.no_grad():
            for t, row in zip(leaf.tensors, rows):
                t.copy_(row)
    return template, manifest["step"], manifest["extra"]
