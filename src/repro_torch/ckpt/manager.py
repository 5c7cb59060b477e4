"""Sharded, async, atomic checkpointing in the reference's on-disk format.

The port of ``repro.ckpt.manager``. Checkpoints move both ways: either
package's manager reads what the other wrote. Layout (one directory per
step)::

    <root>/step_000042/
        manifest.json        # {"step", "extra", "leaves": {key: {shape,
                             #  dtype, files}}}
        <leaf>.s00.npy ...   # per-leaf shards, split along axis 0

Leaf keys are the reference's ``_flatten`` strings: tuple items by index,
dict keys sorted, NamedTuple fields as ``.field``; a ``(params,
opt_state)`` checkpoint holds ``0/embed``, ``0/layers/wq``, ``1/.step``,
``1/.mu/embed``, ... File names are the key with ``/`` -> ``__`` plus
``.sNN.npy``, at most ``n_shards`` shards. bf16 leaves are written as the
reference's ``np.save`` writes ml_dtypes' bfloat16 (descr ``'<V2'``, the
raw bits; manifest dtype ``"bfloat16"``) and read back through their
uint16 bits, so no ml_dtypes is needed.

Guarantees kept from the reference: an atomic commit (shards and manifest
are fsync'd in ``.tmp-step_N``, then the directory is renamed); async
saves that snapshot every leaf to host memory before ``save`` returns and
write on a background thread; retention of the newest ``keep``
checkpoints. ``restore`` copies the values into the template's tensors in
place (the reference returns new host arrays). The reference's
``restore_resharded`` is mesh code and is not ported.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

BF16 = "bfloat16"


def _flatten(tree) -> dict[str, Any]:
    """{key: leaf} with the reference's key strings. ``LMParams`` (anything
    with a ``tree()`` method) stands for its nested dict of tensors."""
    out: dict[str, Any] = {}

    def walk(node, path):
        if hasattr(node, "tree") and callable(node.tree):
            node = node.tree()
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            for f in node._fields:
                walk(getattr(node, f), path + ("." + f,))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        else:
            out["/".join(path)] = node

    walk(tree, ())
    return out


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of a leaf and its manifest dtype; bf16 as uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
        if arr.dtype.name == BF16:  # ml_dtypes' bfloat16
            return arr.view(np.uint16), BF16
    return arr, str(arr.dtype)


def _save_npy(fh, arr: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(fh, arr)
        return
    # what np.save writes for ml_dtypes' bfloat16: a '<V2' header, raw bits
    np.lib.format.write_array_header_1_0(
        fh, {"descr": "<V2", "fortran_order": False, "shape": arr.shape}
    )
    fh.write(np.ascontiguousarray(arr).tobytes())


def _from_file(arr: np.ndarray, shape: list, dtype: str) -> torch.Tensor:
    # np.array, not np.ascontiguousarray, which makes a 0-d leaf 1-d
    if dtype == BF16:  # read as '|V2' (or as bfloat16 where ml_dtypes is loaded)
        bits = np.array(arr).view(np.int16).reshape(shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr.reshape(shape).astype(dtype)))


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, n_shards: int = 4):
        self.root = root
        self.keep = keep
        self.n_shards = n_shards
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save

    def save(self, step: int, tree, extra: dict | None = None, blocking: bool = True) -> None:
        # snapshot to host memory first: the training step can proceed
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        self.wait()
        if blocking:
            self._write(step, host, extra or {})
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}), daemon=True
            )
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict, extra: dict) -> None:
        final = os.path.join(self.root, f"step_{step:08d}")
        tmp = os.path.join(self.root, f".tmp-step_{step:08d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest: dict[str, Any] = {"step": step, "extra": extra, "leaves": {}}
        for key, (arr, dtype) in host.items():
            fname = key.replace("/", "__")
            ns = min(self.n_shards, max(1, arr.shape[0] if arr.ndim else 1))
            shards = np.array_split(arr, ns, axis=0) if arr.ndim else [arr]
            files = []
            for i, sh in enumerate(shards):
                f = f"{fname}.s{i:02d}.npy"
                with open(os.path.join(tmp, f), "wb") as fh:
                    _save_npy(fh, sh, dtype)
                    fh.flush()
                    os.fsync(fh.fileno())
                files.append(f)
            manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype, "files": files}
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as fh:
            json.dump(manifest, fh)
            fh.flush()
            os.fsync(fh.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"), ignore_errors=True)

    # ---------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.root) if d.startswith("step_"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read(self, step: int | None = None) -> tuple[dict[str, torch.Tensor], dict]:
        """Every leaf of a checkpoint as a CPU tensor, by key, and its
        ``extra`` dict. The newest step unless ``step`` is given."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as fh:
            manifest = json.load(fh)
        values = {}
        for key, meta in manifest["leaves"].items():
            parts = [np.load(os.path.join(d, f)) for f in meta["files"]]
            arr = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
            values[key] = _from_file(arr, meta["shape"], meta["dtype"])
        return values, manifest["extra"]

    def restore(self, template, step: int | None = None):
        """Copy a checkpoint into ``template``'s tensors in place (each leaf
        must match in shape and dtype). Returns (template, extra)."""
        values, extra = self.read(step)
        with torch.no_grad():
            for key, leaf in _flatten(template).items():
                if key not in values:
                    raise KeyError(f"checkpoint missing leaf {key}")
                v = values[key]
                if tuple(v.shape) != tuple(leaf.shape) or v.dtype != leaf.dtype:
                    raise ValueError(
                        f"leaf {key}: checkpoint holds {v.dtype} {tuple(v.shape)}, "
                        f"the template {leaf.dtype} {tuple(leaf.shape)}"
                    )
                leaf.copy_(v)
        return template, extra
