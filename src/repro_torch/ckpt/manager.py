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
place (the reference returns new host arrays).

On a mesh the leaves are ``DTensor``s and the format stays the same: a
checkpoint written on any mesh is read by the reference's manager and by a
single process. ``save`` gathers each ``DTensor`` leaf whole
(``full_tensor()``, a collective, so every rank of the group calls
``save``, on the calling thread, before the writer thread starts); exactly
one rank (rank 0) writes and commits, and a blocking save ends in a
barrier, so no rank reads a step before it is committed. ``restore`` into
a ``DTensor`` leaf copies this rank's shard of the file's value;
``restore_resharded`` (elastic restore) places each leaf on a mesh and
placements of the caller's choosing, which need not be the ones it was
saved from. Every rank reads the same files and keeps its own shard: no
rank receives a whole leaf over the network.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

BF16 = "bfloat16"


def _flatten(tree, is_leaf=None) -> dict[str, Any]:
    """{key: leaf} with the reference's key strings. ``LMParams`` (anything
    with a ``tree()`` method) stands for its nested dict of tensors. A node
    for which ``is_leaf`` is true is a leaf, whatever its type."""
    out: dict[str, Any] = {}

    def walk(node, path):
        if is_leaf is not None and is_leaf(node):
            out["/".join(path)] = node
            return
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


def _rebuild(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)`` (keys as
    ``_flatten``'s); an ``LMParams`` is rebuilt with its ``trainable``."""
    if hasattr(tree, "tree") and callable(tree.tree):
        trainable = any(p.requires_grad for p in tree.parameters())
        return type(tree)(_rebuild(tree.tree(), fn, path), trainable=trainable)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), fn, path + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, fn, path + (str(i),)) for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (str(k),)) for k, v in tree.items()}
    return fn("/".join(path), tree)


def _is_sharding(node) -> bool:
    """A ``restore_resharded`` sharding leaf: None or (DeviceMesh, placements)."""
    return node is None or (isinstance(node, tuple) and len(node) == 2
                            and isinstance(node[0], DeviceMesh))


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _local_shard(full: torch.Tensor, mesh: DeviceMesh, placements) -> torch.Tensor:
    """This rank's shard of the whole value ``full`` under ``placements``
    on ``mesh`` (a view of ``full``: the rows and columns ``DTensor``
    gives this rank, uneven splits included)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(full.shape, mesh, placements)
    return full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of the default
    group, or any process outside one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of a leaf and its manifest dtype; bf16 as uint16 bits.
    A ``DTensor`` leaf is gathered whole first (a collective)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.detach().full_tensor()
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
    if dtype == BF16:  # read as '|V2' (or as bfloat16 where ml_dtypes is loaded)
        bits = arr.view(np.int16).reshape(shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(arr.reshape(shape).astype(dtype, copy=False))


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, n_shards: int = 4):
        self.root = root
        self.keep = keep
        self.n_shards = n_shards
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save

    def save(self, step: int, tree, extra: dict | None = None, blocking: bool = True) -> None:
        """Snapshot ``tree`` to host memory, then write it (on a background
        thread unless ``blocking``). In a process group every rank calls
        it; rank 0 alone writes, and a blocking save ends in a barrier."""
        # snapshot to host memory first: the training step can proceed
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        if not _writes():
            if blocking:
                dist.barrier()
            return
        self.wait()
        if blocking:
            self._write(step, host, extra or {})
            if dist.is_initialized():
                dist.barrier()
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
        must match in shape and dtype; a ``DTensor`` leaf takes this rank's
        shard). Returns (template, extra)."""
        values, extra = self.read(step)
        with torch.no_grad():
            for key, leaf in _flatten(template).items():
                v = _value(values, key, leaf)
                if isinstance(leaf, DTensor):
                    leaf.to_local().copy_(_local_shard(v, leaf.device_mesh, leaf.placements))
                else:
                    leaf.copy_(v)
        return template, extra


def _value(values: dict[str, torch.Tensor], key: str, leaf) -> torch.Tensor:
    """The checkpoint's value of ``key``, which must match ``leaf`` in
    shape and dtype."""
    if key not in values:
        raise KeyError(f"checkpoint missing leaf {key}")
    v = values[key]
    if tuple(v.shape) != tuple(leaf.shape) or v.dtype != leaf.dtype:
        raise ValueError(
            f"leaf {key}: checkpoint holds {v.dtype} {tuple(v.shape)}, "
            f"the template {leaf.dtype} {tuple(leaf.shape)}"
        )
    return v


def restore_resharded(manager: CheckpointManager, template, shardings, step: int | None = None):
    """Elastic restore: the checkpoint's leaves placed with *new*
    shardings (another mesh shape than at save time). Returns (tree,
    extra), ``tree`` shaped like ``template`` with new tensors.

    ``shardings`` is a tree shaped like ``template`` whose leaves are a
    ``(DeviceMesh, placements)`` pair, which gives a ``DTensor`` whose
    local shard is this rank's, or None, which gives a plain tensor on the
    template leaf's device; a pair or None where ``template`` has a
    subtree holds for all of it (``shardings=None``: every leaf plain).
    Every rank reads the same files and keeps its own shard; nothing moves
    between ranks. A trainable ``LMParams`` template gives trainable
    parameters."""
    values, extra = manager.read(step)
    placed = _flatten(shardings, is_leaf=_is_sharding)

    def sharding(key):
        parts = key.split("/")
        for n in range(len(parts), -1, -1):  # the leaf's own, else its nearest subtree's
            if "/".join(parts[:n]) in placed:
                return placed["/".join(parts[:n])]
        raise KeyError(f"shardings missing leaf {key}")

    def place(key, leaf):
        v = _value(values, key, leaf)
        if sharding(key) is None:
            return v.to(leaf.device)
        mesh, placements = sharding(key)
        local = _local_shard(v, mesh, placements).to(_mesh_device(mesh), copy=True).contiguous()
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=v.shape, stride=v.stride())

    return _rebuild(template, place), extra
