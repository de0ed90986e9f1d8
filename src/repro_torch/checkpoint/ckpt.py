"""Checkpointing: atomic, async, in the JAX package's on-disk format, the
port of ``repro.checkpoint.ckpt``.

Layout (one directory per step)::

    <dir>/step_000123/
        manifest.json        # tree structure, shapes, dtypes, step, extra
        leaf_00000.npy ...   # one file per leaf, in jax.tree.flatten order
    <dir>/LATEST             # atomic pointer file (rename-committed)

The files are byte for byte the JAX package's, so a checkpoint written by
either package restores in the other.  Leaves are numbered in JAX's order
(``repro_torch.tree``: dict keys sorted).  A bfloat16 leaf is what numpy
writes for ``ml_dtypes.bfloat16``: an ``.npy`` of descr ``'<V2'`` holding
the 16-bit patterns, with ``"bfloat16"`` as its manifest dtype; the port
writes and reads those bits through an int16 view, without ml_dtypes.

* ATOMIC: data is written into ``step_XXXX.tmp`` and committed by a single
  ``os.rename`` + LATEST pointer swap: a crash mid-save never corrupts the
  restore path.
* ASYNC: ``CheckpointManager.save_async`` copies the tensors to host
  memory, then writes on a background thread, overlapping I/O with
  training.
* RETENTION: keeps the newest ``keep`` checkpoints, deleting older ones
  only after a successful commit.
* SHARDED: a DTensor leaf is gathered (``full_tensor``, a collective that
  every rank joins) and rank 0 writes, so the files are those of the same
  state unsharded; the other ranks wait at a barrier until the commit.
  ``restore_checkpoint`` places each leaf with ``shardings`` (a tree of
  ``NamedSharding``s, JAX's argument), or, without it, as ``like_tree``'s
  leaf lies: reshard-on-restore, the path elastic re-meshing takes.
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

from repro_torch import tree
from repro_torch.core.dtensor import is_dtensor
from repro_torch.core.policies import NamedSharding

MANIFEST = "manifest.json"
LATEST = "LATEST"
_BF16_DESCR = "<V2"          # numpy's descr for ml_dtypes.bfloat16


def _to_host(leaf: Any) -> Any:
    """A host copy of a tensor leaf (a copy also when it lies on the CPU,
    so that training on in place cannot change a snapshot); a DTensor's
    whole global tensor, gathered on every rank."""
    if is_dtensor(leaf):
        return leaf.detach().full_tensor().to("cpu", copy=True)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf


def _ranks() -> tuple[int, int]:
    """(this rank, world size) of the default process group; (0, 1)
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _save_leaf(path: str, leaf: Any) -> dict:
    """Writes one ``.npy`` as ``np.save`` of the JAX array would; returns
    its manifest record."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        bits = leaf.detach().cpu().contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False,
                    "shape": bits.shape})
            f.write(bits.tobytes())
        return {"shape": list(bits.shape), "dtype": "bfloat16"}
    arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) \
        else np.asarray(leaf)
    np.save(path, arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype)}


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def save_checkpoint(directory: str, step: int, state: Any,
                    extra: dict | None = None, keep: int = 3) -> str:
    """Synchronous atomic save.  Returns the committed path.  With a
    process group of several ranks every rank must call it (DTensor leaves
    are gathered); rank 0 writes, and all return after the commit."""
    rank, world = _ranks()
    if any(is_dtensor(x) for x in tree.leaves(state)):
        state = tree.map(_to_host, state)
    final = os.path.join(directory, f"step_{step:08d}")
    if rank == 0:
        _write(directory, step, state, extra, keep)
    if world > 1:
        dist.barrier()
    return final


def _write(directory: str, step: int, state: Any, extra: dict | None,
           keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {
        "step": step,
        "treedef": tree.structure(state),
        "paths": None,
        "leaves": [],
        "extra": extra or {},
    }
    for i, leaf in enumerate(tree.leaves(state)):
        fn = f"leaf_{i:05d}.npy"
        rec = _save_leaf(os.path.join(tmp, fn), leaf)
        manifest["leaves"].append({"file": fn, **rec})
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic commit
    _write_latest(directory, name)
    _gc(directory, keep)
    return final


def _write_latest(directory: str, name: str) -> None:
    ptr_tmp = os.path.join(directory, LATEST + ".tmp")
    with open(ptr_tmp, "w") as f:
        f.write(name)
    os.replace(ptr_tmp, os.path.join(directory, LATEST))


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for old in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, old), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    ptr = os.path.join(directory, LATEST)
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(directory, name, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["step"]


def restore_checkpoint(directory: str, like_tree: Any, device=None,
                       step: int | None = None, shardings: Any = None
                       ) -> tuple[Any, dict]:
    """Restore into the structure of ``like_tree``: each leaf as a tensor
    of the checkpoint's dtype on ``device``, or, when that is None, on the
    device of ``like_tree``'s leaf (the host for a non-tensor leaf), with
    that leaf's ``requires_grad``.  ``shardings``, a tree like
    ``like_tree`` of ``NamedSharding``s (or None for a leaf to keep
    plain), distributes each leaf onto its mesh and placements; without
    it a DTensor leaf of ``like_tree`` gives one of its own mesh and
    placements.  Every rank reads the files.  Returns (tree, extra +
    {"step"})."""
    if step is None:
        with open(os.path.join(directory, LATEST)) as f:
            name = f.read().strip()
    else:
        name = f"step_{step:08d}"
    base = os.path.join(directory, name)
    with open(os.path.join(base, MANIFEST)) as f:
        manifest = json.load(f)
    like = tree.leaves(like_tree)
    if len(like) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"expected {len(like)} — structure mismatch")
    wants = tree.leaves(shardings) if shardings is not None else [
        NamedSharding(x.device_mesh, tuple(x.placements)) if is_dtensor(x)
        else None for x in like]
    if len(wants) != len(like):
        raise ValueError("restore_checkpoint: shardings differ from "
                         "like_tree in structure")
    loaded = []
    for ref, want, rec in zip(like, wants, manifest["leaves"]):
        t = _load_leaf(os.path.join(base, rec["file"]), rec["dtype"])
        is_tensor = isinstance(ref, torch.Tensor)
        if want is not None:
            from torch.distributed.tensor import distribute_tensor
            t = distribute_tensor(t.to(want.mesh.device_type), want.mesh,
                                  want.placements)
        else:
            t = t.to(device if device is not None
                     else ref.device if is_tensor else "cpu")
        if is_tensor and ref.requires_grad:
            t.requires_grad_(True)
        loaded.append(t)
    return tree.unflatten(like_tree, loaded), \
        manifest["extra"] | {"step": manifest["step"]}


class CheckpointManager:
    """Async double-buffered checkpointing."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._pending = False

    def wait(self) -> None:
        """Joins the save in flight; with several ranks, all of them then
        meet at a barrier, so that none reads the directory before rank
        0's commit."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            if _ranks()[1] > 1:
                dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, state: Any,
                   extra: dict | None = None) -> None:
        self.wait()                              # one save in flight max
        # snapshot to host BEFORE returning control (consistent state);
        # DTensor leaves are gathered here, on every rank
        host_state = tree.map(_to_host, state)
        self._pending = True
        if _ranks()[0] != 0:
            return

        def work():
            try:
                _write(self.directory, step, host_state, extra, self.keep)
            except BaseException as e:  # noqa: BLE001 - surfaced via wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
