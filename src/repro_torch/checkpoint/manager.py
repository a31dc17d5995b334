"""Atomic, checksummed checkpointing with retention and async save. Port of
``repro.checkpoint.manager``.

* **Atomicity.** A snapshot is written to ``step_<N>.tmp/`` and then
  renamed to ``step_<N>/`` with ``os.replace``: a crash mid-write never
  leaves a half-written ``step_<N>/``.
* **Integrity.** The manifest (``manifest.json``) records the sha256 of
  ``arrays.npz``; :func:`restore` re-hashes before reading a value and
  raises :class:`SnapshotCorruptError` on a mismatch, an unreadable file or
  a missing leaf, so a caller holding older snapshots can fall back
  newest-first.
* **Layout.** A tree of dicts, tuples, lists and named tuples whose leaves
  are tensors, numpy arrays or Python scalars. Arrays are saved as numpy
  values keyed by their path (``state/fields``, ``state/0``, ``trace``);
  scalars go into the manifest. numpy has no bfloat16: a bf16 tensor is
  saved as its 16-bit patterns (int16) and listed under the manifest's
  ``"bfloat16"`` key. :func:`restore` rebuilds each tensor on the template
  leaf's device with its dtype, bitwise. A named tuple such as the
  optimizer's ``QTensor`` is an inner node: its arrays are leaves and its
  ints scalars.
* **Async.** ``CheckpointManager(async_save=True)`` writes on a thread; the
  copy of every tensor to the host happens first, on the caller's thread,
  and finishes before the write starts.
* **Retention.** The newest ``keep`` snapshots stay (default 3).
* **Mesh-agnostic.** A sharded tree (blocks marked by
  ``models.shard_params``, every rank of the mesh calling save with its
  blocks) is saved as its logical, whole values: the blocks are gathered
  one leaf at a time, each copied to the host of the mesh's rank 0 and
  freed before the next (a card holds one whole leaf at most); only that
  rank keeps the copy and writes, and every rank waits for the write.
  :func:`restore` cuts each value to the template leaf's block (a meta
  template of ``models.abstract_params`` goes to the mesh's device), so a
  run saved on one mesh resumes on another.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import struct
import threading
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from ..distributed.mesh import agree, flat_shard_index
from ..models import sharding

_STEP_RE = re.compile(r"^step_(\d+)$")
_SCALARS = (int, float, str, bool)


class SnapshotCorruptError(RuntimeError):
    """A snapshot directory exists but cannot be trusted: an unreadable
    manifest or array archive, a checksum mismatch, or a leaf the template
    expects is missing (a truncated write)."""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _children(node):
    """``[(path part, child), ...]`` of an inner node, or None for a leaf.
    Dict keys in sorted order, named-tuple fields by name, sequences by
    index (the paths of the JAX checkpoint's tree flattening)."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _flatten_with_paths(tree, prefix: str = "") -> dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for part, child in kids:
        flat.update(_flatten_with_paths(
            child, f"{prefix}/{part}" if prefix else part))
    return flat


def _unflatten(like, values: dict, prefix: str = ""):
    """``like``'s structure with each leaf replaced by ``values[path]``."""
    kids = _children(like)
    if kids is None:
        return values[prefix]
    built = [_unflatten(child, values, f"{prefix}/{part}" if prefix
                        else part) for part, child in kids]
    if isinstance(like, dict):
        return dict(zip(sorted(like), built))
    if hasattr(like, "_fields"):
        return type(like)(*built)
    return type(like)(built)


def _to_host(leaf):
    """A host copy of a leaf: a CPU tensor of a tensor (a blocking
    device-to-host copy for one on the card), a numpy copy of an array;
    scalars pass through."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, _SCALARS):
        return leaf
    return np.array(leaf)


def _to_numpy(leaf) -> tuple[np.ndarray, bool]:
    """``(array, is_bf16)``: a bf16 tensor as its int16 bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy(), True
        return t.numpy().copy(), False
    return np.array(leaf), False


def _rebuild(like, built: list):
    if isinstance(like, dict):
        return dict(zip(sorted(like), built))
    if hasattr(like, "_fields"):
        return type(like)(*built)
    return type(like)(built)


def _is_qtensor(node) -> bool:
    return hasattr(node, "_fields") and node._fields == ("codes", "scales",
                                                         "orig_last")


def _split_last(t: torch.Tensor) -> bool:
    s = sharding.sharding_of(t)
    return s is not None and bool(sharding.live(s.mesh, s.axes(t.dim() - 1)))


def _mesh_of(tree):
    """The mesh of the tree's sharded blocks (None if it has none)."""
    for leaf in _flatten_with_paths(tree).values():
        s = sharding.sharding_of(leaf)
        if s is not None:
            return s.mesh
    return None


def _logical(tree):
    """``(tree, mesh)``, ``mesh`` that of the tree's blocks. Without one,
    the tree as it is. With one, its whole values on the host for the rank
    that writes, None at every leaf for the others: each sharded block is
    gathered on its device (every rank taking part), copied to the host and
    freed before the next, so one whole leaf at most is on the device at a
    time; a QTensor split on its last dim gets the whole ``orig_last``."""
    mesh = _mesh_of(tree)
    if mesh is None:
        return tree, None
    keep = _writes(mesh)

    def walk(node):
        kids = _children(node)
        if kids is None:
            if sharding.sharding_of(node) is not None:
                whole = sharding.reshard(node, None)
                host = _to_host(whole) if keep else None
                del whole
                return host
            return _to_host(node) if keep else None
        built = [walk(child) for _, child in kids]
        if keep and _is_qtensor(node) and _split_last(node.codes):
            built[2] = built[0].shape[-1]
        return _rebuild(node, built)

    return walk(tree), mesh


def _writes(mesh) -> bool:
    """Whether this rank writes the snapshots of a tree on ``mesh``."""
    return mesh is None or flat_shard_index(mesh, mesh.mesh_dim_names) == 0


def _barrier(mesh) -> None:
    agree(0, mesh, "cuda" if mesh.device_type == "cuda" else "cpu")


def save(directory: str, step: int, tree, extra: Optional[dict] = None) -> str:
    """Atomically write snapshot ``step`` of ``tree``; a sharded tree's
    whole values, by the mesh's rank 0, every rank waiting for it."""
    tree, mesh = _logical(tree)
    final = os.path.join(directory, f"step_{step}")
    if _writes(mesh):
        _write(directory, step, tree, extra)
    if mesh is not None:
        _barrier(mesh)
    return final


def _write(directory: str, step: int, tree, extra: Optional[dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, scalars, bf16 = {}, {}, []
    for key, leaf in _flatten_with_paths(tree).items():
        if isinstance(leaf, _SCALARS):
            scalars[key] = leaf
        else:
            arrays[key], is_bf16 = _to_numpy(leaf)
            if is_bf16:
                bf16.append(key)
    arrays_path = os.path.join(tmp, "arrays.npz")
    np.savez(arrays_path, **arrays)
    with open(arrays_path, "rb") as fh:
        os.fsync(fh.fileno())
    manifest = {"step": step, "scalars": scalars, "extra": extra or {},
                "num_arrays": len(arrays),
                "arrays_sha256": _sha256_file(arrays_path)}
    if bf16:
        manifest["bfloat16"] = bf16
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
        fh.flush()
        os.fsync(fh.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def snapshot_steps(directory: str) -> list[int]:
    """Every snapshot step on disk, ascending (corrupt or not: validation
    happens at restore, so callers can walk newest-first)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(directory)
                  if (m := _STEP_RE.match(name)))


def latest_step(directory: str) -> Optional[int]:
    steps = snapshot_steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: int) -> dict:
    """The snapshot's manifest, or :class:`SnapshotCorruptError` if it cannot
    be read or parsed."""
    path = os.path.join(directory, f"step_{step}", "manifest.json")
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError) as e:
        raise SnapshotCorruptError(
            f"unreadable manifest for snapshot step_{step}: {e}") from e


def _restore_leaf(val: np.ndarray, leaf, bf16: bool = False):
    if isinstance(leaf, torch.Tensor):
        s = sharding.sharding_of(leaf)
        device = leaf.device
        if s is not None:   # the template's block, on the mesh's device
            val = val[s.block(val.shape)]
            if device.type == "meta":
                device = torch.device(s.mesh.device_type)
        # np.array keeps a 0-d leaf 0-d (ascontiguousarray makes it (1,)).
        t = torch.from_numpy(np.array(val, order="C"))
        if bf16:
            t = t.view(torch.bfloat16)
        t = t.to(device=device, dtype=leaf.dtype)
        return t if s is None else sharding.with_sharding(t, s)
    return np.asarray(val, dtype=getattr(leaf, "dtype", None))


def restore(directory: str, step: int, like):
    """Restore snapshot ``step`` into the structure of the template ``like``
    (e.g. a freshly initialized state): each tensor on its template leaf's
    device and dtype. When the manifest carries ``arrays_sha256`` the
    archive is re-hashed before any value is read; every corruption mode
    raises :class:`SnapshotCorruptError`."""
    path = os.path.join(directory, f"step_{step}")
    manifest = read_manifest(directory, step)
    arrays_path = os.path.join(path, "arrays.npz")
    expect = manifest.get("arrays_sha256")
    if expect is not None:
        try:
            got = _sha256_file(arrays_path)
        except OSError as e:
            raise SnapshotCorruptError(
                f"unreadable arrays.npz for snapshot step_{step}: {e}") from e
        if got != expect:
            raise SnapshotCorruptError(
                f"checksum mismatch for snapshot step_{step}: arrays.npz "
                f"hashes to {got[:12]}…, manifest records {expect[:12]}…")
    try:
        with np.load(arrays_path) as data:
            arrays = {k: data[k] for k in data.files}
    # np.load's failure surface is wide: a zero-byte file raises EOFError and
    # a mangled header struct.error; a manifest without a checksum reaches
    # this load unchecked, so both must become a fallback, not a crash.
    except (OSError, ValueError, zipfile.BadZipFile, KeyError, EOFError,
            struct.error) as e:
        raise SnapshotCorruptError(
            f"unreadable arrays.npz for snapshot step_{step}: {e}") from e
    values = {}
    bf16 = set(manifest.get("bfloat16", ()))
    for key, leaf in _flatten_with_paths(like).items():
        if key in arrays:
            values[key] = _restore_leaf(arrays[key], leaf, key in bf16)
        elif key in manifest.get("scalars", {}):
            values[key] = manifest["scalars"][key]
        else:
            raise SnapshotCorruptError(
                f"snapshot step_{step} missing leaf {key!r}")
    return _localize(_unflatten(like, values))


def _localize(node):
    """A restored QTensor whose codes are split on their last dim: its
    ``orig_last`` is the block's."""
    kids = _children(node)
    if kids is None:
        return node
    built = [_localize(child) for _, child in kids]
    if _is_qtensor(node) and _split_last(built[0]):
        built[2] = built[0].shape[-1]
    return _rebuild(node, built)


class CheckpointManager:
    """Retention and optional async IO around :func:`save` and
    :func:`restore`. With ``async_save`` one write runs at a time on a
    thread; :meth:`wait` joins it and raises what it raised."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:     # every rank sees the mesh's write
            mesh, self._mesh = self._mesh, None
            _barrier(mesh)
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def save(self, step: int, tree, extra: Optional[dict] = None):
        # The host copy is made here, on the caller's thread, before any
        # write starts: a later chunk's tensors never reach this snapshot.
        # A sharded tree is gathered whole first, on every rank, one leaf
        # at a time into the writing rank's host copy.
        host, mesh = _logical(tree)
        if mesh is None:
            host = _unflatten(tree, {k: _to_host(v) for k, v in
                                     _flatten_with_paths(tree).items()})

        def do_save():
            _write(self.directory, step, host, extra)
            self._gc()

        def on_thread():
            try:
                do_save()
            except BaseException as e:   # noqa: BLE001 — raised by wait()
                self._error = e

        self.wait()
        if _writes(mesh) and self.async_save:
            self._thread = threading.Thread(target=on_thread, daemon=True)
            self._thread.start()
        elif _writes(mesh):
            do_save()
        self._mesh = mesh
        if not self.async_save:
            self.wait()

    def _gc(self):
        steps = snapshot_steps(self.directory)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def latest(self) -> Optional[int]:
        self.wait()
        return latest_step(self.directory)

    def restore(self, like, step: Optional[int] = None):
        self.wait()
        step = step if step is not None else self.latest()
        if step is None:
            return None, None
        return restore(self.directory, step, like), step
