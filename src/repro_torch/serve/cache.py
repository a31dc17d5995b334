"""Content-hash-keyed caches for the serving layer. Port of
``repro.serve.cache``.

Two reuse levers dominate repeated solves of one instance:

* the **coupling store**: the resolve → encode is the expensive set-up of an
  instance (O(N²·B) for a dense J, O(nnz) for an edge list).
  :class:`LRUStoreCache` keys built ``CouplingStore``s on the coupling
  content hash and the resolved tier, and holds each store on the service's
  device, so a repeat solve encodes nothing and copies no J or plane bytes
  to the card;
* the **best solution seen**: :class:`WarmStartCache` remembers the best
  (energy, spins) any request reached on a problem, keyed on the full
  problem's content hash; a later request whose target energy is already
  met is answered from it without a launch.

Keys are content hashes, never object identities, and equal to the JAX
package's for the same instance: an ``EdgeList`` hashes by its canonical
COO digest, a dense J by its dtype, shape and bytes.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np

from ..core import ising
from ..core.coupling import CouplingStore, resolve_format
from ..core.resilience import problem_fingerprint
from ..device import DeviceLike, resolve_device


def coupling_digest(problem: ising.IsingProblem) -> str:
    """Content hash of the couplings alone (the store depends on J, not on
    the fields or offset): the canonical ``EdgeList`` digest of a
    dense-J-free problem, sha256 over the dtype name, shape and bytes of a
    dense J (copied to the host)."""
    if problem.couplings is None:
        return "edges:" + problem.edges._digest.hex()
    J = np.ascontiguousarray(problem.couplings.detach().cpu().numpy())
    h = hashlib.sha256()
    # The dtype is part of the content: an int32 J and its float32
    # bit-pattern twin have the same shape and bytes but other couplings.
    h.update(str(J.dtype).encode())
    h.update(repr(J.shape).encode())
    h.update(J.tobytes())
    return "dense:" + h.hexdigest()


def problem_digest(problem: ising.IsingProblem) -> str:
    """Content hash of the whole problem (couplings, fields, offset): the
    warm-start key, the resilient supervisor's snapshot fingerprint."""
    return problem_fingerprint(problem)


class LRUStoreCache:
    """Bounded LRU of built ``CouplingStore``s keyed on ``(coupling_digest,
    resolved tier)``, each held on ``device`` (default: the card).
    ``get_or_build`` resolves ``fmt`` first, so "auto" and the tier it
    resolves to share one entry. ``bytes_to_device`` counts the store bytes
    moved to the device by builds."""

    def __init__(self, capacity: int = 16, device: DeviceLike = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.device = resolve_device(device)
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_to_device = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get_or_build(self, problem: ising.IsingProblem,
                     fmt: str = "auto") -> tuple:
        """``(store, hit)`` for the problem's couplings at the resolved
        tier, on the cache's device; a miss builds (one encode), moves the
        store to the device once and caches it, evicting the least recently
        used entry past capacity."""
        resolved = resolve_format(fmt, problem.coupling_source,
                                  problem.num_spins)
        key = (coupling_digest(problem), resolved)
        store = self._entries.get(key)
        if store is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            return store, True
        self.misses += 1
        store = CouplingStore.build(problem.coupling_source, resolved)
        payload = store.planes.pos if store.spec.packed else store.dense
        if payload.device != self.device:
            self.bytes_to_device += store.nbytes
        store = store.to(self.device)
        self._entries[key] = store
        if len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return store, False


class BestRecord(NamedTuple):
    energy: float          # ensemble-best energy incl. the problem offset
    spins: np.ndarray      # (N,) int8, the spins that reached it (host)


class WarmStartCache:
    """Bounded LRU of the best solution seen per problem content hash.
    ``observe`` folds in a finished result (keeps the minimum); ``lookup``
    answers a later request on the same instance."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def observe(self, key: str, result) -> BestRecord:
        """Fold a finished solve into the cache and return the key's best
        record (this one or an earlier, better one). ``result`` has
        ``best_energy`` (..., R) and ``best_spins`` (..., R, N), as tensors
        (read to the host here) or as host arrays a caller read once for a
        whole plan."""
        energies = _host(result.best_energy).ravel()
        spins = _host(result.best_spins)
        spins = spins.reshape(-1, spins.shape[-1])
        i = int(np.argmin(energies))
        record = BestRecord(float(energies[i]), spins[i])
        prev = self._entries.get(key)
        if prev is None or record.energy < prev.energy:
            self._entries[key] = record
        else:
            record = prev
        self._entries.move_to_end(key)
        if len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
        return record

    def lookup(self, key: str) -> Optional[BestRecord]:
        record = self._entries.get(key)
        if record is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return record


def _host(x) -> np.ndarray:
    """A tensor or array as a numpy array on the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
