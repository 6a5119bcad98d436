"""Cross-request KV reuse servers: the cloud content-addressed store and
the per-device prefix cache.

At fleet scale much of the prefill work is redundant — shared system
prompts, multi-turn chats re-sending their whole history, RAG over common
documents ("Compute Or Load KV Cache? Why Not Both?"). This module gives
the reuse layer its two residency servers:

  - :class:`CloudKVStore` — one per fleet, cloud-side. Caches the
    transfer-ready encoded bitstream per content key
    (``repro.core.chunks.chunk_content_key``: prefix-closed token span +
    model + bits + chunking). Capacity-bound with LRU or LFU eviction;
    every lookup is counted (hit/miss), every insert either lands or is
    refused (an artifact larger than the whole store). A hit's economics
    are :func:`repro.core.costs.t_store_hit` — the cached bytes skip the
    cloud-side encode and bypass the shared cloud-egress stage.
  - :class:`DevicePrefixCache` — one per device. Content keys of chunks
    whose *assembled KV* is still addressable on the device (this
    session's previous turn, or another resident request sharing the
    prefix). A match satisfies the chunk locally: no link bytes, no
    compute — the near-free local hit. When the cluster runs a finite
    ``KVMemoryServer``, residency of parked prefix segments is governed
    there (``park``/retire) and this cache only indexes them; standalone
    it bounds itself with ``device_capacity_bytes``.

Byte-conservation ledger (the hypothesis-tested invariant): every byte
ever accepted by ``insert`` is exactly one of resident or evicted::

    inserted_total == resident_bytes + evicted_total

and counter consistency: ``n_lookups == n_hits + n_misses`` under any
interleaving, with residency never exceeding capacity after any call.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.costs import KVStoreModel


class CloudKVStore:
    """Capacity-bound content-addressed bitstream cache (cloud side).

    Protocol::

        if store.lookup(key, t):      # counted hit (refreshes recency)
            ... serve via t_store_hit ...
        else:                         # counted miss
            ... origin path; on stream completion:
            store.insert(key, nbytes, t)

    Deterministic: recency/insertion order is a monotone sequence number
    (no wall-clock ties), so eviction order is reproducible.
    """

    def __init__(self, model: Optional[KVStoreModel] = None):
        self.model = model if model is not None else KVStoreModel()
        self.capacity = self.model.capacity_bytes
        self._res: dict[int, float] = {}        # key -> bytes
        self._seq: dict[int, int] = {}          # key -> last-use seq (LRU)
        self._freq: dict[int, int] = {}         # key -> use count (LFU)
        self._clock = 0
        # counters
        self.n_lookups = 0
        self.n_hits = 0
        self.n_misses = 0
        self.n_inserts = 0
        self.n_evictions = 0
        self.n_refused = 0                      # oversized artifacts
        # byte-conservation ledger
        self.inserted_total = 0.0
        self.evicted_total = 0.0
        self.resident_bytes = 0.0

    def __contains__(self, key: int) -> bool:
        return key in self._res

    def __len__(self) -> int:
        return len(self._res)

    def _touch(self, key: int) -> None:
        self._clock += 1
        self._seq[key] = self._clock
        self._freq[key] = self._freq.get(key, 0) + 1

    # ---- ledger ----
    def ledger_balance(self) -> float:
        """``inserted - (resident + evicted)`` — zero at every point of
        every legal interleaving (to float tolerance)."""
        return self.inserted_total - (self.resident_bytes
                                      + self.evicted_total)

    # ---- protocol ----
    def lookup(self, key: int, t: float = 0.0) -> bool:
        """Is the artifact cached? Counts the outcome; a hit refreshes
        recency/frequency (the read keeps it hot)."""
        self.n_lookups += 1
        if key in self._res:
            self.n_hits += 1
            self._touch(key)
            return True
        self.n_misses += 1
        return False

    def insert(self, key: int, nbytes: float, t: float = 0.0) -> list[int]:
        """Cache an artifact of `nbytes`; returns the keys evicted to
        make room. Re-inserting a resident key refreshes it (no ledger
        movement). An artifact larger than the whole store is refused
        (counted, no state change) — residency never exceeds capacity."""
        nbytes = float(nbytes)
        assert nbytes >= 0, nbytes
        if key in self._res:
            self._touch(key)
            return []
        if self.capacity is not None and nbytes > self.capacity:
            self.n_refused += 1
            return []
        self._res[key] = nbytes
        self._touch(key)
        self.n_inserts += 1
        self.inserted_total += nbytes
        self.resident_bytes += nbytes
        return self._enforce(exclude=key)

    def remove(self, key: int) -> None:
        """Invalidate an entry (counted as evicted — the bytes left
        residency). No-op for absent keys."""
        nbytes = self._res.pop(key, None)
        if nbytes is None:
            return
        self._seq.pop(key, None)
        self._freq.pop(key, None)
        self.resident_bytes -= nbytes
        self.evicted_total += nbytes
        self.n_evictions += 1

    def _victim(self, exclude: int) -> Optional[int]:
        cands = [k for k in self._res if k != exclude]
        if not cands:
            return None
        if self.model.policy == "lfu":
            return min(cands, key=lambda k: (self._freq[k], self._seq[k]))
        return min(cands, key=lambda k: self._seq[k])

    def _enforce(self, exclude: int) -> list[int]:
        if self.capacity is None:
            return []
        out = []
        while self.resident_bytes > self.capacity:
            victim = self._victim(exclude)
            if victim is None:
                break
            self.remove(victim)
            out.append(victim)
        return out

    # ---- telemetry ----
    def hit_rate(self) -> Optional[float]:
        return self.n_hits / self.n_lookups if self.n_lookups else None

    def telemetry(self) -> dict:
        return {
            "capacity_bytes": self.capacity,
            "policy": self.model.policy,
            "resident_bytes": self.resident_bytes,
            "n_entries": len(self._res),
            "n_lookups": self.n_lookups,
            "n_hits": self.n_hits,
            "n_misses": self.n_misses,
            "n_inserts": self.n_inserts,
            "n_evictions": self.n_evictions,
            "n_refused": self.n_refused,
            "inserted_bytes_total": self.inserted_total,
            "evicted_bytes_total": self.evicted_total,
            "hit_rate": self.hit_rate(),
        }


class DevicePrefixCache(CloudKVStore):
    """Content-key index of chunks whose assembled KV is addressable on
    one device (LRU residency; same accounting/ledger as the cloud
    store). ``capacity_bytes=None`` when a ``KVMemoryServer`` governs
    residency — entries are then retired via :meth:`remove` when the
    memory server evicts the backing segment."""

    def __init__(self, capacity_bytes: Optional[float] = None):
        super().__init__(KVStoreModel(capacity_bytes=capacity_bytes,
                                      policy="lru"))

    def match(self, keys) -> set:
        """Resident subset of `keys` — counted lookups, matches touched
        (the prefix read keeps the segment hot)."""
        return {k for k in keys if self.lookup(k)}
