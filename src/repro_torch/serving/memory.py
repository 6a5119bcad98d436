"""Per-device KV memory as a first-class resource server.

The cluster's compute (``DeviceRunQueue``) and network (``LinkTopology``)
are explicit servers, but through PR 5 device memory was infinite: every
assembled context stayed resident forever, so long-decode and
high-concurrency overloads were physically dishonest — at production
batch sizes memory, not the link, binds first. This module closes that
gap with a :class:`KVMemoryServer` per device:

  - **residency tracking** — a request is charged per assembled prefill
    chunk (stream or compute completion) and per decoded token
    (``DecodeTick`` growth, ``repro.core.engine.token_kv_bytes``); bytes
    are released when the request finalizes. With
    ``MemoryModel.capacity_bytes=None`` the server is a passive meter
    (peak / time-weighted percentile telemetry) and traces are
    bit-identical to a cluster without one.
  - **tiered backing store** — DRAM in front of an optional disk tier
    (``repro.core.costs.DiskTierProfile`` via a serial
    :class:`repro.serving.resources.DiskServer`): eviction *demotes* a
    victim's KV to disk (a write occupies the disk server, so reloads
    queue behind demotion storms, KVSwap-style) or *drops* it when no
    tier is configured.
  - **pressure-triggered eviction** — when a charge pushes residency
    over capacity, victims are selected among ready (fully assembled),
    unpinned residents: ``"lru"`` by last use, ``"idle"`` preferring
    sequences parked outside the active decode batch, or ``"bits"``
    (evict-to-lower-bits): the victim's resident KV is requantized down
    the ``compression.quantize.BITRATE_LEVELS`` ladder *in place* —
    shrinking without suspending the sequence — and only demoted or
    dropped at the ladder floor. With ``MemoryModel.cold_frac < 1`` the
    requantization is cold-pool-first: only the victim's low-saliency
    share of resident KV walks the ladder until it floors; the hot
    remainder (what attention actually reads at decode) degrades last.
    Assembling requests are never victims;
    when no victim fits the server over-commits rather than deadlock.
  - **reload planning** — an evicted sequence that reaches its next
    decode dispatch emits a ``repro.core.engine.KVReload`` and
    :func:`plan_reload` re-poses SparKV's overhead-aware stream-vs-
    compute decision at reload time ("Compute Or Load KV Cache? Why Not
    Both?"): per chunk, pick among **disk read**, **cloud restream**
    (the plan's compressed wire bytes over the projected bottleneck
    share) and **local recompute** (the plan's per-chunk compute
    predictions), greedy-LPT across the three paths seeded with their
    live backlogs — the paths overlap exactly like the prefill
    scheduler's stream/compute stages. The cluster executes each leg on
    the real servers, so reload time is contention, not a formula.

Conservation ledger (the hypothesis-tested invariant): every byte ever
charged is exactly one of resident, on disk, dropped, or freed::

    charged_total == resident + disk + dropped_total + freed_total

Downgrades move bytes resident -> freed, demotions resident -> disk,
reloads disk -> resident (a dropped context's restore is a fresh
charge), releases resident -> freed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.compression.quantize import BITRATE_LEVELS
from repro_torch.core.costs import MemoryModel, t_disk_read
from repro_torch.core.engine import KVReload
from repro_torch.serving.resources import DiskServer

# Link-topology flow keys for reload restreams: offset into a namespace
# disjoint from request rids (the topology orders keys, so they must stay
# plain ints, mutually comparable with rids).
RELOAD_FLOW_BASE = 1 << 30


@dataclasses.dataclass(frozen=True)
class EvictionEvent:
    """One eviction step the server performed under pressure. ``action``
    is ``"downgrade"`` (in-place requantization; the sequence keeps
    running at ``bits``), ``"demote"`` (resident KV moved to the disk
    tier; the sequence must reload before decoding) or ``"drop"`` (no
    tier: KV discarded; reload must restream/recompute)."""
    rid: int
    action: str
    freed_bytes: float
    bits: int
    t: float


@dataclasses.dataclass
class _Resident:
    rid: int
    bytes: float = 0.0            # DRAM-resident KV (hot + cold pools)
    bits: int = 16                # hot-pool quantization width
    disk_bytes: float = 0.0       # demoted copy on the disk tier
    evicted_bytes: float = 0.0    # resident bytes at demotion/drop time
    t_last_use: float = 0.0
    ready: bool = False           # context fully assembled (evictable)
    evicted: bool = False         # demoted/dropped: needs reload
    reloading: bool = False
    parked: bool = False          # finalized; kept for prefix reuse
    # cold-pool split for the "bits" policy with cold_frac < 1: the
    # low-saliency share of the resident KV, downgraded first
    cold_bytes: float = 0.0
    cold_bits: int = 16
    split: bool = False           # cold pool carved out yet


class KVMemoryServer:
    """Per-device KV residency server (see module docstring).

    Protocol with the cluster::

        admit(rid, t)                           # request enters service
        evs = charge(rid, nbytes, t, ...)       # chunk / token growth
        mark_ready(rid, t)                      # prefill assembled
        touch(rid, t)                           # decode step used the KV
        if needs_reload(rid): ev = begin_reload(rid, t)
        evs = finish_reload(rid, t, ...)        # all legs landed
        release(rid, t)                         # request finalized

    Every ``charge`` / ``finish_reload`` may return eviction events the
    cluster must act on (suspend demoted/dropped sequences in the decode
    batcher). ``pinned`` rids are never victims (members of an in-flight
    dispatch, the request being charged); ``idle`` rids are the
    ``"idle"`` policy's preferred victims (enrolled but outside the
    active decode batch).
    """

    def __init__(self, model: MemoryModel):
        self.model = model
        self.capacity = model.capacity_bytes
        prof = model.disk_profile
        self.disk: Optional[DiskServer] = \
            DiskServer(prof) if prof is not None else None
        self._res: dict[int, _Resident] = {}
        # conservation ledger
        self.charged_total = 0.0
        self.freed_total = 0.0
        self.dropped_total = 0.0
        self.resident_total = 0.0
        self.disk_total = 0.0
        # counters
        self.n_evictions = 0          # demote + drop (suspending steps)
        self.n_downgrades = 0
        self.n_demotions = 0
        self.n_drops = 0
        self.n_reloads = 0
        self.reload_bytes = 0.0
        self.n_retired = 0            # parked prefix segments reclaimed
        # residency history for peak / time-weighted percentiles
        self.peak_resident = 0.0
        self._hist_t: list[float] = [0.0]
        self._hist_v: list[float] = [0.0]

    # ---- ledger ----
    def ledger_balance(self) -> float:
        """``charged - (resident + disk + dropped + freed)`` — zero (to
        float tolerance) at every point of every legal interleaving."""
        return self.charged_total - (self.resident_total + self.disk_total
                                     + self.dropped_total
                                     + self.freed_total)

    def _record(self, t: float) -> None:
        self.peak_resident = max(self.peak_resident, self.resident_total)
        self._hist_t.append(t)
        self._hist_v.append(self.resident_total)

    # ---- telemetry ----
    def resident_bytes(self) -> float:
        return self.resident_total

    def pressure(self) -> float:
        """Resident bytes over capacity (0.0 when unbounded)."""
        if self.capacity is None:
            return 0.0
        return self.resident_total / self.capacity

    def resident_percentile(self, q: float) -> float:
        """Time-weighted percentile of resident bytes over the run so
        far (instantaneous samples weighted by how long they held)."""
        if len(self._hist_t) < 2:
            return float(self._hist_v[-1])
        ts = np.asarray(self._hist_t)
        vs = np.asarray(self._hist_v)
        durs = np.diff(ts)
        vals = vs[:-1]
        total = float(durs.sum())
        if total <= 0:
            return float(vs[-1])
        order = np.argsort(vals, kind="stable")
        cum = np.cumsum(durs[order])
        idx = int(np.searchsorted(cum, q / 100.0 * total))
        return float(vals[order][min(idx, len(vals) - 1)])

    def telemetry(self) -> dict:
        out = {
            "capacity_bytes": self.capacity,
            "peak_resident_bytes": self.peak_resident,
            "resident_p99_bytes": self.resident_percentile(99),
            "n_evictions": self.n_evictions,
            "n_downgrades": self.n_downgrades,
            "n_demotions": self.n_demotions,
            "n_drops": self.n_drops,
            "n_reloads": self.n_reloads,
            "reload_bytes": self.reload_bytes,
            "n_retired": self.n_retired,
            "charged_bytes_total": self.charged_total,
        }
        if self.disk is not None:
            out.update(disk_bytes_written=self.disk.bytes_written,
                       disk_bytes_read=self.disk.bytes_read,
                       disk_busy_s=self.disk.busy_s)
        return out

    def bits_of(self, rid: int) -> int:
        r = self._res.get(rid)
        return r.bits if r is not None else self.model.resident_bits

    # ---- residency protocol ----
    def admit(self, rid: int, t: float) -> None:
        assert rid not in self._res, f"rid {rid} already tracked"
        self._res[rid] = _Resident(rid=rid, bits=self.model.resident_bits,
                                   t_last_use=t)

    def touch(self, rid: int, t: float) -> None:
        r = self._res.get(rid)
        if r is not None:
            r.t_last_use = t

    def mark_ready(self, rid: int, t: float) -> None:
        r = self._res[rid]
        r.ready = True
        r.t_last_use = t

    def needs_reload(self, rid: int) -> bool:
        r = self._res.get(rid)
        return r is not None and r.evicted and not r.reloading

    def charge(self, rid: int, nbytes: float, t: float, *,
               pinned: frozenset = frozenset(),
               idle: frozenset = frozenset()) -> list[EvictionEvent]:
        """Charge `nbytes` of new resident KV to `rid` (prefill chunk or
        decode-token growth) and enforce capacity. Growth lands at the
        request's *current* resident bit-width, so a bits-downgraded
        sequence keeps growing at its reduced footprint."""
        r = self._res[rid]
        nbytes = float(nbytes) * r.bits / self.model.resident_bits
        if nbytes > 0:
            r.bytes += nbytes
            r.t_last_use = t
            self.charged_total += nbytes
            self.resident_total += nbytes
            self._record(t)
        return self._enforce(t, pinned=pinned | {rid}, idle=idle)

    def release(self, rid: int, t: float) -> None:
        """Request finalized: free its resident KV; any disk copy is
        discarded (counted dropped — those bytes never returned)."""
        r = self._res.pop(rid)
        if r.bytes > 0:
            self.freed_total += r.bytes
            self.resident_total -= r.bytes
        if r.disk_bytes > 0:
            self.dropped_total += r.disk_bytes
            self.disk_total -= r.disk_bytes
        self._record(t)

    # ---- prefix-reuse parking (radix-cache-style retained segments) ----
    def park(self, rid: int, t: float) -> bool:
        """Request finalized, but its assembled prefix KV stays
        addressable for cross-request reuse (the device prefix cache
        indexes it by content key). Parked segments remain resident and
        fully evictable — they are the *preferred* victims under
        pressure, and eviction retires them outright (``"retire"``
        action: the cluster must invalidate the prefix-cache keys)
        instead of demoting a session nobody will resume. Returns False
        (caller should ``release`` instead) when there is nothing worth
        parking: the KV is evicted/reloading or empty."""
        r = self._res[rid]
        if r.evicted or r.reloading or r.bytes <= 0:
            return False
        r.parked = True
        r.ready = True
        r.t_last_use = t
        self._record(t)
        return True

    def parked_rids(self) -> list[int]:
        return [r.rid for r in self._res.values() if r.parked]

    def retire(self, rid: int, t: float) -> None:
        """Explicitly reclaim a parked segment (cluster-side
        invalidation, e.g. end of run): resident bytes -> freed, any
        disk copy -> dropped, tracking removed."""
        r = self._res.pop(rid)
        assert r.parked, f"rid {rid} is not parked"
        if r.bytes > 0:
            self.freed_total += r.bytes
            self.resident_total -= r.bytes
        if r.disk_bytes > 0:
            self.dropped_total += r.disk_bytes
            self.disk_total -= r.disk_bytes
        self.n_retired += 1
        self._record(t)

    # ---- reload protocol ----
    def begin_reload(self, rid: int, t: float) -> KVReload:
        r = self._res[rid]
        assert r.evicted and not r.reloading, (rid, r)
        r.reloading = True
        return KVReload(rid=rid, nbytes=r.evicted_bytes,
                        from_disk=r.disk_bytes > 0,
                        mode=self.model.reload)

    def finish_reload(self, rid: int, t: float, *,
                      pinned: frozenset = frozenset(),
                      idle: frozenset = frozenset()
                      ) -> list[EvictionEvent]:
        """All reload legs landed: the KV is resident again at its
        pre-eviction size and width. A disk copy is consumed (transfer
        back to DRAM); a dropped context's restore is a fresh charge.
        Recharging may itself evict someone else — the reloaded rid is
        pinned so the server never evicts what it just restored."""
        r = self._res[rid]
        assert r.reloading, rid
        restore = r.evicted_bytes
        if r.disk_bytes > 0:
            self.disk_total -= r.disk_bytes
            fresh = restore - r.disk_bytes
            r.disk_bytes = 0.0
        else:
            fresh = restore
        self.charged_total += max(fresh, 0.0)
        r.bytes += restore
        self.resident_total += restore
        r.evicted_bytes = 0.0
        r.evicted = False
        r.reloading = False
        r.t_last_use = t
        self.n_reloads += 1
        self.reload_bytes += restore
        self._record(t)
        return self._enforce(t, pinned=pinned | {rid}, idle=idle)

    # ---- eviction ----
    def _candidates(self, pinned: frozenset) -> list[_Resident]:
        return [r for r in self._res.values()
                if r.ready and not r.evicted and not r.reloading
                and r.bytes > 0 and r.rid not in pinned]

    def _pick_victim(self, pinned: frozenset,
                     idle: frozenset) -> Optional[_Resident]:
        cands = self._candidates(pinned)
        if not cands:
            return None
        # parked prefix segments are speculative value; live sequences
        # are committed work — reclaim speculation first (LRU among the
        # parked, regardless of policy)
        parked = [r for r in cands if r.parked]
        if parked:
            return min(parked, key=lambda r: (r.t_last_use, r.rid))
        if self.model.policy == "idle":
            parked = [r for r in cands if r.rid in idle]
            if parked:
                cands = parked
        if self.model.policy == "bits":
            # spread the ladder: downgrade the widest resident first (LRU
            # tie-break), so every sequence degrades a level before any
            # one is crushed to the floor and demoted
            return min(cands, key=lambda r: (-r.bits, r.t_last_use, r.rid))
        return min(cands, key=lambda r: (r.t_last_use, r.rid))

    def _evict_step(self, r: _Resident, t: float) -> EvictionEvent:
        if r.parked:
            # retire the parked segment outright: no session resumes it,
            # so demotion/downgrade would spend tier bandwidth on bytes
            # whose only value was being DRAM-resident
            freed = r.bytes
            bits = r.bits
            self.retire(r.rid, t)
            return EvictionEvent(r.rid, "retire", freed, bits, t)
        if self.model.policy == "bits":
            frac = getattr(self.model, "cold_frac", 1.0)
            if frac >= 1.0:
                # whole-resident downgrade (the pre-cold-pool behavior,
                # kept verbatim for bit-parity at the default)
                lower = [b for b in BITRATE_LEVELS if b < r.bits]
                if lower:
                    new_bits = lower[0]
                    new_bytes = r.bytes * new_bits / r.bits
                    freed = r.bytes - new_bytes
                    r.bytes = new_bytes
                    r.bits = new_bits
                    self.freed_total += freed
                    self.resident_total -= freed
                    self.n_downgrades += 1
                    self._record(t)
                    return EvictionEvent(r.rid, "downgrade", freed,
                                         new_bits, t)
            else:
                # cold-pool-first requantization: carve the resident
                # into hot/cold at the model's cold fraction once, then
                # walk only the cold pool down the ladder; the hot pool
                # (the chunks attention actually reads) degrades only
                # after the cold pool hits the floor
                if not r.split:
                    r.cold_bytes = r.bytes * frac
                    r.cold_bits = r.bits
                    r.split = True
                lower = [b for b in BITRATE_LEVELS if b < r.cold_bits]
                if lower and r.cold_bytes > 0:
                    new_bits = lower[0]
                    new_cold = r.cold_bytes * new_bits / r.cold_bits
                    freed = r.cold_bytes - new_cold
                    r.cold_bytes = new_cold
                    r.cold_bits = new_bits
                    r.bytes -= freed
                    self.freed_total += freed
                    self.resident_total -= freed
                    self.n_downgrades += 1
                    self._record(t)
                    return EvictionEvent(r.rid, "downgrade", freed,
                                         new_bits, t)
                lower = [b for b in BITRATE_LEVELS if b < r.bits]
                if lower:
                    new_bits = lower[0]
                    hot = r.bytes - r.cold_bytes
                    new_hot = hot * new_bits / r.bits
                    freed = hot - new_hot
                    r.bits = new_bits
                    r.bytes -= freed
                    self.freed_total += freed
                    self.resident_total -= freed
                    self.n_downgrades += 1
                    self._record(t)
                    return EvictionEvent(r.rid, "downgrade", freed,
                                         new_bits, t)
        freed = r.bytes
        r.evicted_bytes = r.bytes
        r.bytes = 0.0
        r.cold_bytes = 0.0
        r.cold_bits = r.bits
        r.split = False
        r.evicted = True
        self.resident_total -= freed
        self.n_evictions += 1
        if self.disk is not None:
            r.disk_bytes = freed
            self.disk_total += freed
            self.disk.submit(freed, t, op="write")
            self.n_demotions += 1
            action = "demote"
        else:
            self.dropped_total += freed
            self.n_drops += 1
            action = "drop"
        self._record(t)
        return EvictionEvent(r.rid, action, freed, r.bits, t)

    def _enforce(self, t: float, *, pinned: frozenset,
                 idle: frozenset) -> list[EvictionEvent]:
        if self.capacity is None:
            return []
        evs: list[EvictionEvent] = []
        while self.resident_total > self.capacity:
            victim = self._pick_victim(pinned, idle)
            if victim is None:
                break                 # over-commit: nothing evictable
            evs.append(self._evict_step(victim, t))
        return evs


# ---------------------------------------------------------------------------
# Reload planning (stream vs. compute vs. disk, per chunk)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReloadPlan:
    """Per-path aggregation of one reload's chunk assignment. The
    cluster turns each non-empty leg into real server work: a link flow
    of ``stream_bytes`` (plus the on-device ``stream_proc_s`` dequant
    tail), one run-queue job of ``comp_s``, and a disk read of
    ``disk_bytes`` in ``n_disk_ops`` extents. ``makespan_s`` is the
    planner's own projection (max over the seeded path loads) — used
    only for plan comparison, never for scheduling."""
    mode: str
    n_stream: int
    n_comp: int
    n_disk: int
    stream_bytes: float
    stream_proc_s: float
    comp_s: float
    disk_bytes: float
    makespan_s: float


def plan_reload(chunks, *, mode: str, profile, stream_bw: float,
                comp_wait_s: float = 0.0, disk=None,
                disk_backlog_s: float = 0.0,
                has_disk_copy: bool = False) -> ReloadPlan:
    """Assign each evicted chunk to disk / restream / recompute.

    ``chunks`` is ``[(wire_bytes, resident_bytes, comp_s), ...]`` — the
    plan's compressed wire bytes, the chunk's share of the resident KV
    on disk, and the planner's predicted compute seconds. Per-chunk path
    costs are the core cost models evaluated at reload time:

      - restream: ``wire / stream_bw + profile.t_proc(wire)``
        (:func:`repro.core.costs.t_stream` at the projected bottleneck
        share);
      - recompute: the chunk's predicted compute seconds;
      - disk: :func:`repro.core.costs.t_disk_read` of its resident
        bytes (only when a demoted copy exists).

    Paths run concurrently (stream on the NIC, compute on the device,
    disk on the storage controller), so the planner list-schedules
    greedily: chunks longest-first (LPT), each onto the path whose
    seeded load + cost is least. Seeds are the live backlogs — the
    device queue's projected wait (``comp_wait_s``, the PR 5 online
    predictor when refreshed) and the disk server's drain time — so a
    path that is already busy wins fewer chunks. ``mode`` restricts the
    path set for the single-path baselines."""
    assert mode in ("planner", "restream", "recompute", "disk"), mode
    have_disk = disk is not None and has_disk_copy
    paths = {"stream": 0.0,
             "comp": float(comp_wait_s)}
    if have_disk:
        paths["disk"] = float(disk_backlog_s)
    if mode == "restream":
        allowed = ("stream",)
    elif mode == "recompute":
        allowed = ("comp",)
    elif mode == "disk":
        allowed = ("disk",) if have_disk else ("stream",)
    else:
        allowed = tuple(paths)

    def cost(path: str, chunk) -> float:
        wire, res, comp_s = chunk
        if path == "stream":
            return wire / stream_bw + profile.t_proc(wire)
        if path == "comp":
            return float(comp_s)
        return t_disk_read(res, disk.profile if isinstance(disk, DiskServer)
                           else disk)

    order = sorted(chunks, key=lambda c: min(cost(p, c) for p in allowed),
                   reverse=True)
    assign: dict[str, list] = {p: [] for p in paths}
    for c in order:
        best = min(allowed, key=lambda p: paths[p] + cost(p, c))
        paths[best] += cost(best, c)
        assign[best].append(c)

    stream_bytes = sum(c[0] for c in assign["stream"])
    stream_proc = sum(profile.t_proc(c[0]) for c in assign["stream"])
    comp_s = sum(float(c[2]) for c in assign["comp"])
    disk_bytes = sum(c[1] for c in assign.get("disk", []))
    used = [p for p in allowed if assign[p]]
    return ReloadPlan(
        mode=mode,
        n_stream=len(assign["stream"]),
        n_comp=len(assign["comp"]),
        n_disk=len(assign.get("disk", [])),
        stream_bytes=stream_bytes,
        stream_proc_s=stream_proc,
        comp_s=comp_s,
        disk_bytes=disk_bytes,
        makespan_s=max((paths[p] for p in used), default=0.0))


def predicted_reload_stall_s(cluster, device: int,
                             add_bytes: float) -> float:
    """Admission-time projection of the reload stall a new request would
    suffer: the residency overflow its full context would create on the
    device, drained at the combined reload bandwidth (disk read + the
    projected bottleneck stream share). Zero whenever the cluster has no
    armed finite-capacity memory server — the bit-parity guarantee for
    ``slo.predict_ttft`` / ``predict_tpot``."""
    server_fn = getattr(cluster, "memory_server", None)
    if server_fn is None:
        return 0.0
    m = server_fn(device)
    if m is None or m.capacity is None:
        return 0.0
    overflow = m.resident_total + float(add_bytes) - m.capacity
    if overflow <= 0:
        return 0.0
    bw = cluster.net.mean_bw * cluster.projected_flow_frac(device)
    nic_bw = cluster.nic_mean_bw(device)
    if nic_bw is not None:
        bw = min(bw, nic_bw)
    if m.disk is not None:
        bw += m.disk.profile.read_bw
    return overflow / max(bw, 1.0)
