"""Generic discrete-event resource servers for the serving layer.

Both shared resources of the cluster — the wireless link(s) and the
accelerator — are expressed as *servers* with one driving protocol:

    submit work        add(key, demand) / submit(key, duration, t)
    peek next event    next_completion() -> (t, key) | None
    advance the clock  advance(t)   (fluid servers integrate deliveries)
    retire work        complete(key[, t])

Two families:

- :class:`LinkTopology` — a *fluid* server network: flows drain
  byte-demands through a path of :class:`LinkStage` s (each a bandwidth
  trace fair-shared under a ``repro.core.costs.SharedLinkModel``).  A
  flow's instantaneous rate is the minimum of its per-stage shares, so a
  per-device NIC feeding a congested AP uplink (the paper's Fig. 13
  scenario) is two stages on the flow's path, and the cloud-egress tree
  (:func:`tree_topology`: NICs -> per-AP uplinks -> one egress stage
  shared by *all* APs) is three.  A single-stage topology is exactly
  PR 1's ``SharedLinkArbiter`` (which is now a subclass).

  :class:`LinkTopology` is the **vectorized event core**: flow state
  lives in struct-of-arrays (remaining bytes, path-group id, telemetry
  accumulators are dense numpy rows), flows are bucketed by their path
  tuple into *path groups* — every flow in a group crosses the same
  stages, so it drains at the same rate — and ``advance()`` integrates
  the whole fleet with one delivered-integral per *group* (one
  ``at_many`` per stage) instead of one per flow.  ``next_completion()``
  searches one candidate per group (the min-remaining flow provably
  finishes first within its group) and caches the result between
  active-set changes.  :class:`ScalarLinkTopology` preserves the
  per-flow dict/loop reference implementation; both share the exact
  same integration and bisection helpers, so at any N the two cores are
  arithmetically in lockstep (the parity suite drives them side by
  side).

- :class:`DeviceRunQueue` — a *slotted* server: compute jobs occupy one
  of ``capacity`` service slots for a fixed duration; excess jobs wait in
  an explicit queue under a FIFO, weighted-fair (WFQ), or deadline-floored
  shortest-remaining-first (SRPT) discipline — SRPT preempts at chunk
  boundaries only, since chunks are the atomic service unit.  This
  replaces the scalar ``util`` dilation: concurrent chunks *wait*, they
  don't mutually stretch.  Queue depth / waits / service backlog are the
  telemetry that feeds the latency predictor's U feature, the SLO
  admission layer (``repro.serving.slo``), and the runtime controller.

All servers are deterministic given their inputs; time is the cluster's
virtual clock (seconds).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.costs import DiskTierProfile, SharedLinkModel
from repro_torch.core.engine import BandwidthIntegrator, LinkStarvedError


# ---------------------------------------------------------------------------
# Fluid link servers
# ---------------------------------------------------------------------------


class LinkStage:
    """One arbitrated hop: a bandwidth trace fair-shared among the flows
    currently crossing it, with contention efficiency ``eta(n)`` from the
    link model (``None`` -> ideal fair sharing)."""

    def __init__(self, name: str, integrator: BandwidthIntegrator,
                 link: Optional[SharedLinkModel] = None):
        self.name = name
        self.bw = integrator
        self.link = link
        self.active: set = set()

    def fraction(self) -> float:
        """Per-flow fraction of the instantaneous trace capacity."""
        n = len(self.active)
        if n == 0:
            return 1.0
        eta = self.link.aggregate_efficiency(n) if self.link else 1.0
        return eta / n


# Completion search bounds shared by both topology cores: the doubling
# phase gives up (LinkStarvedError) past _MAX_HORIZON_S of sim time, and
# the bisection early-exits once the bracket is tighter than
# _BISECT_TOL_S (sub-nanosecond sim time — far below any event spacing
# the cluster produces, and the resolution the rtol<=1e-9 parity
# contract is stated against).
_MAX_HORIZON_S = 1e5
_BISECT_TOL_S = 1e-9
_BISECT_MAX_ITERS = 64


def _delivered_on(sts: list, t0: float, t1: float,
                  at_cache: Optional[dict] = None) -> float:
    """Bytes a flow crossing stages `sts` drains over [t0, t1] with the
    *current* active sets. Exact: per-stage rates are constant within
    each trace cell, so the min-rate is integrated cell by cell; beyond
    the last stage grid every stage extrapolates at a constant rate, so
    the tail is integrated analytically (never enumerated — a starved
    link searched out to the 1e5 s horizon must stay cheap).

    ``at_cache`` memoizes per-stage ``at_many`` rows within one caller
    pass (keyed by integrator identity and the clipped upper bound —
    ``t0`` and ``dt`` are fixed within a pass, so the cell bounds, and
    hence the row, are fully determined). Reusing the row is bitwise
    neutral: it is the identical array the stage would recompute.
    """
    if len(sts) == 1:
        return sts[0].bw.bytes_between(t0, t1) * sts[0].fraction()
    fr = np.array([s.fraction() for s in sts])
    dt = sts[0].bw.dt
    t_gmax = max(s.bw.grid_end_s for s in sts)
    total = 0.0
    if t1 > t_gmax:
        tail_span = t1 - max(t0, t_gmax)
        total += tail_span * min(s.bw.tail_bw * f
                                 for s, f in zip(sts, fr))
        t1 = max(t0, t_gmax)
    if t1 > t0:
        k0, k1 = int(np.floor(t0 / dt)), int(np.ceil(t1 / dt))
        bounds = None
        rows = []
        for s in sts:
            ck = (id(s.bw), t1) if at_cache is not None else None
            row = at_cache.get(ck) if ck is not None else None
            if row is None:
                if bounds is None:
                    bounds = np.unique(np.concatenate(
                        [[t0, t1], np.arange(k0 + 1, k1) * dt]))
                    bounds = bounds[(bounds >= t0) & (bounds <= t1)]
                row = s.bw.at_many(bounds)
                if ck is not None:
                    at_cache[ck] = row
            rows.append(row)
        per_stage = np.stack(rows)                              # (S, B)
        deliv = np.diff(per_stage, axis=1) * fr[:, None]        # (S, B-1)
        total += float(np.min(deliv, axis=0).sum())
    return total


def _finish_on(sts: list, t0: float, rem: float, names: tuple) -> float:
    """Finish time of a `rem`-byte demand crossing stages `sts` from
    `t0`, under the current active sets.

    Single-stage paths defer to the integrator's closed-form search;
    multi-stage paths bracket the root by doubling (each delivered
    integral evaluated once — the starvation check reuses the loop's
    last value instead of re-integrating) and then bisect with an
    early exit once the bracket is tighter than ``_BISECT_TOL_S``.
    """
    if rem <= 0:
        return t0
    if len(sts) == 1:
        return sts[0].bw.finish_time(t0, rem / sts[0].fraction())
    lo, hi = t0, t0 + 1e-3
    got = _delivered_on(sts, t0, hi)
    while got < rem and hi - t0 <= _MAX_HORIZON_S:
        hi = t0 + (hi - t0) * 2
        got = _delivered_on(sts, t0, hi)
    if got < rem:
        raise LinkStarvedError(
            f"link starved on path {tuple(names)}: {rem:.0f} B not "
            f"deliverable within {_MAX_HORIZON_S:.0f}s of t={t0:.3f}")
    for _ in range(_BISECT_MAX_ITERS):
        if hi - lo <= _BISECT_TOL_S:
            break
        mid = 0.5 * (lo + hi)
        if _delivered_on(sts, t0, mid) < rem:
            lo = mid
        else:
            hi = mid
    return hi


class LinkTopology:
    """Composable multi-stage link server (fluid-flow approximation),
    vectorized over flows.

    Every flow carries a byte demand along a fixed ``path`` of stages;
    within an interval where the active sets are constant the flow drains
    at ``min_s(trace_s(t) * fraction_s)`` — the bottleneck stage governs.
    The cluster guarantees piecewise-constant membership by always
    advancing to the earliest of (next heap event, earliest completion).

    With one stage per path this reduces *exactly* to the PR 1 shared-link
    arbiter: same cumulative-trace integral, same fair share, same
    completion search.  Per-flow share telemetry on the **last** stage of
    the path (the shared uplink by convention) is accumulated for fleet
    reporting (:meth:`mean_share`); pass ``telemetry=False`` to skip all
    share accumulation (``mean_share`` then reports 1.0 and
    :meth:`stage_shares` ``{}``) when the driver never reads it.

    **Struct-of-arrays layout.** Flow state lives in dense row-indexed
    numpy arrays (``_rem_a`` remaining bytes, ``_gid_a`` path-group id,
    ``_share_a`` / ``_active_a`` / ``_stage_a`` telemetry accumulators);
    ``complete()`` keeps rows dense by swapping the last row in.  Flows
    are bucketed into *path groups* by their path tuple: every flow in a
    group crosses the same stages with the same fractions, so all of
    them drain at the identical rate.  ``advance()`` therefore evaluates
    one delivered integral per live group (memoizing ``at_many`` rows
    across groups that share cell bounds — one ``at_many`` per *stage*
    when traces share a horizon) and applies it to all member rows in
    one vectorized pass.  ``next_completion()`` generalizes the
    arbiter-era fast path to every group: within a group the
    min-remaining flow provably finishes first (equal drain rates), so
    only one candidate per group is bisected; the result is cached and
    reused until the active set changes (``add`` / ``complete``) — the
    earliest absolute finish time is invariant under ``advance`` within
    a membership epoch.

    The dict-shaped views ``_rem`` / ``_path`` and the telemetry getters
    materialize lazily from the arrays, so the scalar-era API (and the
    scalar reference core, :class:`ScalarLinkTopology`) is preserved
    verbatim.
    """

    def __init__(self, stages: dict[str, LinkStage],
                 default_path: Optional[Sequence[str]] = None,
                 *, telemetry: bool = True):
        assert stages, "topology needs at least one stage"
        dts = {st.bw.dt for st in stages.values()}
        assert len(dts) == 1, f"stage traces must share one dt, got {dts}"
        self.stages = stages
        self.default_path = tuple(default_path) if default_path \
            else (next(iter(stages)),)
        self.telemetry = telemetry
        self.t = 0.0
        # struct-of-arrays flow state (dense rows; swap-with-last on
        # complete)
        self._n = 0
        self._keys: list = []                # row -> flow key
        self._row: dict = {}                 # flow key -> row
        cap = 16
        self._plen_max = max(1, len(self.default_path))
        self._rem_a = np.zeros(cap)
        self._gid_a = np.zeros(cap, dtype=np.intp)
        self._share_a = np.zeros(cap)        # last-stage share * time
        self._active_a = np.zeros(cap)       # active time
        self._stage_a = np.zeros((cap, self._plen_max))  # per path position
        self._adv_a = np.zeros(cap, dtype=bool)  # row saw >=1 advance
        # path groups (persist for the topology's lifetime)
        self._gid_of: dict = {}              # path tuple -> gid
        self._gpath: list = []               # gid -> path tuple
        self._gstages: list = []             # gid -> [LinkStage, ...]
        self._gcount: list = []              # gid -> live flow count
        # telemetry of completed flows (never cleared — the scalar-era
        # contract; re-adding a key seeds its rows from here so repeated
        # activations keep one continuous accumulation)
        self._done_tele: dict = {}           # key -> (share, active, {stage})
        self._seeded: dict = {}              # key -> stage names seeded
        self._off: dict = {}                 # key -> off-path carryover
        # next_completion cache, valid between active-set changes
        self._nc: Optional[tuple] = None
        self._nc_valid = False

    # ---- dict-shaped views (scalar-era API; tests and tools use them) ----
    @property
    def _rem(self) -> dict:
        """Flow key -> remaining bytes, materialized from the array."""
        return {k: float(self._rem_a[self._row[k]]) for k in self._keys}

    def remaining(self, key) -> Optional[float]:
        """Bytes still undelivered for an active flow as of the last
        ``advance``; ``None`` when the key has no in-flight transfer
        (mobility drivers use this to size the loss when aborting)."""
        row = self._row.get(key)
        return None if row is None else float(self._rem_a[row])

    @property
    def _path(self) -> dict:
        """Flow key -> path tuple, materialized from the group registry."""
        return {k: self._gpath[int(self._gid_a[self._row[k]])]
                for k in self._keys}

    # ---- membership ----
    def n_active(self) -> int:
        return self._n

    def _group_of(self, p: tuple) -> int:
        gid = self._gid_of.get(p)
        if gid is None:
            gid = len(self._gpath)
            self._gid_of[p] = gid
            self._gpath.append(p)
            self._gstages.append([self.stages[s] for s in p])
            self._gcount.append(0)
            if len(p) > self._plen_max:
                self._plen_max = len(p)
                ns = np.zeros((self._stage_a.shape[0], self._plen_max))
                ns[:, :self._stage_a.shape[1]] = self._stage_a
                self._stage_a = ns
        return gid

    def _grow_rows(self) -> None:
        cap = 2 * len(self._rem_a)

        def g(a):
            new = np.zeros(cap, dtype=a.dtype)
            new[:len(a)] = a
            return new

        self._rem_a = g(self._rem_a)
        self._gid_a = g(self._gid_a)
        self._share_a = g(self._share_a)
        self._active_a = g(self._active_a)
        self._adv_a = g(self._adv_a)
        ns = np.zeros((cap, self._stage_a.shape[1]))
        ns[:self._stage_a.shape[0]] = self._stage_a
        self._stage_a = ns

    def add(self, key, nbytes: float,
            path: Optional[Sequence[str]] = None) -> None:
        assert key not in self._row, f"flow {key} already active"
        p = tuple(path) if path else self.default_path
        for s in p:
            self.stages[s].active.add(key)
        gid = self._group_of(p)
        self._gcount[gid] += 1
        row = self._n
        if row == len(self._rem_a):
            self._grow_rows()
        self._keys.append(key)
        self._row[key] = row
        self._rem_a[row] = float(nbytes)
        self._gid_a[row] = gid
        self._share_a[row] = 0.0
        self._active_a[row] = 0.0
        self._stage_a[row, :] = 0.0
        self._adv_a[row] = False
        if self.telemetry:
            # a re-added key (reload restreams, per-chunk stream flows)
            # continues its accumulation exactly where it left off: seed
            # the fresh rows with the folded totals so every later `+=`
            # extends the same running sums the scalar dicts would hold
            base = self._done_tele.pop(key, None)
            if base is not None:
                share0, active0, by0 = base
                self._share_a[row] = share0
                self._active_a[row] = active0
                seeded, off = [], {}
                for name, v in by0.items():
                    if name in p:
                        self._stage_a[row, p.index(name)] = v
                        seeded.append(name)
                    else:
                        off[name] = v
                if seeded:
                    self._seeded[key] = tuple(seeded)
                if off:
                    self._off[key] = off
        self._n += 1
        self._nc_valid = False

    def _gather_tele(self, key, row: int) -> tuple:
        """(share_time, active_time, {stage: share_time}) for a live row,
        including any carryover from earlier activations of the key."""
        p = self._gpath[int(self._gid_a[row])]
        by = dict(self._off.get(key, {}))
        seeded = self._seeded.get(key, ())
        adv = bool(self._adv_a[row])
        for i, name in enumerate(p):
            # a stage appears once the flow lived through an advance (the
            # scalar core's setdefault point) or was seeded from a prior
            # activation; zero-span activations contribute no entries
            if adv or name in seeded:
                by[name] = float(self._stage_a[row, i])
        return float(self._share_a[row]), float(self._active_a[row]), by

    def complete(self, key) -> None:
        row = self._row.pop(key)
        gid = int(self._gid_a[row])
        for s in self._gpath[gid]:
            self.stages[s].active.discard(key)
        self._gcount[gid] -= 1
        if self.telemetry:
            self._done_tele[key] = self._gather_tele(key, row)
            self._seeded.pop(key, None)
            self._off.pop(key, None)
        last = self._n - 1
        if row != last:                      # keep rows dense
            mkey = self._keys[last]
            self._keys[row] = mkey
            self._row[mkey] = row
            self._rem_a[row] = self._rem_a[last]
            self._gid_a[row] = self._gid_a[last]
            self._share_a[row] = self._share_a[last]
            self._active_a[row] = self._active_a[last]
            self._stage_a[row, :] = self._stage_a[last, :]
            self._adv_a[row] = self._adv_a[last]
        self._keys.pop()
        self._n = last
        self._nc_valid = False

    # ---- integration ----
    def _live_gids(self) -> list:
        return [g for g, c in enumerate(self._gcount) if c > 0]

    def advance(self, t: float) -> None:
        """Integrate all flows over [self.t, t] (constant active sets):
        one delivered integral per path group, applied to every member
        row in a single vectorized pass."""
        if t <= self.t:
            return
        span = t - self.t
        n = self._n
        if n:
            live = self._live_gids()
            got = np.zeros(len(self._gcount))
            at_cache: dict = {}
            for g in live:
                got[g] = _delivered_on(self._gstages[g], self.t, t,
                                       at_cache)
            gid = self._gid_a[:n]
            self._rem_a[:n] = np.maximum(self._rem_a[:n] - got[gid], 0.0)
            if self.telemetry:
                frac = {name: st.fraction()
                        for name, st in self.stages.items()}
                lastf = np.zeros(len(self._gcount))
                gfrac = np.zeros((len(self._gcount), self._plen_max))
                for g in live:
                    p = self._gpath[g]
                    lastf[g] = frac[p[-1]]
                    for i, s in enumerate(p):
                        gfrac[g, i] = frac[s]
                self._share_a[:n] += lastf[gid] * span
                self._active_a[:n] += span
                self._stage_a[:n, :] += gfrac[gid] * span
                self._adv_a[:n] = True
        self.t = t

    # ---- completion search ----
    def next_completion(self) -> Optional[tuple]:
        """(t_done, key) of the earliest flow to finish if the active sets
        stay fixed.

        One bisection per *group*: all flows in a group drain at the same
        rate, so the min-remaining flow (ties to the smallest key, the
        scalar core's order) finishes first within its group — the
        arbiter-era single-stage fast path, generalized.  The result is
        cached until the next ``add``/``complete``: within a membership
        epoch the absolute finish times are invariant under ``advance``
        (a flow's remaining bytes at any interior time equal exactly the
        integral still to run), so the cache is a pure memo."""
        if self._n == 0:
            return None
        if self._nc_valid:
            return self._nc
        n = self._n
        rem = self._rem_a[:n]
        gid = self._gid_a[:n]
        live = self._live_gids()
        best = None
        if len(live) == 1:
            cand_iter = [(live[0], rem.min(), None)]
        else:
            minrem = np.full(len(self._gcount), np.inf)
            np.minimum.at(minrem, gid, rem)
            cand_iter = [(g, minrem[g], gid) for g in live]
        for g, m, gsel in cand_iter:
            tied = np.nonzero(rem == m)[0] if gsel is None \
                else np.nonzero((gsel == g) & (rem == m))[0]
            key = self._keys[tied[0]] if len(tied) == 1 \
                else min(self._keys[i] for i in tied)
            t_fin = _finish_on(self._gstages[g], self.t, float(m),
                               self._gpath[g])
            cand = (t_fin, key)
            if best is None or cand < best:
                best = cand
        self._nc = best
        self._nc_valid = True
        return best

    # ---- telemetry ----
    def mean_share(self, key) -> float:
        """Time-averaged fraction of the flow's last-stage (uplink)
        capacity it received while active; 1.0 if it never waited on a
        shared interval (or with ``telemetry=False``)."""
        if not self.telemetry:
            return 1.0
        row = self._row.get(key)
        if row is not None:
            share, at = float(self._share_a[row]), float(self._active_a[row])
        else:
            share, at, _ = self._done_tele.get(key, (0.0, 0.0, {}))
        if at <= 0:
            return 1.0
        return share / at

    def stage_shares(self, key) -> dict[str, float]:
        """Time-averaged fraction the flow received on *every* stage of
        its path while active, keyed by stage name ({} if it never ran a
        shared interval, or with ``telemetry=False``). The minimum entry
        is the flow's observed bottleneck share — the signal the
        predictor refresh trains on."""
        if not self.telemetry:
            return {}
        row = self._row.get(key)
        if row is not None:
            _, at, by = self._gather_tele(key, row)
        else:
            _, at, by = self._done_tele.get(key, (0.0, 0.0, {}))
        if at <= 0:
            return {}
        return {s: v / at for s, v in by.items()}


class ScalarLinkTopology:
    """The per-flow dict/loop reference implementation of
    :class:`LinkTopology` (the pre-vectorization core): ``advance()``
    integrates one delivered integral per *flow* and
    ``next_completion()`` searches every flow.  Kept as the parity
    oracle — it shares :func:`_delivered_on` / :func:`_finish_on` (and
    the completion cache) with the vectorized core, so the two are
    arithmetically in lockstep and the property suite can drive them
    side by side on identical traces.  API-identical; select it in the
    cluster with ``ServingCluster(link_core="scalar")``."""

    def __init__(self, stages: dict[str, LinkStage],
                 default_path: Optional[Sequence[str]] = None,
                 *, telemetry: bool = True):
        assert stages, "topology needs at least one stage"
        dts = {st.bw.dt for st in stages.values()}
        assert len(dts) == 1, f"stage traces must share one dt, got {dts}"
        self.stages = stages
        self.default_path = tuple(default_path) if default_path \
            else (next(iter(stages)),)
        self.telemetry = telemetry
        self.t = 0.0
        self._rem: dict = {}                 # flow key -> bytes left
        self._path: dict = {}                # flow key -> tuple[str, ...]
        # share telemetry (never cleared on complete): key -> sums
        self._share_time: dict = {}
        self._active_time: dict = {}
        self._stage_share_time: dict = {}    # key -> {stage: share * dt sum}
        self._nc: Optional[tuple] = None
        self._nc_valid = False

    def remaining(self, key) -> Optional[float]:
        """Bytes still undelivered for an active flow as of the last
        ``advance``; ``None`` when the key has no in-flight transfer."""
        rem = self._rem.get(key)
        return None if rem is None else float(rem)

    # ---- membership ----
    def n_active(self) -> int:
        return len(self._rem)

    def add(self, key, nbytes: float,
            path: Optional[Sequence[str]] = None) -> None:
        assert key not in self._rem, f"flow {key} already active"
        p = tuple(path) if path else self.default_path
        for s in p:
            self.stages[s].active.add(key)
        self._rem[key] = float(nbytes)
        self._path[key] = p
        self._nc_valid = False

    def complete(self, key) -> None:
        for s in self._path.pop(key):
            self.stages[s].active.discard(key)
        del self._rem[key]
        self._nc_valid = False

    # ---- integration ----
    def _delivered(self, path: tuple, t0: float, t1: float) -> float:
        return _delivered_on([self.stages[s] for s in path], t0, t1)

    def advance(self, t: float) -> None:
        """Integrate all flows over [self.t, t] (constant active sets)."""
        if t <= self.t:
            return
        span = t - self.t
        for key in self._rem:
            got = self._delivered(self._path[key], self.t, t)
            self._rem[key] = max(self._rem[key] - got, 0.0)
            if not self.telemetry:
                continue
            last = self.stages[self._path[key][-1]]
            self._share_time[key] = self._share_time.get(key, 0.0) \
                + last.fraction() * span
            self._active_time[key] = self._active_time.get(key, 0.0) + span
            per_stage = self._stage_share_time.setdefault(key, {})
            for s in self._path[key]:
                per_stage[s] = per_stage.get(s, 0.0) \
                    + self.stages[s].fraction() * span
        self.t = t

    # ---- completion search ----
    def _finish(self, key) -> float:
        rem, path = self._rem[key], self._path[key]
        return _finish_on([self.stages[s] for s in path], self.t, rem,
                          path)

    def next_completion(self) -> Optional[tuple]:
        """(t_done, key) of the earliest flow to finish if the active sets
        stay fixed. Cached between active-set changes (finish times are
        invariant under ``advance`` within a membership epoch)."""
        if not self._rem:
            return None
        if self._nc_valid:
            return self._nc
        paths = set(self._path.values())
        if len(paths) == 1 and len(next(iter(paths))) == 1:
            # all flows share one single-stage path -> equal shares, so
            # the min-remaining flow provably finishes first: one search
            # instead of one per flow (the arbiter-era fast path)
            key = min(self._rem, key=lambda k: (self._rem[k], k))
            best = (self._finish(key), key)
        else:
            # keys must be mutually orderable (the cluster uses int rids)
            best = min((self._finish(k), k) for k in self._rem)
        self._nc = best
        self._nc_valid = True
        return best

    # ---- telemetry ----
    def mean_share(self, key) -> float:
        """Time-averaged fraction of the flow's last-stage (uplink)
        capacity it received while active; 1.0 if it never waited on a
        shared interval (or with ``telemetry=False``)."""
        at = self._active_time.get(key, 0.0)
        if at <= 0:
            return 1.0
        return self._share_time[key] / at

    def stage_shares(self, key) -> dict[str, float]:
        """Time-averaged fraction the flow received on *every* stage of
        its path while active, keyed by stage name ({} if it never ran a
        shared interval, or with ``telemetry=False``)."""
        at = self._active_time.get(key, 0.0)
        if at <= 0:
            return {}
        return {s: v / at
                for s, v in self._stage_share_time.get(key, {}).items()}


def single_link(integrator: BandwidthIntegrator,
                link: Optional[SharedLinkModel] = None,
                name: str = "uplink", *, cls: Optional[type] = None,
                telemetry: bool = True) -> LinkTopology:
    """The degenerate one-stage topology (== PR 1 SharedLinkArbiter).
    ``cls`` selects the core (:class:`LinkTopology` by default,
    :class:`ScalarLinkTopology` for the reference path)."""
    cls = cls if cls is not None else LinkTopology
    return cls({name: LinkStage(name, integrator, link)},
               default_path=(name,), telemetry=telemetry)


def nic_uplink_topology(nic_integrators: Sequence[BandwidthIntegrator],
                        uplink_integrator: BandwidthIntegrator,
                        uplink_link: Optional[SharedLinkModel] = None,
                        nic_link: Optional[SharedLinkModel] = None,
                        *, cls: Optional[type] = None,
                        telemetry: bool = True
                        ) -> LinkTopology:
    """Two-stage tree: per-device NIC stages feeding one shared AP
    uplink. Device d's flows take path ("nic{d}", "uplink"). The
    degenerate (egress-free, single-AP) case of :func:`tree_topology`."""
    return tree_topology(nic_integrators, [uplink_integrator],
                         [0] * len(nic_integrators),
                         uplink_link=uplink_link, nic_link=nic_link,
                         cls=cls, telemetry=telemetry)


def tree_topology(nic_integrators: Optional[
                      Sequence[BandwidthIntegrator]],
                  uplink_integrators: Sequence[BandwidthIntegrator],
                  ap_of_device: Sequence[int],
                  egress_integrator: Optional[BandwidthIntegrator] = None,
                  *, uplink_link: Optional[SharedLinkModel] = None,
                  nic_link: Optional[SharedLinkModel] = None,
                  egress_link: Optional[SharedLinkModel] = None,
                  cls: Optional[type] = None,
                  telemetry: bool = True
                  ) -> LinkTopology:
    """Full cloud-egress tree: per-device NIC stages feeding per-AP
    uplink stages feeding one cloud-egress stage shared by *all* APs.

    ``ap_of_device[d]`` assigns device ``d`` to its access point. Stage
    names follow :func:`tree_path`: ``nic{d}`` (one per device, omitted
    when ``nic_integrators`` is None), ``uplink`` with a single AP /
    ``uplink{a}`` with several (so the single-AP tree keeps the exact
    two-stage stage names and trace), and ``egress`` when an egress
    integrator is given. A tree with one AP and no egress is therefore
    *identical* to :func:`nic_uplink_topology`; an unconstrained egress
    stage (capacity far above every per-flow share) leaves the two-stage
    trace bit-for-bit unchanged, since the bottleneck min ignores it.
    ``cls`` selects the topology core (vectorized default).
    """
    n_aps = len(uplink_integrators)
    assert n_aps >= 1, "tree needs at least one AP uplink"
    assert all(0 <= a < n_aps for a in ap_of_device), \
        f"ap_of_device entries out of range [0, {n_aps})"
    stages: dict[str, LinkStage] = {}
    if nic_integrators is not None:
        assert len(nic_integrators) == len(ap_of_device), \
            "one NIC integrator per device"
        for d, bw in enumerate(nic_integrators):
            stages[f"nic{d}"] = LinkStage(f"nic{d}", bw, nic_link)
    for a, bw in enumerate(uplink_integrators):
        name = uplink_stage_name(a, n_aps)
        stages[name] = LinkStage(name, bw, uplink_link)
    if egress_integrator is not None:
        stages["egress"] = LinkStage("egress", egress_integrator,
                                     egress_link)
    cls = cls if cls is not None else LinkTopology
    return cls(stages, default_path=(uplink_stage_name(0, n_aps),),
               telemetry=telemetry)


def uplink_stage_name(ap: int, n_aps: int) -> str:
    """Stage name of AP `ap`'s uplink ("uplink" when there is only one,
    so single-AP trees keep the two-stage naming)."""
    return "uplink" if n_aps == 1 else f"uplink{ap}"


def tree_path(device: int, ap: int, n_aps: int, *, has_nic: bool,
              has_egress: bool) -> tuple:
    """Path of stage names a flow from `device` (attached to AP `ap`)
    takes through a :func:`tree_topology`."""
    path = (f"nic{device}",) if has_nic else ()
    path += (uplink_stage_name(ap, n_aps),)
    if has_egress:
        path += ("egress",)
    return path


# ---------------------------------------------------------------------------
# Slotted device server
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _QueuedJob:
    key: object
    duration_s: float
    flow: object
    weight: float
    t_submit: float
    seq: int
    remaining_s: float = 0.0          # flow's est. remaining service (srpt)
    deadline_s: Optional[float] = None   # absolute deadline (srpt floor)


class DeviceRunQueue:
    """Explicit accelerator run queue with ``capacity`` service slots.

    Jobs (compute chunks) are submitted with a fixed service duration; a
    job either starts immediately (a slot is free) or waits. Disciplines:

    - ``"fifo"``  — global submit order;
    - ``"wfq"``   — weighted fair queueing: among queued jobs, start the
      one whose *flow* has the least weight-normalized attained service.
      On submit a flow's attained service is floored to a few quanta
      behind the least-served *active* flow, so a newcomer (or a flow
      returning from a long idle/streaming stretch) competes from now
      instead of replaying its absence as credit and starving veterans;
      the grace margin is wide enough that a continuously-competing
      flow's earned advantage (bounded by ~one quantum) is never clawed
      back. A flow with weight w receives a ~w-proportional share of
      device time under backlog (capped by the engine's one-outstanding-
      chunk-per-request protocol at capacity/(capacity+1)-ish shares);
      ties break by submit order.
    - ``"srpt"``  — shortest-remaining-processing-time, preemptive at
      chunk boundaries: chunks are the atomic service unit, so a running
      chunk is never interrupted, but at every dispatch the queued job
      whose *flow* has the least estimated remaining service
      (``remaining_s``, supplied by the driver from its plan minus
      attained service) starts next. A **deadline floor** bounds the
      starvation SRPT would otherwise inflict on long flows: any queued
      job whose absolute ``deadline_s`` is within ``deadline_floor_s``
      of now preempts the SRPT order, earliest deadline first — a long
      flow is deferred by shorter ones only until its deadline approaches,
      never past it while the server has a dispatch to give.

    The protocol mirrors the fluid servers: ``submit`` returns the start
    time (or ``None`` if queued), ``complete(key, t)`` frees the slot and
    returns the jobs that start as a result. ``next_completion()`` is the
    earliest in-service finish. ``load()`` / ``depth()`` / ``backlog_s()``
    / ``waits`` are the telemetry surface (predictor U feature, SLO
    admission prediction, controller pressure, fleet reports).
    """

    def __init__(self, capacity: int = 1, discipline: str = "fifo", *,
                 deadline_floor_s: float = 0.5):
        assert capacity >= 1
        assert discipline in ("fifo", "wfq", "srpt"), discipline
        self.capacity = capacity
        self.discipline = discipline
        self.deadline_floor_s = deadline_floor_s
        self._queue: list[_QueuedJob] = []
        self._running: dict = {}             # key -> (t_end, job)
        self._attained: dict = {}            # flow -> attained service
        self._vtime = 0.0                    # SFQ virtual time (start tags)
        self._seq = 0
        self.waits: list[float] = []         # per-job start - submit
        self.busy_s = 0.0

    # ---- telemetry ----
    def depth(self) -> int:
        """Jobs waiting (not in service)."""
        return len(self._queue)

    def in_service(self) -> int:
        return len(self._running)

    def load(self) -> int:
        """Occupancy: in-service + waiting jobs."""
        return len(self._queue) + len(self._running)

    def backlog_s(self) -> float:
        """Service seconds committed to the server: queued plus
        in-service job durations (in-service jobs count in full — a
        conservative bound, since the clock-free queue cannot know how
        much of a running chunk has elapsed). The SLO admission layer
        drains this by ``capacity`` to project a new request's wait."""
        return (sum(j.duration_s for j in self._queue)
                + sum(job.duration_s for _, job in self._running.values()))

    # ---- protocol ----
    def submit(self, key, duration_s: float, t: float, *,
               flow=None, weight: float = 1.0,
               remaining_s: Optional[float] = None,
               deadline_s: Optional[float] = None) -> Optional[float]:
        """Returns the start time if the job enters service now, else
        None (it waits; the driver learns the start via complete()).
        ``remaining_s`` (srpt) is the flow's estimated remaining service
        including this job (defaults to the job's own duration);
        ``deadline_s`` (srpt) is the flow's absolute deadline for the
        anti-starvation floor."""
        assert weight > 0
        f = key if flow is None else flow
        if self.discipline == "wfq":
            # fairness floor: re-enter no more than ~3 quanta behind the
            # least-served active flow, so idle time is not banked as
            # credit (an unfloored newcomer would monopolize the server
            # until it caught up with the veterans' attained service)
            floor = (self._active_min_norm()
                     - 3.0 * float(duration_s) / weight) * weight
            self._attained[f] = max(self._attained.get(f, 0.0), floor)
        job = _QueuedJob(key=key, duration_s=float(duration_s),
                         flow=f, weight=weight, t_submit=t, seq=self._seq,
                         remaining_s=float(duration_s if remaining_s is None
                                           else max(remaining_s, duration_s)),
                         deadline_s=deadline_s)
        self._seq += 1
        self._queue.append(job)
        started = self._dispatch(t)
        for k, t0, _ in started:
            if k == key:
                return t0
        return None

    def _active_min_norm(self) -> float:
        """Least weight-normalized attained service among flows with a
        job queued or in service; the last dispatch's level when idle."""
        jobs = list(self._queue) + [job for _, job in self._running.values()]
        if not jobs:
            return self._vtime
        return min(self._attained.get(j.flow, 0.0) / j.weight
                   for j in jobs)

    def _pick(self, t: float) -> int:
        if self.discipline == "fifo":
            return 0                         # queue is in submit order
        if self.discipline == "srpt":
            # deadline floor: jobs whose deadline is within the floor of
            # now override SRPT order, earliest deadline first — a long
            # flow never starves past its deadline
            urgent = [i for i, j in enumerate(self._queue)
                      if j.deadline_s is not None
                      and j.deadline_s - t <= self.deadline_floor_s]
            if urgent:
                return min(urgent, key=lambda i: (
                    self._queue[i].deadline_s, self._queue[i].seq))
            return min(range(len(self._queue)), key=lambda i: (
                self._queue[i].remaining_s, self._queue[i].seq))
        return min(range(len(self._queue)), key=lambda i: (
            self._attained.get(self._queue[i].flow, 0.0)
            / self._queue[i].weight,
            self._queue[i].seq))

    def _dispatch(self, t: float) -> list[tuple]:
        """Fill free slots; returns [(key, t_start, duration_s), ...]."""
        started = []
        while self._queue and len(self._running) < self.capacity:
            job = self._queue.pop(self._pick(t))
            self.waits.append(t - job.t_submit)
            self._vtime = max(self._vtime,
                              self._attained.get(job.flow, 0.0)
                              / job.weight)
            self._attained[job.flow] = \
                self._attained.get(job.flow, 0.0) + job.duration_s
            self._running[job.key] = (t + job.duration_s, job)
            self.busy_s += job.duration_s
            started.append((job.key, t, job.duration_s))
        return started

    def next_completion(self) -> Optional[tuple]:
        if not self._running:
            return None
        key = min(self._running,
                  key=lambda k: (self._running[k][0],
                                 self._running[k][1].seq))
        return self._running[key][0], key

    def complete(self, key, t: float) -> list[tuple]:
        """Retire an in-service job; returns newly started jobs."""
        del self._running[key]
        return self._dispatch(t)

    def cancel(self, key, t: float) -> list[tuple]:
        """Abort a job wherever it is (in service or still queued) —
        device churn kills work mid-flight. Frees the slot without
        recording attained service beyond what ``_dispatch`` already
        charged, and returns the jobs that start as a result (a vacated
        slot dispatches the queue exactly like a completion). No-op
        (returns []) when the key is unknown — the job may already have
        completed at the abort's event time."""
        if key in self._running:
            del self._running[key]
            return self._dispatch(t)
        for i, job in enumerate(self._queue):
            if job.key == key:
                del self._queue[i]
                break
        return []


# ---------------------------------------------------------------------------
# Serial disk-tier server (KV memory backing store)
# ---------------------------------------------------------------------------


class DiskServer:
    """Serial FIFO transfer server for the KV memory server's disk tier.

    One transfer at a time, busy-until semantics: a submitted transfer
    starts when every earlier one has drained (demotion *writes* and
    reload *reads* share the one device, so a reload issued during an
    eviction storm genuinely queues behind the writes), and occupies the
    device for ``n_ops * latency + bytes / bw`` of its direction
    (:func:`repro.core.costs.t_disk_read` / ``t_disk_write``). Unlike
    the fluid link stages there is no fair sharing — storage queues
    serially at these transfer sizes — so ``submit`` can return the
    completion time immediately and the driver schedules it as a heap
    event. ``backlog_s(now)`` (time until the device drains) is the
    telemetry the reload planner seeds its disk-path load with.
    """

    def __init__(self, profile: DiskTierProfile):
        self.profile = profile
        self.free_at = 0.0
        self.busy_s = 0.0
        self.bytes_read = 0.0
        self.bytes_written = 0.0
        self.n_reads = 0
        self.n_writes = 0
        self.waits: list[float] = []         # per-transfer start - submit

    def backlog_s(self, now: float) -> float:
        """Seconds until the device drains everything already queued."""
        return max(self.free_at - now, 0.0)

    def submit(self, nbytes: float, t: float, *, op: str = "read",
               n_ops: int = 1) -> float:
        """Queue one transfer; returns its completion time."""
        assert op in ("read", "write"), op
        p = self.profile
        bw = p.read_bw if op == "read" else p.write_bw
        dur = n_ops * p.latency_s + nbytes / bw
        t0 = max(t, self.free_at)
        self.waits.append(t0 - t)
        self.free_at = t0 + dur
        self.busy_s += dur
        if op == "read":
            self.bytes_read += nbytes
            self.n_reads += 1
        else:
            self.bytes_written += nbytes
            self.n_writes += 1
        return self.free_at
