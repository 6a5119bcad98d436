"""Hostile-world wireless scenarios: AP handoff, link volatility, churn.

The SparKV fleet model (serving.cluster) assumes a *static* world: each
device keeps the AP it was assigned at construction, uplink bandwidth
follows one stationary trace, and devices never disappear. Real edge
deployments are hostile — clients roam between APs mid-stream, links
collapse into outage windows, and devices churn away with requests in
flight. This module provides:

* event records (:class:`HandoffEvent`, :class:`OutageWindow`,
  :class:`ChurnEvent`) bundled into a :class:`ScenarioTrace` that
  :class:`~repro.serving.cluster.ServingCluster` arms at ``run()`` time;
* trace generators — :func:`markov_bw_trace` (Markov-modulated bandwidth
  states) and :func:`apply_outages` (AP blackout windows), plus
  :func:`handoff_storm` which herds every device onto one AP so a static
  placement collapses while a rebalancer can spread the load back out;
* the :class:`FleetRebalancer`: on every handoff/outage/churn event the
  cluster snapshots a :class:`FleetState` and the rebalancer re-solves
  fleet-wide placement + policy selection through the LP relaxation in
  :class:`repro.core.milp.FleetLP`, warm-started from the previous
  solve's simplex basis and from the online
  :class:`~repro.core.predictor.LatencyPredictor`'s contention model.

Bit-parity contract: a ``ScenarioTrace`` with no events (or
``scenario=None``) must leave the cluster's event stream, rng
consumption, and results bit-identical to a fleet that never imported
this module. Nothing here draws randomness at import time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..core.milp import FleetLP
from ..core.lp import solve_lp

__all__ = [
    "HandoffEvent", "OutageWindow", "ChurnEvent", "ScenarioTrace",
    "markov_bw_trace", "apply_outages", "handoff_storm",
    "FleetState", "RebalanceDecision", "FleetRebalancer",
]


# ---------------------------------------------------------------------------
# scenario events
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HandoffEvent:
    """Device ``device`` roams to ``new_ap`` at ``t_s``.

    Any stream in flight for that device is lost at the handoff instant
    (entropy-coded KV bitstreams are undecodable from a partial prefix)
    and its bytes re-enter the request's backlog; the controller may
    flip the re-queued chunk to local compute per the paper's runtime
    refinement (§IV-D). ``reachable`` is the set of APs the device can
    associate with after the move: ``None`` means a hard handoff (the
    device must take ``new_ap``); a tuple hands the choice to the fleet
    rebalancer, which may pick any listed AP.
    """
    t_s: float
    device: int
    new_ap: int
    reachable: Optional[tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class OutageWindow:
    """AP ``ap``'s uplink collapses to ``outage_floor_frac`` of its
    nominal bandwidth during ``[t_start_s, t_end_s)``. In-flight streams
    through that AP are aborted at window start; the window is finite so
    flows placed there later still drain once the trace recovers."""
    ap: int
    t_start_s: float
    t_end_s: float

    def __post_init__(self):
        assert self.t_end_s > self.t_start_s, (self.t_start_s, self.t_end_s)


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """Device ``device`` fails/leaves at ``t_s``. Its in-flight prefill
    work is lost; still-prefilling requests are re-placed through
    admission onto ``new_device`` (or the least-loaded live device when
    ``None``). Requests already decoding finish locally — decode needs
    no uplink and the tokens are already resident."""
    t_s: float
    device: int
    new_device: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ScenarioTrace:
    """A bundle of hostile-world events the cluster arms at run() time.

    An empty trace is indistinguishable from ``scenario=None``: the
    cluster pushes zero extra events and stays bit-identical to the
    static fleet (asserted by tests/test_scenarios.py and the calm-parity
    row of benchmarks/bench_hostile.py).
    """
    handoffs: tuple[HandoffEvent, ...] = ()
    outages: tuple[OutageWindow, ...] = ()
    churn: tuple[ChurnEvent, ...] = ()
    # bandwidth fraction an AP retains inside an outage window (a dead
    # uplink would starve the event loop; 2% models the beacon-only
    # association that real APs keep during backhaul loss)
    outage_floor_frac: float = 0.02

    def armed(self) -> bool:
        return bool(self.handoffs or self.outages or self.churn)


# ---------------------------------------------------------------------------
# trace generators
# ---------------------------------------------------------------------------


def markov_bw_trace(mean_bw: float, horizon_s: float, dt: float,
                    rng: np.random.Generator,
                    states: Sequence[float] = (1.0, 0.4, 0.08),
                    dwell_s: float = 2.0) -> np.ndarray:
    """Markov-modulated bandwidth trace: the link sits in one of
    ``states`` (fractions of ``mean_bw``) and jumps to a uniformly
    chosen other state after an Exp(``dwell_s``) dwell. Captures the
    good/degraded/starved regimes of a contended wireless uplink rather
    than the stationary i.i.d. draws of ``traffic.draw``."""
    n = max(int(np.ceil(horizon_s / dt)), 1)
    out = np.empty(n)
    states = tuple(float(s) for s in states)
    s = 0
    i = 0
    while i < n:
        dwell = max(rng.exponential(dwell_s), dt)
        j = min(i + int(np.ceil(dwell / dt)), n)
        out[i:j] = mean_bw * states[s]
        i = j
        # jump to a different state, uniformly
        hop = int(rng.integers(1, len(states)))
        s = (s + hop) % len(states)
    return out


def apply_outages(trace: np.ndarray, dt: float,
                  windows: Sequence[OutageWindow], ap: int,
                  floor_frac: float = 0.02) -> np.ndarray:
    """Mask ``trace`` (bandwidth samples at spacing ``dt``) down to
    ``floor_frac`` of its value inside every outage window for ``ap``.
    Returns the input unchanged (same object) when no window applies,
    so un-outaged APs keep their original trace arrays bit-identical."""
    mine = [w for w in windows if w.ap == ap]
    if not mine:
        return trace
    out = np.array(trace, float, copy=True)
    n = len(out)
    for w in mine:
        i0 = min(max(int(np.floor(w.t_start_s / dt)), 0), n)
        i1 = min(max(int(np.ceil(w.t_end_s / dt)), 0), n)
        out[i0:i1] *= floor_frac
    return out


def handoff_storm(n_devices: int, n_aps: int, *, t_start_s: float = 0.05,
                  spacing_s: float = 0.05,
                  target_ap: int = 0) -> tuple[HandoffEvent, ...]:
    """The adversarial roam pattern: every device hops onto
    ``target_ap`` at staggered times, each still able to reach every AP.
    Static placement piles the whole fleet onto one uplink; a rebalancer
    holding the ``reachable`` sets can spread devices back out."""
    reach = tuple(range(n_aps))
    return tuple(
        HandoffEvent(t_s=t_start_s + spacing_s * d, device=d,
                     new_ap=target_ap, reachable=reach)
        for d in range(n_devices))


# ---------------------------------------------------------------------------
# fleet-wide rebalancing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetState:
    """Snapshot the cluster hands to :meth:`FleetRebalancer.decide` at a
    scenario event boundary."""
    now: float
    demand: np.ndarray          # (D,) outstanding stream bytes per device
    ap_of_device: list          # current association, device -> AP
    ap_health: np.ndarray       # (A,) 1.0 healthy, outage_floor in outage
    ap_flows: np.ndarray        # (A,) active flows sharing each uplink
    mean_bw: float              # nominal uplink bandwidth, bytes/s
    comp_rate: np.ndarray       # (D,) local prefill throughput, bytes/s
    reach: list                 # device -> tuple of reachable AP ids
    dead: frozenset = frozenset()   # churned device ids


@dataclasses.dataclass(frozen=True)
class RebalanceDecision:
    placement: dict             # device -> AP (only devices that move)
    policy_hint: dict           # device -> policy name for future admits
    makespan_s: float
    warm_hit: bool


class FleetRebalancer:
    """Re-solves fleet-wide placement + loading policy on hostile events.

    Each call to :meth:`decide` builds the :class:`FleetLP` relaxation
    from the live fleet snapshot — AP capacities deflated by outage
    health and by the online predictor's learned contention share — and
    solves it with :func:`repro.core.lp.solve_lp`, warm-started from the
    previous event's optimal basis (handoff storms perturb data, not
    structure, so most re-solves skip phase 1). The LP's streamed-byte
    split yields per-device AP placement; its local-compute fractions
    and the post-placement AP health yield policy hints extending
    ``telemetry_policy`` to the full set: mostly-local devices get
    ``local_prefill``, devices stuck on a starved uplink get the
    ``cachegen`` bitrate ladder, everyone else stays ``sparkv``.
    """

    def __init__(self, predictor=None, *, min_interval_s: float = 0.0,
                 local_frac_thresh: float = 0.5,
                 starved_health: float = 0.5):
        self.predictor = predictor
        self.min_interval_s = float(min_interval_s)
        self.local_frac_thresh = float(local_frac_thresh)
        self.starved_health = float(starved_health)
        self.n_solves = 0
        self.n_warm_hits = 0
        self._basis = None
        self._shape = None          # (D, A) the cached basis belongs to
        self._last_t = -np.inf

    def decide(self, state: FleetState) -> Optional[RebalanceDecision]:
        if state.now - self._last_t < self.min_interval_s:
            return None
        demand = np.asarray(state.demand, float)
        live = [d for d in range(len(demand)) if d not in state.dead]
        if not live or demand[live].sum() <= 0:
            return None
        self._last_t = state.now

        D, A = len(demand), len(state.ap_health)
        # effective per-AP capacity: nominal bw x outage health x the
        # predictor's learned aggregate share under the current flow
        # count (contention makes n flows deliver less than n fair
        # shares; a cold predictor falls back to the nominal capacity)
        ap_bw = np.empty(A)
        for a in range(A):
            nf = max(int(state.ap_flows[a]), 1)
            if self.predictor is not None:
                cap = self.predictor.effective_capacity(state.mean_bw, nf)
            else:
                cap = state.mean_bw
            ap_bw[a] = cap * float(state.ap_health[a])
        dem = demand.copy()
        dem[list(state.dead)] = 0.0
        reach = [tuple(state.reach[d]) if d not in state.dead else ()
                 for d in range(D)]
        # a dead device's demand is 0; give it a dummy reachable AP so
        # its conservation row stays feasible
        reach = [r if r else (int(np.argmax(state.ap_health)),)
                 for r in reach]

        prob = FleetLP(demand=dem, ap_bw=ap_bw,
                       comp_rate=np.asarray(state.comp_rate, float),
                       reach=reach)
        obj, A_ub, b_ub, A_eq, b_eq = prob.build()
        warm = self._basis if self._shape == (D, A) else None
        res = solve_lp(obj, A_ub, b_ub, A_eq, b_eq, warm_basis=warm)
        self.n_solves += 1
        if res.status != "optimal":
            self._basis, self._shape = None, None
            return None
        if res.warm_used:
            self.n_warm_hits += 1
        self._basis, self._shape = res.basis, (D, A)

        placement, local_frac, mk = prob.extract(res.x)
        moves = {d: a for d, a in placement.items()
                 if d not in state.dead and a != state.ap_of_device[d]}
        hints: dict[int, str] = {}
        for d in live:
            if demand[d] <= 0:
                continue
            ap = placement.get(d, state.ap_of_device[d])
            if local_frac[d] > self.local_frac_thresh:
                hints[d] = "local_prefill"
            elif float(state.ap_health[ap]) < self.starved_health:
                hints[d] = "cachegen"
            else:
                hints[d] = "sparkv"
        return RebalanceDecision(placement=moves, policy_hint=hints,
                                 makespan_s=mk, warm_hit=warm is not None)
