"""Multi-request serving cluster on explicit resource servers.

The single-request engine (`repro.core.engine.HybridEngine.run`) models a
device that owns the whole NIC and sees contention only as a static `util`
scalar. This module runs **N concurrent context loads** against shared
resource *servers* (``repro.serving.resources``) on one discrete-event
clock:

  - **link servers** — a :class:`LinkTopology` drains each request's
    transfers through its path of fair-shared stages. The default is the
    single shared uplink (PR 1's :class:`SharedLinkArbiter`, now the
    degenerate one-stage topology); with ``n_devices > 1`` and a ``nic``
    profile the topology is the paper's Fig. 13 shape — per-device NIC
    stages feeding one congested AP uplink, the bottleneck stage governing
    each flow's rate. ``nic`` may be a per-device sequence (asymmetric
    NIC fleets), and with ``n_aps > 1`` / an ``egress`` profile the tree
    deepens to the full three-hop cloud path: NICs -> per-AP uplinks ->
    one cloud-egress stage shared by *all* APs
    (``resources.tree_topology``).
  - **device servers** — compute contention has two modes. Legacy
    closed-loop: in-flight compute dilates everyone's service time
    (``util = n_other_computing / capacity`` into
    ``GroundTruthLatency.attn_seconds``). Run-queue mode (pass a
    ``repro.core.costs.RunQueueModel``): chunks are admitted to an
    explicit per-device :class:`DeviceRunQueue` (FIFO or WFQ) and *wait*
    when the ``capacity`` service slots are busy — attn_seconds no longer
    consumes a fleet-contention util; queueing delay is the contention.
    The engine observes admission through the session protocol's
    :class:`StartAck` and reports per-request queue waits.
  - **telemetry** — the latency predictor's U feature at admission comes
    from the live device server (queue occupancy via
    ``predictor.queue_utilization`` in run-queue mode, in-flight compute
    in closed-loop mode); the runtime controller additionally receives
    per-chunk queue waits and folds them into migration decisions.
  - **admission queue** — at most ``max_concurrency`` requests are in
    service; arrivals beyond that wait FIFO. Per-request policy comes
    from the :class:`RequestSpec`, or from a ``policy_fn`` override at
    admission — :func:`telemetry_policy` is the default telemetry-driven
    chooser (sparkv vs. local_prefill from live link share and queue
    depth).
  - **SLO admission** — with an ``repro.serving.slo.SLOPolicy`` and
    per-request TTFT deadlines, admission projects each request's TTFT
    against the live servers; predicted violations are downgraded to
    coarser stream quantization (the bitrate ladder) or shed, deadline
    slack selects the WFQ weight class, and near-deadline flows are
    guarded against migration onto congested links. Attainment,
    shed/downgrade counts, and goodput-under-SLO land in the
    :class:`FleetReport`.
  - **continuous batched decode** — a request with
    ``RequestSpec.max_new_tokens > 0`` does not end at its first token:
    once its context is assembled it joins the device's
    :class:`repro.serving.decode.DecodeBatcher` (join/leave at token
    boundaries, ``DecodeConfig.max_batch`` co-resident sequences) and
    batched decode *dispatches* flow through the same device run queue
    as prefill chunks — decode and prefill genuinely contend for device
    time under the FIFO/WFQ/SRPT discipline. Per-request token
    timelines yield TPOT/TTLT, the :class:`FleetReport` gains tokens/s
    and full-response goodput, and energy covers the decode tail.
    Requests with ``max_new_tokens == 0`` keep first-token-only
    accounting, bit-identical to the pre-decode fleet.

Protocol with the engine: each admitted request holds an
``HybridEngine.session`` generator; the cluster resumes a session only at
that request's own completion events. Sessions yield ``StreamStart`` /
``ComputeStart`` requests which the cluster maps onto the link topology
and the device servers, acknowledging compute admissions with
``StartAck`` (immediate or queued). See ``repro.core.engine``.

Fleet metrics: p50/p99 TTFT (arrival -> first token), goodput, energy per
request, migrations, and per-request queue-wait / uplink-share breakdowns.

Typical use::

    specs = poisson_trace(...)                      # repro.serving.traffic
    cluster = ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                             run_queue=RunQueueModel(2, "wfq"))
    report = cluster.run(specs)
    print(report.summary())
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core import baselines as B
from repro_torch.core.chunks import Chunk, ChunkGrid, chunk_content_key
from repro_torch.core.costs import (GroundTruthLatency, KVStoreModel, MemoryModel,
                              NetworkProfile, PROFILES,
                              NETWORKS, RunQueueModel, SharedLinkModel,
                              chunk_bytes_at_bits)
from repro_torch.core.engine import (BandwidthIntegrator, Completion, ComputeStart,
                               DecodeDone, DecodeStart, DecodeTick,
                               HybridEngine, StartAck, StoreHit, StreamLost,
                               StreamStart, Wait, context_kv_bytes,
                               token_kv_bytes)
from repro_torch.core.predictor import (LatencyPredictor, backlog_delay_s,
                                  queue_utilization)
from repro_torch.data.workloads import DATASETS, WorkloadChunks, synthesize
from repro_torch.serving.decode import DecodeBatcher, DecodeConfig
from repro_torch.serving.kvstore import CloudKVStore, DevicePrefixCache
from repro_torch.serving.memory import (KVMemoryServer, RELOAD_FLOW_BASE,
                                  plan_reload)
from repro_torch.serving.resources import (DeviceRunQueue, LinkStage, LinkTopology,
                                     ScalarLinkTopology, single_link,
                                     tree_path, tree_topology,
                                     uplink_stage_name)
from repro_torch.serving.scenarios import (FleetState, FleetRebalancer,
                                     ScenarioTrace, apply_outages)
from repro_torch.serving.simcore import STATS as SIM_STATS
from repro_torch.serving.simcore import EventKind, EventQueue
from repro_torch.serving.slo import (SLOPolicy, decide_admission,
                               plan_compute_seconds)


# ---------------------------------------------------------------------------
# Shared-link bandwidth arbiter (degenerate one-stage topology)
# ---------------------------------------------------------------------------


class SharedLinkArbiter(LinkTopology):
    """Fair-share scheduler over one cumulative-bandwidth trace — PR 1's
    arbiter, now the single-stage case of :class:`LinkTopology`: active
    flows split the instantaneous capacity equally, scaled by the link
    model's aggregate efficiency ``eta(n)``. Kept as a named class for
    callers that want exactly one shared hop."""

    def __init__(self, integrator: BandwidthIntegrator,
                 link: Optional[SharedLinkModel] = None):
        super().__init__({"uplink": LinkStage("uplink", integrator, link)},
                         default_path=("uplink",))
        self.bw = integrator
        self.link = link


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RequestSpec:
    """One job for the cluster: when it arrives, what it loads, and the
    service class it belongs to (WFQ weight / TTFT deadline)."""
    arrival_s: float
    context_len: int = 8192
    dataset: str = "longchat"
    policy: str = "sparkv"
    seed: int = 0
    wl: Optional[WorkloadChunks] = None     # overrides synthesis if given
    device: int = 0                         # which device serves it
    weight: float = 1.0                     # WFQ share of device time
    deadline_s: Optional[float] = None      # TTFT SLO, relative to arrival
    slo_class: str = "default"              # reporting bucket for SLO stats
    max_new_tokens: int = 0                 # 0 = first-token-only (legacy)
    tpot_slo_s: Optional[float] = None      # per-token latency SLO (decode)
    # cross-request KV reuse: prefix-closed span content ids, one per
    # token block (repro.core.chunks.span_content_id chains); None keeps
    # the request anonymous — no lookups, no caching, bit-identical
    content_ids: Optional[tuple] = None
    session: Optional[int] = None           # multi-turn session identity


@dataclasses.dataclass
class RequestRecord:
    """Per-request outcome row of a :class:`FleetReport`: identity and
    policy, the TTFT decomposition (admission queue, device queue, link
    share), energy/quality, and the SLO verdict (deadline, whether it was
    met, and any admission-time quantization downgrade)."""
    rid: int
    spec: RequestSpec
    policy: str
    admit_s: float
    context_done_s: float                   # all chunks assembled
    done_s: float                           # context assembled + first token
    ttft_s: float                           # done_s - arrival_s (incl. queue)
    queue_s: float                          # admission-queue wait
    energy_j: float
    quality: float
    n_streamed: int
    n_computed: int
    n_migrations: int
    stream_busy_s: float
    compute_busy_s: float
    bytes_streamed: float
    compute_wait_s: float = 0.0             # device run-queue wait (total)
    n_compute_queued: int = 0
    uplink_share: float = 1.0               # mean uplink fraction received
    # SLO verdict (None deadline = no SLO applied to this request)
    slo_class: str = "default"
    deadline_s: Optional[float] = None
    slo_met: Optional[bool] = None
    quant_bits: int = 0                     # effective stream quant bits
    downgraded: bool = False                # admission walked the ladder
    # decode phase (first-token-only accounting when max_new_tokens == 0:
    # one token, ttlt == ttft, no inter-token time)
    n_tokens_out: int = 1
    ttlt_s: float = 0.0                     # last token - arrival
    tpot_s: float = 0.0                     # mean inter-token time
    tpot_slo_s: Optional[float] = None
    # mean share received on every stage of the flow's path (NIC, AP
    # uplink, cloud egress) — the per-stage breakdown behind uplink_share
    stage_shares: dict = dataclasses.field(default_factory=dict)
    # KV memory server outcome (zeros without an armed memory server —
    # defaults keep pre-memory records bit-identical)
    reload_s: float = 0.0                   # total decode stall on reloads
    n_evictions: int = 0                    # times this KV was demoted/dropped
    n_reloads: int = 0                      # reloads completed
    kv_bits: int = 0                        # final resident bits (0=untracked)
    # cross-request KV reuse outcome (zeros without a reuse layer)
    n_local_hits: int = 0                   # chunks satisfied on-device
    n_store_hits: int = 0                   # chunks served as store hits
    bytes_hit_stream: float = 0.0           # streamed bytes off the egress


@dataclasses.dataclass
class ShedRecord:
    """A request rejected at admission: its predicted TTFT violated the
    deadline even at the coarsest quantization ladder level, or its
    predicted per-token latency violated the TPOT SLO (``reason``)."""
    rid: int
    spec: RequestSpec
    t_shed_s: float                         # when admission rejected it
    pred_ttft_s: float                      # the TTFT prediction
    reason: str = "ttft"                    # which SLO leg shed ("tpot"?)
    pred_tpot_s: Optional[float] = None     # the violating TPOT prediction


@dataclasses.dataclass
class _ActiveRequest:
    rid: int
    spec: RequestSpec
    plan: B.RequestPlan
    gen: object                             # engine session generator
    admit_s: float
    # in-flight stream bookkeeping (one per request at a time)
    stream_chunk: Optional[Chunk] = None
    stream_t0: float = 0.0
    stream_t_proc: float = 0.0
    stream_nbytes: float = 0.0
    # hostile-world bookkeeping: the chunk computing on the device (churn
    # cancellation), whether decode started (churn spares decoders), and
    # the context bytes still to assemble (rebalancer demand signal)
    comp_chunk: Optional[Chunk] = None
    decoding: bool = False
    bytes_left: float = 0.0
    # SLO / scheduling state
    weight: float = 1.0                     # effective WFQ weight
    deadline_abs: Optional[float] = None    # arrival + deadline_s
    comp_total_s: float = 0.0               # planned compute seconds
    comp_done_s: float = 0.0                # attained compute service
    downgraded: bool = False
    pred_ttft_s: Optional[float] = None
    # admission-time contention snapshot (predictor refresh features)
    obs_load: int = 0
    obs_backlog_s: float = 0.0
    obs_n_flows: int = 0
    # KV memory server state (memory-armed clusters only)
    kv_chunk_bytes: float = 0.0             # resident KV per prefill chunk
    reload_s: float = 0.0
    n_evictions: int = 0
    n_reloads: int = 0
    # cross-request reuse: Chunk -> 64-bit content key (empty when the
    # request is anonymous or the store is unarmed)
    key_of: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FleetReport:
    """Fleet-level outcome of one :meth:`ServingCluster.run`: per-request
    records, requests shed at admission, and aggregate summary metrics
    (tail TTFT, goodput, energy, queue/link breakdowns, SLO attainment)."""
    records: list[RequestRecord]
    makespan_s: float
    n_arrived: int
    shed: list = dataclasses.field(default_factory=list)
    # fleet-aggregated KV memory-server telemetry (None when the cluster
    # ran without one — summary() then omits the memory block entirely,
    # keeping pre-memory summaries bit-identical)
    memory: Optional[dict] = None
    # cross-request reuse telemetry (None without an armed kvstore — the
    # summary() block is then absent, keeping no-reuse summaries
    # bit-identical)
    reuse: Optional[dict] = None
    # hostile-world scenario telemetry (None when the run had no armed
    # ScenarioTrace — static-fleet summaries stay bit-identical)
    scenario: Optional[dict] = None

    def ttfts(self) -> np.ndarray:
        return np.array([r.ttft_s for r in self.records])

    def summary(self) -> dict:
        t = self.ttfts()
        done = len(self.records)
        nan = float("nan")

        def pct(vals, q):
            return float(np.percentile(np.asarray(vals), q)) if done else nan

        waits = [r.compute_wait_s for r in self.records]
        shares = [r.uplink_share for r in self.records]
        return {
            "n_done": done,
            "ttft_p50_s": pct(t, 50),
            "ttft_p99_s": pct(t, 99),
            "ttft_mean_s": float(t.mean()) if done else nan,
            "goodput_rps": done / self.makespan_s if self.makespan_s else 0.0,
            "energy_per_req_j": float(np.mean([r.energy_j
                                               for r in self.records]))
            if done else nan,
            "migrations_total": sum(r.n_migrations for r in self.records),
            "stream_busy_total_s": sum(r.stream_busy_s
                                       for r in self.records),
            "queue_mean_s": float(np.mean([r.queue_s for r in self.records]))
            if done else nan,
            # device run-queue wait + uplink share breakdowns (per request)
            "queue_wait_p50_s": pct(waits, 50),
            "queue_wait_p99_s": pct(waits, 99),
            "queue_wait_mean_s": float(np.mean(waits)) if done else nan,
            "uplink_share_p50": pct(shares, 50),
            "uplink_share_p99": pct(shares, 99),
            **self._decode_summary(),
            **self._slo_summary(),
            **self._memory_summary(),
            **self._reuse_summary(),
            **self._scenario_summary(),
        }

    def _scenario_summary(self) -> dict:
        """Hostile-world block of :meth:`summary` — present only when
        the run armed a :class:`~repro.serving.scenarios.ScenarioTrace`
        (handoff/loss/churn/outage/rebalance counters from the run)."""
        if self.scenario is None:
            return {}
        return dict(self.scenario)

    def _reuse_summary(self) -> dict:
        """Cross-request reuse block of :meth:`summary` — present only
        when the cluster ran a :class:`CloudKVStore`.
        ``egress_bytes_total`` is the streamed bytes that actually
        crossed the cloud origin (store hits served from the edge
        replica are excluded) — the wide-area cost reuse exists to cut;
        ``store_hit_rate`` is over every content-key lookup the store
        answered."""
        if self.reuse is None:
            return {}
        store = self.reuse["store"]
        return {
            "store_hit_rate": store["hit_rate"],
            "store_evictions": store["n_evictions"],
            "local_hits_total": self.reuse["local_hits_total"],
            "store_hits_total": self.reuse["store_hits_total"],
            "egress_bytes_total": self.reuse["egress_bytes_total"],
            "bytes_hit_stream_total": self.reuse["bytes_hit_stream_total"],
        }

    def _decode_summary(self) -> dict:
        """Decode-aware goodput block of :meth:`summary`.

        ``goodput_tok_s`` counts every delivered token over the makespan
        (first-token-only fleets deliver exactly one token per request —
        the accounting fiction the decode phase replaces);
        ``goodput_resp_s`` counts completed *full responses* per second
        (== ``goodput_rps``, but over a makespan that now includes the
        decode tail when decoding is on). TPOT stats cover requests that
        actually decoded (> 1 token); ``None`` (not NaN, which would
        poison ``==`` parity checks) when nothing decoded."""
        toks = sum(r.n_tokens_out for r in self.records)
        tpots = [r.tpot_s for r in self.records if r.n_tokens_out > 1]
        ttlts = [r.ttlt_s for r in self.records]

        def pct(vals, q):
            return float(np.percentile(np.asarray(vals), q)) if vals else None

        return {
            "tokens_out_total": toks,
            "goodput_tok_s": toks / self.makespan_s
            if self.makespan_s else 0.0,
            "goodput_resp_s": len(self.records) / self.makespan_s
            if self.makespan_s else 0.0,
            "tpot_p50_s": pct(tpots, 50),
            "tpot_p99_s": pct(tpots, 99),
            "ttlt_p99_s": pct(ttlts, 99),
        }

    def _memory_summary(self) -> dict:
        """KV memory block of :meth:`summary` — present only when the
        cluster ran a memory server (``self.memory`` aggregated across
        devices at end of run), so memory-less summaries stay
        bit-identical to pre-memory fleets. Peak/p99 resident bytes are
        the fleet-wide maxima; eviction/reload counters sum devices; the
        request-level stall totals come from the records (so SLO misses
        caused by reload stalls are attributable)."""
        if self.memory is None:
            return {}
        return {
            "peak_resident_bytes": self.memory["peak_resident_bytes"],
            "resident_p99_bytes": self.memory["resident_p99_bytes"],
            "n_evictions": self.memory["n_evictions"],
            "n_downgrades": self.memory["n_downgrades"],
            "n_reloads": self.memory["n_reloads"],
            "reload_s_total": sum(r.reload_s for r in self.records),
            "reload_p99_s": float(np.percentile(
                [r.reload_s for r in self.records], 99))
            if self.records else None,
        }

    def _slo_summary(self) -> dict:
        """SLO attainment / shedding block of :meth:`summary`.

        ``slo_attainment`` is over *served* requests that carried a
        deadline (None when the trace had none) — the contract the
        admission layer offers for work it accepts.
        ``slo_attainment_arrived`` divides by every deadline request
        that *arrived* (shed ones count as misses), so an admission
        policy cannot inflate the headline number by shedding
        aggressively; compare the two to see how much attainment is
        scheduling gain vs. admission selectivity. ``goodput_slo_rps``
        counts only requests that met their deadline (deadline-less
        requests always count) — the throughput the fleet delivered
        within contract."""
        dl = [r for r in self.records if r.slo_met is not None]
        met = [r for r in dl if r.slo_met]
        n_dl_shed = sum(1 for s in self.shed
                        if s.spec.deadline_s is not None
                        or s.spec.tpot_slo_s is not None)
        by_class: dict = {}
        for r in dl:
            by_class.setdefault(r.slo_class, []).append(r)
        useful = len(self.records) - len(dl) + len(met)
        return {
            "slo_attainment": len(met) / len(dl) if dl else None,
            "slo_attainment_arrived": len(met) / (len(dl) + n_dl_shed)
            if dl or n_dl_shed else None,
            "slo_attainment_by_class": {
                k: sum(r.slo_met for r in v) / len(v)
                for k, v in sorted(by_class.items())},
            "n_shed": len(self.shed),
            "n_downgraded": sum(r.downgraded for r in self.records),
            "goodput_slo_rps": useful / self.makespan_s
            if self.makespan_s else 0.0,
        }


# ---------------------------------------------------------------------------
# Telemetry-driven admission policy
# ---------------------------------------------------------------------------


def telemetry_policy(spec: RequestSpec, cluster: "ServingCluster",
                     *, bw_floor_frac: float = 0.4,
                     decode_busy_frac: float = 1.0,
                     memory_ceiling: float = 0.9,
                     full_set: bool = False,
                     cachegen_floor_frac: float = 0.15) -> str:
    """Default ``policy_fn``: pick sparkv vs. local_prefill from the live
    resource servers at admission time.

    The hybrid planner's advantage evaporates when its streaming path is
    a fiction: if the projected per-flow share across the shared stages
    of this device's path (its AP uplink, and the cloud egress when the
    topology has one — profiled stage mean x fair-share fraction with
    this flow added, the bottleneck stage governing) falls below
    ``bw_floor_frac`` of the exclusive-link bandwidth *and* the device
    server still has slack for this request's compute, loading locally
    dominates. Otherwise run the sparkv planner, which keeps migrating
    at runtime anyway.

    Two further live signals veto the local-prefill switch (both
    inactive on clusters without decode batches / a memory server, so
    the pre-decode behaviour is unchanged):

      - **decode occupancy** — a device whose decode batch is at or past
        ``decode_busy_frac`` of ``max_batch`` has no compute slack the
        run-queue load can see (decode dispatches are one job however
        many sequences they carry), so forcing a full local prefill onto
        it starves token generation;
      - **memory pressure** — local prefill assembles the *whole*
        context resident with no partial-stream escape hatch; above
        ``memory_ceiling`` of the device's KV budget the stream path is
        preferable since evictions would immediately claw back whatever
        compute time local prefill saved.

    ``full_set=True`` extends the chooser to the full policy set for
    hostile-world fleets: the projected share is additionally deflated
    by the device's live AP outage health (``cluster.uplink_health``),
    and a link starved below ``cachegen_floor_frac`` whose device has
    *no* compute slack falls back to the ``cachegen`` bitrate ladder —
    streaming fewer bytes at graded fidelity is the only lever left
    when neither the uplink nor the device has headroom. The default
    ``full_set=False`` is bit-identical to the two-policy chooser.
    """
    frac = cluster.projected_flow_frac(spec.device)
    if full_set:
        frac *= cluster.uplink_health(spec.device)
    link_starved = frac < bw_floor_frac
    device_slack = cluster.device_load(spec.device) < cluster.capacity
    dcfg = cluster.decode_cfg if cluster.decode_cfg is not None \
        else DecodeConfig()
    decode_slack = cluster.decode_occupancy(spec.device) \
        < decode_busy_frac * dcfg.max_batch
    memory_ok = cluster.memory_pressure(spec.device) < memory_ceiling
    if link_starved and device_slack and decode_slack and memory_ok:
        return "local_prefill"
    if full_set and frac < cachegen_floor_frac:
        return "cachegen"
    return "sparkv"


# ---------------------------------------------------------------------------
# The cluster
# ---------------------------------------------------------------------------


class ServingCluster:
    """Discrete-event loop running N concurrent context loads.

    Parameters
    ----------
    cfg, spcfg : model / SparKV configs shared by all requests.
    profile, network : device profile name and network profile (name or
        ``NetworkProfile``) — the shared uplink trace is drawn from
        ``network``.
    capacity : compute slots per device. Run-queue mode serves at most
        this many chunks concurrently per device; closed-loop mode uses
        it to normalize utilization.
    max_concurrency : admission limit; excess arrivals queue FIFO.
    run_queue : a ``RunQueueModel`` switches the device server to the
        explicit run queue (FIFO/WFQ; ``run_queue.capacity`` overrides
        ``capacity``). Fleet compute contention is then queueing delay —
        ``attn_seconds`` receives only ``static_util`` (external, non-
        fleet load), never a fleet-derived scalar.
    closed_loop : (legacy mode, ignored under ``run_queue``) couple
        compute latency to actual in-flight compute; when False every
        request sees the hand-set ``static_util`` (Fig. 14 static mode).
    link : ``SharedLinkModel`` for uplink contention overhead; ``None``
        selects the default ``SharedLinkModel(network)`` (5%-per-flow
        overhead). For ideal overhead-free fair sharing pass
        ``SharedLinkModel(net, contention_overhead=0.0)`` explicitly.
    n_devices, nic, nic_link : with ``nic`` set (a ``NetworkProfile`` or
        name), each device gets its own NIC stage feeding the shared
        uplink (two-stage topology); requests route via
        ``RequestSpec.device``. ``nic`` may also be a sequence of
        profiles/names, one per device — asymmetric NIC fleets; a
        sequence of identical profiles is bit-for-bit the symmetric
        path. ``n_devices == 1`` with ``nic=None`` is the single-stage
        PR 1 semantics, bit-for-bit.
    n_aps, ap_of_device : number of access points and the device -> AP
        assignment (default round-robin ``d % n_aps``). Each AP owns its
        own uplink stage (AP 0 keeps the cluster's main uplink trace;
        further APs draw fresh traces from the same network profile), so
        a multi-AP fleet splits uplink contention structurally.
    egress, egress_link : a ``NetworkProfile`` (or name) arms the
        third hop — one cloud-egress stage crossed by *every* flow,
        whatever its AP. ``egress_link=None`` means ideal fair sharing
        (a wired cloud trunk has no MAC contention overhead); pass a
        ``SharedLinkModel`` to model per-flow egress overhead. An
        unconstrained egress (mean far above per-flow demand) leaves
        two-stage traces unchanged — the bottleneck min ignores it.
    predictor, refresh_every : a ``repro.core.predictor.
        LatencyPredictor`` arms the online contention refresh: every
        finalized request feeds its admission-time occupancy/backlog
        snapshot, realized queue wait and observed per-stage link
        shares to ``predictor.observe``, and every ``refresh_every``
        completions the cluster calls ``predictor.refresh()`` — after
        which SLO admission (``slo.predict_ttft``/``predict_tpot``)
        prefers the learned wait/share models over the analytic
        occupancy-dilation term. ``refresh_every=0`` never refreshes
        (observations still accumulate for an explicit ``refresh()``
        between runs); ``predictor=None`` is bit-identical to the
        analytic path.
    slo : an ``repro.serving.slo.SLOPolicy`` arms deadline-aware
        admission for requests that carry ``RequestSpec.deadline_s``:
        predicted-violation requests are downgraded to coarser stream
        quantization or shed, deadline slack maps to WFQ weight classes,
        and the per-request controller receives the deadline so
        near-deadline flows are not migrated onto congested links.
        Requests without a deadline are untouched (bit-identical to
        ``slo=None``).
    decode : a ``repro.serving.decode.DecodeConfig`` tuning the
        per-device continuous decode batch (max batch, tokens per
        dispatch, WFQ weight of the decode flow). Decoding itself is
        armed per request by ``RequestSpec.max_new_tokens > 0`` — a
        trace with ``max_new_tokens == 0`` everywhere is bit-identical
        to pre-decode behaviour whether or not ``decode`` is set; a
        decoding trace with ``decode=None`` uses ``DecodeConfig()``
        defaults.
    kvstore : a ``repro.core.costs.KVStoreModel`` arms cross-request KV
        reuse: one fleet-wide :class:`repro.serving.kvstore.CloudKVStore`
        of encoded chunk bitstreams plus a per-device
        :class:`~repro.serving.kvstore.DevicePrefixCache`. Requests that
        carry ``RequestSpec.content_ids`` resolve their chunks at
        admission — device prefix hits are preloaded (no link bytes, no
        compute), cloud store hits stream over the cached-egress leg
        (the flow path *without* the shared cloud-egress stage, plus the
        store's ``hit_latency_s``), misses stream the origin path and
        populate the store on completion. ``kvstore=None``, or a trace
        with ``content_ids=None`` everywhere at the model's cost
        defaults, is bit-identical to the no-reuse fleet.
    link_core : ``"vectorized"`` (default) drives the struct-of-arrays
        :class:`repro.serving.resources.LinkTopology`; ``"scalar"``
        selects the per-flow reference core
        (:class:`~repro.serving.resources.ScalarLinkTopology`) — the
        parity oracle the vectorized core is locked against.
    link_telemetry : ``False`` skips per-flow share accumulation in the
        link server (``RequestRecord.uplink_share`` reports 1.0 and
        ``stage_shares`` ``{}``); default ``True`` preserves current
        reports. Fleets that never read share telemetry save the
        per-event accumulation entirely.
    scenario : a ``repro.serving.scenarios.ScenarioTrace`` arms the
        hostile-world machinery: mid-stream AP handoffs (in-flight
        transfers lost, chunks re-enter the backlog via the engine's
        ``StreamLost`` leg), AP outage windows (uplink traces masked to
        the outage floor; in-flight streams through the AP aborted at
        window start; SLO admission sees the degraded health), and
        device churn (still-prefilling requests re-placed through
        admission on a live device; decoders finish locally). A trace
        with no events — or ``scenario=None`` — pushes zero extra
        events and is bit-identical to the static fleet.
    rebalancer : a ``repro.serving.scenarios.FleetRebalancer`` re-solves
        placement + policy fleet-wide (LP relaxation of the Eq. 1
        makespan split, warm-started basis-to-basis and through the
        online predictor's contention model) at every scenario event;
        AP moves are applied as handoffs and policy hints steer future
        admissions. Requires an armed ``scenario`` to ever fire.
    bw_trace / bw_dt : optional explicit uplink trace (otherwise an OU
        trace is drawn from the network profile with ``bw_seed``).
    """

    def __init__(self, cfg, spcfg, profile: str = "jetson-orin",
                 network="campus-wifi", *, capacity: int = 8,
                 max_concurrency: int = 8, closed_loop: bool = True,
                 static_util: float = 0.0,
                 link: Optional[SharedLinkModel] = None,
                 run_queue: Optional[RunQueueModel] = None,
                 n_devices: int = 1, nic=None,
                 nic_link: Optional[SharedLinkModel] = None,
                 n_aps: int = 1, ap_of_device=None,
                 egress=None,
                 egress_link: Optional[SharedLinkModel] = None,
                 slo: Optional["SLOPolicy"] = None,
                 policy_fn: Optional[Callable] = None,
                 decode: Optional[DecodeConfig] = None,
                 predictor: Optional[LatencyPredictor] = None,
                 refresh_every: int = 0,
                 memory: Optional[MemoryModel] = None,
                 memory_budget: Optional[float] = None,
                 kvstore: Optional[KVStoreModel] = None,
                 link_core: str = "vectorized",
                 link_telemetry: bool = True,
                 scenario: Optional[ScenarioTrace] = None,
                 rebalancer: Optional[FleetRebalancer] = None,
                 bw_trace: Optional[np.ndarray] = None, bw_dt: float = 0.01,
                 bw_seed: int = 991, seed: int = 0):
        self.cfg = cfg
        self.spcfg = spcfg
        self.profile_name = profile
        self.profile = PROFILES[profile]
        self.net: NetworkProfile = (NETWORKS[network]
                                    if isinstance(network, str) else network)
        self.capacity = run_queue.capacity if run_queue else capacity
        self.max_concurrency = max_concurrency
        self.closed_loop = closed_loop
        self.static_util = static_util
        self.link = link if link is not None else SharedLinkModel(self.net)
        self.run_queue = run_queue
        self.n_devices = n_devices
        if nic is None or isinstance(nic, (str, NetworkProfile)):
            self.nic: Optional[NetworkProfile] = (
                NETWORKS[nic] if isinstance(nic, str) else nic)
            self._nic_profiles = (None if self.nic is None
                                  else [self.nic] * n_devices)
        else:                                # per-device (asymmetric) NICs
            self._nic_profiles = [NETWORKS[p] if isinstance(p, str) else p
                                  for p in nic]
            assert len(self._nic_profiles) == n_devices, \
                "one NIC profile per device"
            self.nic = self._nic_profiles[0]
        self.nic_link = nic_link
        assert n_aps >= 1, n_aps
        self.n_aps = n_aps
        self.ap_of_device = tuple(ap_of_device) if ap_of_device is not None \
            else tuple(d % n_aps for d in range(n_devices))
        assert len(self.ap_of_device) == n_devices, \
            "one AP assignment per device"
        assert all(0 <= a < n_aps for a in self.ap_of_device), \
            f"AP assignment out of range [0, {n_aps})"
        self.egress: Optional[NetworkProfile] = (
            NETWORKS[egress] if isinstance(egress, str) else egress)
        self.egress_link = egress_link
        self.slo = slo
        self.policy_fn = policy_fn
        self.decode_cfg = decode
        self.predictor = predictor
        self.refresh_every = refresh_every
        if memory is None and memory_budget is not None:
            memory = MemoryModel(capacity_bytes=float(memory_budget))
        self.memory_model = memory
        self.kvstore_model = kvstore
        assert link_core in ("vectorized", "scalar"), link_core
        self.link_core = link_core
        self.link_telemetry = link_telemetry
        # hostile-world scenario: a ScenarioTrace with no events (or
        # None) pushes zero extra events and leaves the fleet
        # bit-identical to a scenario-free run
        self.scenario = scenario
        self.rebalancer = rebalancer
        self._ap_now: Optional[list] = None     # live AP map during run()
        self._outage_now: set = set()           # APs inside an outage
        self._policy_hints: dict = {}           # rebalancer policy picks
        self.bw_trace = bw_trace
        self.bw_dt = bw_dt
        self.bw_seed = bw_seed
        self.seed = seed
        # live-server handles (populated by run(); telemetry surface for
        # policy_fn callbacks)
        self._link_server: Optional[LinkTopology] = None
        self._run_queues: dict[int, DeviceRunQueue] = {}
        self._computing: dict[int, set] = {}
        self._batchers: dict[int, DecodeBatcher] = {}
        self._memory: dict[int, KVMemoryServer] = {}
        self._kvstore: Optional[CloudKVStore] = None
        self._prefix: dict[int, DevicePrefixCache] = {}
        self._n_finalized = 0                # predictor refresh cadence
        # events / wall-clock of the most recent run() (simcore profiling)
        self.last_sim_stats: Optional[dict] = None

    # ---- telemetry surface (valid during run()) ----
    @property
    def link_server(self) -> Optional[LinkTopology]:
        return self._link_server

    def active_flows(self) -> int:
        return self._link_server.n_active() if self._link_server else 0

    def device_load(self, device: int = 0) -> int:
        """In-service + waiting compute jobs on `device` (run-queue mode)
        or in-flight computing requests (closed-loop mode)."""
        if self.run_queue is not None:
            rq = self._run_queues.get(device)
            return rq.load() if rq else 0
        return len(self._computing.get(device, ()))

    def device_backlog_s(self, device: int = 0) -> float:
        """Service seconds committed to `device` (run-queue mode; 0.0 in
        closed-loop mode, where contention is already folded into the
        admission-time util and dilated service times)."""
        if self.run_queue is not None:
            rq = self._run_queues.get(device)
            return rq.backlog_s() if rq else 0.0
        return 0.0

    def decode_occupancy(self, device: int = 0) -> int:
        """Sequences decoding (or waiting to join the batch) on `device`
        — the batch a newly admitted request should expect to share its
        decode steps with (TPOT admission telemetry)."""
        bat = self._batchers.get(device)
        return bat.occupancy() if bat else 0

    def memory_server(self, device: int = 0) -> Optional[KVMemoryServer]:
        """The device's live KV memory server (None outside run() or on
        a cluster without a ``memory``/``memory_budget``)."""
        return self._memory.get(device)

    def memory_pressure(self, device: int = 0) -> float:
        """Resident KV over the device's capacity (0.0 unbounded or no
        memory server) — the signal :func:`telemetry_policy` and SLO
        admission fold in."""
        m = self._memory.get(device)
        return m.pressure() if m is not None else 0.0

    def _ap_of(self, device: int) -> int:
        """`device`'s *current* AP: the live handoff map while a
        scenario is armed, the static assignment otherwise."""
        if self._ap_now is not None:
            return self._ap_now[device]
        return self.ap_of_device[device] \
            if device < len(self.ap_of_device) else 0

    def uplink_health(self, device: int = 0) -> float:
        """Fraction of its nominal uplink bandwidth `device`'s current
        AP retains right now: the scenario's outage floor while the AP
        sits inside an outage window, 1.0 otherwise (always 1.0 on a
        scenario-free cluster — callers can multiply unconditionally).
        SLO admission (``slo.predict_ttft``) and the full-set
        :func:`telemetry_policy` fold this in."""
        if self.scenario is not None and self._outage_now \
                and self._ap_of(device) in self._outage_now:
            return self.scenario.outage_floor_frac
        return 1.0

    def _shared_stages(self, device: int) -> tuple:
        """(stage name, profiled mean bw, link model) for every *shared*
        stage of `device`'s path — its AP uplink, plus the cloud egress
        when the topology has one. Per-device NIC stages are excluded:
        they are exclusive, so their projection is the profile mean."""
        ap = self._ap_of(device)
        out = ((uplink_stage_name(ap, self.n_aps), self.net.mean_bw,
                self.link),)
        if self.egress is not None:
            out += (("egress", self.egress.mean_bw, self.egress_link),)
        return out

    def projected_flow_frac(self, device: int = 0) -> float:
        """Fraction of the exclusive profiled uplink bandwidth a new
        flow admitted on `device` should expect: for each shared stage
        of its path, stage mean x the fair share with this flow added,
        normalized by the uplink profile mean — the bottleneck stage
        governs. On single-uplink topologies this is exactly
        ``link.per_flow_fraction(n_active + 1)``. Telemetry for
        :func:`telemetry_policy` and ``slo.predict_ttft``."""
        best = 1.0
        for name, mean_bw, lm in self._shared_stages(device):
            st = self._link_server.stages.get(name) \
                if self._link_server is not None else None
            n = (len(st.active) if st is not None else 0) + 1
            frac = lm.per_flow_fraction(n) if lm else 1.0 / n
            best = min(best, frac * mean_bw / self.net.mean_bw)
        return best

    def projected_hit_frac(self, device: int = 0) -> float:
        """Like :meth:`projected_flow_frac`, but for a store-hit flow:
        the cached-egress leg skips the shared cloud-egress stage, so
        only the remaining shared stages (the AP uplink) bound it. On
        egress-free topologies this equals ``projected_flow_frac``."""
        best = 1.0
        for name, mean_bw, lm in self._shared_stages(device):
            if name == "egress":
                continue
            st = self._link_server.stages.get(name) \
                if self._link_server is not None else None
            n = (len(st.active) if st is not None else 0) + 1
            frac = lm.per_flow_fraction(n) if lm else 1.0 / n
            best = min(best, frac * mean_bw / self.net.mean_bw)
        return best

    def nic_mean_bw(self, device: int = 0) -> Optional[float]:
        """Profiled mean bandwidth of `device`'s own NIC stage (None
        without NIC stages) — the exclusive-stage cap on its projected
        stream rate."""
        if self._nic_profiles is None:
            return None
        return self._nic_profiles[device].mean_bw

    def observed_bottleneck_share(self, rid) -> Optional[float]:
        """Realized bottleneck fraction of the exclusive uplink
        bandwidth a finished flow received: min over the shared stages
        of its path of (mean stage share x stage mean / uplink mean).
        None when the flow never streamed. The predictor refresh's
        share observation."""
        if self._link_server is None:
            return None
        shares = self._link_server.stage_shares(rid)
        out = None
        for name, share in shares.items():
            if name.startswith("nic"):
                continue
            mean_bw = self.egress.mean_bw \
                if name == "egress" and self.egress is not None \
                else self.net.mean_bw
            v = share * mean_bw / self.net.mean_bw
            out = v if out is None else min(out, v)
        return out

    # ---- contention signals ----
    def _coupled_util(self, device: int) -> float:
        """Legacy dilation signal fed to attn_seconds while computing."""
        if self.run_queue is not None:
            # explicit queueing replaces fleet-internal dilation entirely;
            # static_util stays available for external (non-fleet) load
            return self.static_util
        if not self.closed_loop:
            return self.static_util
        return min(len(self._computing.get(device, ()))
                   / max(self.capacity, 1), 0.95)

    def _admission_util(self, device: int) -> float:
        """The predictor's U feature for planning at admission time."""
        if self.run_queue is not None:
            return queue_utilization(self.device_load(device), self.capacity)
        return self._coupled_util(device)

    # ---- topology construction ----
    def _build_link_server(self, integrator: BandwidthIntegrator
                           ) -> LinkTopology:
        """Materialize the link tree: AP 0's uplink is the cluster's
        main trace (`integrator`), further APs draw fresh traces from
        the same network profile, each device's NIC stage draws from
        its own profile, and the egress stage (when armed) from the
        egress profile — all on deterministic per-stage seeds, so the
        single-AP egress-free tree is bit-for-bit the two-stage (or,
        without NICs, single-stage) topology of earlier PRs."""
        topo_cls = ScalarLinkTopology if self.link_core == "scalar" \
            else LinkTopology
        if self._nic_profiles is None and self.n_aps == 1 \
                and self.egress is None:
            return single_link(integrator, self.link, cls=topo_cls,
                               telemetry=self.link_telemetry)
        horizon_s = (len(integrator.cum) - 1) * integrator.dt

        def draw(profile: NetworkProfile, seed: int) -> BandwidthIntegrator:
            rng = np.random.default_rng(seed)
            return BandwidthIntegrator(profile.trace(rng, horizon_s,
                                                     self.bw_dt),
                                       self.bw_dt)

        nics = None
        if self._nic_profiles is not None:
            nics = [draw(p, self.bw_seed + 7919 * (d + 1))
                    for d, p in enumerate(self._nic_profiles)]

        def draw_uplink(a: int) -> BandwidthIntegrator:
            # same rng stream as the scenario-free draw; outage windows
            # only mask the already-drawn samples (apply_outages returns
            # the input untouched when no window names this AP)
            rng = np.random.default_rng(self.bw_seed + 60013 * a)
            tr = self.net.trace(rng, horizon_s, self.bw_dt)
            scen = self.scenario
            if scen is not None and scen.outages:
                tr = apply_outages(tr, self.bw_dt, scen.outages, a,
                                   scen.outage_floor_frac)
            return BandwidthIntegrator(tr, self.bw_dt)

        uplinks = [integrator] + [draw_uplink(a)
                                  for a in range(1, self.n_aps)]
        egress = None if self.egress is None \
            else draw(self.egress, self.bw_seed + 15485863)
        return tree_topology(nics, uplinks, self.ap_of_device, egress,
                             uplink_link=self.link,
                             nic_link=self.nic_link,
                             egress_link=self.egress_link,
                             cls=topo_cls,
                             telemetry=self.link_telemetry)

    def _flow_path(self, device: int) -> tuple:
        return tree_path(device, self._ap_of(device), self.n_aps,
                         has_nic=self._nic_profiles is not None,
                         has_egress=self.egress is not None)

    def _hit_path(self, device: int) -> tuple:
        """Path of a cloud-store hit: the store's edge replica sits
        below the cloud-egress stage, so the cached bytes cross the
        device's NIC and its AP uplink but never the shared egress."""
        return tree_path(device, self._ap_of(device), self.n_aps,
                         has_nic=self._nic_profiles is not None,
                         has_egress=False)

    # ---- main loop ----
    def run(self, specs: list[RequestSpec]) -> FleetReport:
        specs = sorted(specs, key=lambda s: s.arrival_s)
        assert all(0 <= s.device < self.n_devices for s in specs), \
            f"request device out of range [0, {self.n_devices})"
        wls = [s.wl if s.wl is not None
               else synthesize(self.cfg, s.context_len,
                               DATASETS[s.dataset],
                               chunk_tokens=self.spcfg.chunk_tokens,
                               quant_bits=self.spcfg.quant_bits)
               for s in specs]

        total_bytes = sum(w.total_bytes() for w in wls)
        if self.bw_trace is None:
            horizon = max(20.0, 6 * total_bytes / self.net.mean_bw + 10
                          + (specs[-1].arrival_s if specs else 0.0))
            rng = np.random.default_rng(self.bw_seed)
            trace = self.net.trace(rng, horizon, self.bw_dt)
        else:
            trace = self.bw_trace
        # hostile-world scenario: arm only when it carries events — an
        # empty ScenarioTrace (or None) must leave the run bit-identical
        scen = self.scenario if (self.scenario is not None
                                 and self.scenario.armed()) else None
        if scen is not None and scen.outages:
            trace = apply_outages(trace, self.bw_dt, scen.outages, 0,
                                  scen.outage_floor_frac)
        integrator = BandwidthIntegrator(trace, self.bw_dt)
        link_server = self._build_link_server(integrator)
        self._link_server = link_server
        self._n_finalized = 0
        self._computing = {d: set() for d in range(self.n_devices)}
        self._run_queues = {
            d: DeviceRunQueue(
                self.capacity, self.run_queue.discipline,
                deadline_floor_s=self.run_queue.deadline_floor_s)
            for d in range(self.n_devices)} if self.run_queue else {}

        decode_cfg = self.decode_cfg if self.decode_cfg is not None \
            else DecodeConfig()
        self._batchers = {}
        self._decode_free: dict[int, float] = {}    # closed-loop serializer
        pending_decode: dict = {}     # queued dispatch key -> Dispatch
        self._memory = {d: KVMemoryServer(self.memory_model)
                        for d in range(self.n_devices)} \
            if self.memory_model is not None else {}
        # rid -> [outstanding reload legs, t_begin, stream dequant tail]
        reloads: dict[int, list] = {}

        # ---- cross-request KV reuse servers ----
        if self.kvstore_model is not None:
            self._kvstore = CloudKVStore(self.kvstore_model)
            self._prefix = {
                d: DevicePrefixCache(self.kvstore_model.device_capacity_bytes)
                for d in range(self.n_devices)}
        else:
            self._kvstore = None
            self._prefix = {}
        # content-key bookkeeping: which rids back each prefix-cache key
        # (copy semantics — several residents may hold the same prefix),
        # and each rid's registered keys (persists while parked)
        prefix_owners: dict[int, dict[int, set]] = {
            d: {} for d in range(self.n_devices)}
        rid_keys: dict[int, set] = {}

        active: dict[int, _ActiveRequest] = {}
        queue: list[tuple[int, RequestSpec]] = []
        records: list[RequestRecord] = []
        shed: list[ShedRecord] = []
        # typed event heap (repro.serving.simcore): the whole arrival
        # trace loads in one batched heapify; pushes carry EventKind ints
        # so the dispatch below is an int compare, not a string compare
        events = EventQueue()
        events.push_many((s.arrival_s, EventKind.ARRIVAL, rid, s)
                         for rid, s in enumerate(specs))
        arrival_s = {rid: s.arrival_s for rid, s in enumerate(specs)}
        now = 0.0
        makespan = 0.0
        n_link_events = 0
        t_wall0 = time.perf_counter()

        # ---- hostile-world state (inert on scenario-free runs) ----
        n_scen_events = 0
        reach_of: Optional[list] = None
        dead_devices: set[int] = set()
        dead_rids: set[int] = set()
        scen_tele = {"n_handoffs": 0, "n_handoff_noop": 0,
                     "n_streams_lost": 0, "bytes_lost": 0.0,
                     "n_churned": 0, "n_replaced": 0, "n_outages": 0,
                     "n_rebalances": 0}
        if scen is not None:
            self._ap_now = list(self.ap_of_device)
            self._outage_now = set()
            self._policy_hints = {}
            reach_of = [(a,) for a in self.ap_of_device]
            for h in scen.handoffs:
                events.push(h.t_s, EventKind.HANDOFF, h.device, h)
            for ce in scen.churn:
                events.push(ce.t_s, EventKind.CHURN, ce.device, ce)
            for w in scen.outages:
                events.push(w.t_start_s, EventKind.OUTAGE_START, w.ap, w)
                events.push(w.t_end_s, EventKind.OUTAGE_END, w.ap, w)
            n_scen_events = (len(scen.handoffs) + len(scen.churn)
                             + 2 * len(scen.outages))

        def push_compute(rid: int, chunk: Chunk, t0: float, dur: float):
            events.push(t0 + dur, EventKind.COMPUTE_DONE, rid, (chunk, t0))

        def batcher(dev: int) -> DecodeBatcher:
            if dev not in self._batchers:
                self._batchers[dev] = DecodeBatcher(self.cfg, self.profile,
                                                    decode_cfg)
            return self._batchers[dev]

        def start_jobs(dev: int, started):
            """Jobs entering run-queue service: prefill chunks, decode
            dispatches or reload recompute legs, told apart by key
            shape."""
            for key, t0, dur in started:
                if key[0] == "decode":
                    d = pending_decode.pop(key)
                    events.push(t0 + dur, EventKind.DECODE_DONE, key[1],
                                (d, t0))
                elif key[0] == "kvreload":
                    events.push(t0 + dur, EventKind.RELOAD_COMPUTE_DONE,
                                key[1], None)
                else:
                    push_compute(key[0], key[1], t0, dur)

        def submit_decode(dev: int):
            """Plan the device's next decode dispatch (if any) and put it
            on the device: through the run queue — where it competes with
            queued prefill chunks under the discipline — or back-to-back
            on the closed-loop decode serializer. Suspended (evicted)
            batch members trigger their KV reload here — the lazy
            "needed at next dispatch" point of the reload protocol."""
            bat = self._batchers.get(dev)
            if bat is None:
                return
            if self._memory:
                m = self._memory[dev]
                for r in bat.suspended_active():
                    if m.needs_reload(r):
                        start_reload(r)
            d = bat.next_dispatch()
            if d is None:
                return
            key = ("decode", dev, d.seq)
            if self.run_queue is not None:
                t0 = self._run_queues[dev].submit(
                    key, d.duration_s, now, flow=("decode", dev),
                    weight=decode_cfg.weight,
                    remaining_s=max(bat.remaining_service_s(),
                                    d.duration_s),
                    deadline_s=bat.min_deadline())
                if t0 is None:
                    pending_decode[key] = d
                    return
            else:
                t0 = max(now, self._decode_free.get(dev, 0.0))
                self._decode_free[dev] = t0 + d.duration_s
            events.push(t0 + d.duration_s, EventKind.DECODE_DONE, dev,
                        (d, t0))

        # ---- KV memory server wiring (all no-ops when unarmed) ----
        def pinned_rids(dev: int) -> set:
            """Rids the memory server must not evict: members of the
            device's in-flight decode dispatch (their KV is being read
            this very service interval)."""
            bat = self._batchers.get(dev)
            if bat is not None and bat.inflight is not None:
                return set(bat.inflight.token_offsets)
            return set()

        def idle_rids(dev: int) -> set:
            """Sequences enrolled but parked outside the active decode
            batch — the "idle" eviction policy's preferred victims."""
            bat = self._batchers.get(dev)
            return {mm.rid for mm in bat.waiting} if bat is not None \
                else set()

        def apply_evictions(dev: int, evs):
            """Act on the server's eviction events: demoted/dropped
            sequences are suspended in the batcher until their reload
            lands; in-place bits downgrades need no suspension."""
            bat = self._batchers.get(dev)
            for ev in evs:
                if ev.action == "downgrade":
                    continue
                if ev.action == "retire":
                    # a parked prefix segment was reclaimed: its keys
                    # stop being device-addressable, nothing to suspend
                    prefix_unindex(dev, ev.rid, forget=True)
                    continue
                vst = active.get(ev.rid)
                if vst is not None:
                    vst.n_evictions += 1
                if self._kvstore is not None:
                    # demoted/dropped KV is not addressable until reload
                    prefix_unindex(dev, ev.rid)
                if bat is not None:
                    bat.suspend(ev.rid)

        def charge_kv(st: _ActiveRequest, nbytes: float):
            dev = st.spec.device
            evs = self._memory[dev].charge(st.rid, nbytes, now,
                                           pinned=pinned_rids(dev),
                                           idle=idle_rids(dev))
            apply_evictions(dev, evs)

        # ---- cross-request KV reuse wiring (all no-ops when unarmed) ----
        def reuse_view(rid: int, spec: RequestSpec, wl):
            """Resolve the request's chunks against the reuse servers at
            admission: content keys from its prefix-closed span ids,
            device prefix matches first (near-free local hits), cloud
            store lookups for the rest (counted hits/misses). Returns
            (Chunk -> key, ChunkReuse) — (empty, None) for anonymous
            requests or unarmed stores."""
            if self._kvstore is None or spec.content_ids is None:
                return {}, None
            n_h = wl.n_h if (getattr(self.spcfg, "scheduler_mode", "engine")
                             == "paper" and wl.n_h > 1) else 1
            grid = ChunkGrid(n_t=wl.n_t, n_l=wl.n_l, n_h=n_h)
            ids = spec.content_ids
            # per-chunk allocation folds into the content key: a chunk
            # cached at 6 bits is a different artifact than the same
            # span at 4 — chunk_bits_for is pure on the workload's
            # measured signals, so it lands on exactly the widths
            # plan_policy will allocate (None when disarmed: every key
            # uses the uniform width, the pre-per-chunk keys verbatim)
            cb = B.chunk_bits_for(wl, grid, self.spcfg)
            key_of = {c: chunk_content_key(
                ids[c.t], c.l, model=self.cfg.name,
                bits=(cb[c] if cb is not None else self.spcfg.quant_bits),
                chunk_tokens=self.spcfg.chunk_tokens, head=c.h)
                for c in grid.chunks() if c.t < len(ids)}
            local_keys = self._prefix[spec.device].match(key_of.values())
            local, store = set(), set()
            for c, key in key_of.items():
                if key in local_keys:
                    local.add(c)
                elif self._kvstore.lookup(key, now):
                    store.add(c)
            return key_of, B.ChunkReuse(local=frozenset(local),
                                        store=frozenset(store),
                                        model=self.kvstore_model)

        def prefix_add(dev: int, rid: int, key: int, nbytes: float):
            """Register `rid` as a backer of prefix `key`; first backer
            makes the key resident in the device prefix cache."""
            rid_keys.setdefault(rid, set()).add(key)
            owners = prefix_owners[dev].setdefault(key, set())
            if rid not in owners:
                owners.add(rid)
                # a standalone-bounded cache may evict keys to make room:
                # drop their owner index (backers keep their rid_keys
                # entries — re-registration would simply re-insert)
                for evicted in self._prefix[dev].insert(key, nbytes, now):
                    prefix_owners[dev].pop(evicted, None)

        def prefix_unindex(dev: int, rid: int, *, forget: bool = False):
            """`rid`'s KV left device DRAM (demote/drop/retire/release):
            keys it backed lose one owner; orphaned keys leave the
            prefix cache. ``forget`` additionally drops the rid's key
            set (final — no reload will re-register)."""
            for key in rid_keys.get(rid, ()):
                owners = prefix_owners[dev].get(key)
                if owners is None:
                    continue
                owners.discard(rid)
                if not owners:
                    del prefix_owners[dev][key]
                    self._prefix[dev].remove(key)
            if forget:
                rid_keys.pop(rid, None)

        def prefix_reindex(dev: int, rid: int, nbytes: float):
            """`rid`'s KV is resident again (reload landed): re-register
            every key it had assembled."""
            for key in list(rid_keys.get(rid, ())):
                prefix_add(dev, rid, key, nbytes)

        def register_chunk(st: _ActiveRequest, chunk: Chunk, *,
                           streamed: bool):
            """One chunk of `st` finished assembling on the device: its
            content key becomes prefix-addressable, and a freshly
            streamed miss populates the cloud store (computed KV never
            reached the cloud encoder, so it cannot be cached there)."""
            key = st.key_of.get(chunk)
            if key is None:
                return
            if streamed and chunk not in st.plan.reuse_store:
                self._kvstore.insert(key, st.plan.bytes_map[chunk], now)
            prefix_add(st.spec.device, st.rid, key, st.kv_chunk_bytes)

        def start_reload(rid: int):
            """Plan and launch an evicted context's reload on the real
            servers: the stream leg as a link-topology flow, the
            recompute leg as a device run-queue job, the disk leg on the
            serial disk server — overlapping paths, exactly like the
            prefill scheduler's stream/compute stages."""
            st = active[rid]
            dev = st.spec.device
            m = self._memory[dev]
            ev = m.begin_reload(rid, now)
            plan = st.plan
            n_chunks = max(plan.grid.size, 1)
            res_per_chunk = ev.nbytes / n_chunks
            chunks = [(plan.bytes_map[c], res_per_chunk,
                       float(plan.planner.tc[plan.grid.index(c)]))
                      for c in plan.grid.chunks()]
            bw = self.net.mean_bw * self.projected_flow_frac(dev)
            nic_bw = self.nic_mean_bw(dev)
            if nic_bw is not None:
                bw = min(bw, nic_bw)
            pred = self.predictor
            if pred is not None and not pred.refreshed:
                pred = None
            wait = pred.predict_wait_s(self.device_load(dev), self.capacity,
                                       self.device_backlog_s(dev)) \
                if pred is not None else None
            if wait is None:
                wait = backlog_delay_s(self.device_backlog_s(dev),
                                       self.capacity)
            # a recompute leg occupies the same device the decode batch
            # needs: seed the comp path with the batch's outstanding
            # service too (the run-queue backlog can't see dispatches not
            # yet submitted), so the planner only recomputes when the
            # device is genuinely the cheap path
            bat = self._batchers.get(dev)
            if bat is not None:
                wait += bat.remaining_service_s()
            rp = plan_reload(chunks, mode=self.memory_model.reload,
                             profile=self.profile, stream_bw=max(bw, 1.0),
                             comp_wait_s=wait, disk=m.disk,
                             disk_backlog_s=m.disk.backlog_s(now)
                             if m.disk is not None else 0.0,
                             has_disk_copy=ev.from_disk)
            legs = 0
            if rp.stream_bytes > 0:
                link_server.add(RELOAD_FLOW_BASE + rid, rp.stream_bytes,
                                path=self._flow_path(dev))
                legs += 1
            if rp.comp_s > 0:
                key = ("kvreload", rid)
                if self.run_queue is not None:
                    t0 = self._run_queues[dev].submit(
                        key, rp.comp_s, now, flow=rid, weight=st.weight,
                        remaining_s=rp.comp_s, deadline_s=st.deadline_abs)
                    if t0 is not None:
                        events.push(t0 + rp.comp_s,
                                    EventKind.RELOAD_COMPUTE_DONE, rid,
                                    None)
                else:
                    self._computing[dev].add(key)
                    events.push(now + rp.comp_s,
                                EventKind.RELOAD_COMPUTE_DONE, rid, None)
                legs += 1
            if rp.disk_bytes > 0:
                t_done = m.disk.submit(rp.disk_bytes, now, op="read",
                                       n_ops=max(rp.n_disk, 1))
                events.push(t_done, EventKind.RELOAD_DISK_DONE, rid, None)
                legs += 1
            if legs == 0:            # zero-byte restore (degenerate)
                events.push(now, EventKind.RELOAD_DISK_DONE, rid, None)
                legs = 1
            reloads[rid] = [legs, now, rp.stream_proc_s]

        def reload_leg_done(rid: int):
            """One leg landed; when the last one does, the KV is resident
            again: recharge (pinned), resume the batcher member, account
            the stall, and let the batch dispatch."""
            state = reloads[rid]
            state[0] -= 1
            if state[0] > 0:
                return
            t_begin = state[1]
            del reloads[rid]
            st = active[rid]
            dev = st.spec.device
            evs = self._memory[dev].finish_reload(
                rid, now, pinned=pinned_rids(dev) | {rid},
                idle=idle_rids(dev))
            apply_evictions(dev, evs)
            if self._kvstore is not None:
                prefix_reindex(dev, rid, st.kv_chunk_bytes)
            st.reload_s += now - t_begin
            st.n_reloads += 1
            bat = self._batchers.get(dev)
            if bat is not None:
                bat.resume(rid)
            submit_decode(dev)

        def gated(rid: int, spec: RequestSpec) -> bool:
            """Admission gate on projected residency: hold a request
            while current + its full context would exceed ``gate_frac``
            of the device budget. Never gates an empty fleet, so the
            queue always drains."""
            mm = self.memory_model
            if not self._memory or mm is None or mm.gate_frac is None \
                    or mm.capacity_bytes is None or not active:
                return False
            need = context_kv_bytes(
                self.cfg, wls[rid].n_t * self.spcfg.chunk_tokens) \
                * mm.resident_bits / 16.0
            m = self._memory[spec.device]
            return m.resident_total + need > mm.gate_frac * m.capacity

        def drive(st: _ActiveRequest, reply=None, *, prime: bool = False):
            """Advance one session until it parks (Wait) or finishes.
            Returns the EngineResult when the session completed, else None."""
            dev = st.spec.device
            try:
                ev = next(st.gen) if prime else st.gen.send(reply)
                while True:
                    if isinstance(ev, StreamStart):
                        st.stream_chunk = ev.chunk
                        st.stream_t0 = now
                        st.stream_t_proc = ev.t_proc
                        st.stream_nbytes = ev.nbytes
                        link_server.add(st.rid, ev.nbytes,
                                        path=self._flow_path(dev))
                        ev = st.gen.send(None)
                    elif isinstance(ev, StoreHit):
                        # cloud-store hit: the cached bitstream rides the
                        # egress-free leg; the store's service latency
                        # lands in the on-device tail
                        st.stream_chunk = ev.chunk
                        st.stream_t0 = now
                        st.stream_t_proc = ev.t_proc \
                            + st.plan.store_model.hit_latency_s
                        st.stream_nbytes = ev.nbytes
                        link_server.add(st.rid, ev.nbytes,
                                        path=self._hit_path(dev))
                        ev = st.gen.send(None)
                    elif isinstance(ev, ComputeStart):
                        st.comp_chunk = ev.chunk
                        if self.run_queue is not None:
                            t0 = self._run_queues[dev].submit(
                                (st.rid, ev.chunk), ev.duration_s, now,
                                flow=st.rid, weight=st.weight,
                                remaining_s=max(st.comp_total_s
                                                - st.comp_done_s,
                                                ev.duration_s),
                                deadline_s=st.deadline_abs)
                            if t0 is not None:
                                push_compute(st.rid, ev.chunk, t0,
                                             ev.duration_s)
                            ev = st.gen.send(StartAck(t0))
                        else:
                            self._computing[dev].add(st.rid)
                            push_compute(st.rid, ev.chunk, now,
                                         ev.duration_s)
                            ev = st.gen.send(StartAck(now))
                    elif isinstance(ev, DecodeStart):
                        # context assembled: join the device's continuous
                        # decode batch (token-boundary join)
                        st.decoding = True
                        if self._memory:
                            # fully assembled == evictable from here on
                            self._memory[dev].mark_ready(st.rid, now)
                        batcher(dev).enroll(st.rid, ev.context_len,
                                            ev.n_tokens,
                                            deadline_s=st.deadline_abs)
                        submit_decode(dev)
                        ev = st.gen.send(None)
                    else:
                        assert isinstance(ev, Wait)
                        return None
            except StopIteration as stop:
                return stop.value

        def admit(rid: int, spec: RequestSpec) -> bool:
            """Admit one request (possibly quality-downgraded); returns
            False when the SLO layer shed it instead."""
            if spec.device in dead_devices:
                # churned target: re-place onto the least-loaded live
                # device (shed when the whole fleet is gone)
                live = [d for d in range(self.n_devices)
                        if d not in dead_devices]
                if not live:
                    shed.append(ShedRecord(rid=rid, spec=spec, t_shed_s=now,
                                           pred_ttft_s=float("inf"),
                                           reason="churn"))
                    return False
                spec = dataclasses.replace(
                    spec, device=min(live, key=self.device_load))
                scen_tele["n_replaced"] += 1
            policy = spec.policy
            if self.policy_fn is not None:
                policy = self.policy_fn(spec, self)
            elif self._policy_hints:
                # fleet rebalancer's per-device policy pick (only ever
                # populated while a scenario is armed with a rebalancer)
                policy = self._policy_hints.get(spec.device, policy)
            key_of, reuse = reuse_view(rid, spec, wls[rid])
            plan = B.plan_policy(policy, self.cfg, wls[rid],
                                 self.profile_name, self.net, self.spcfg,
                                 util=self._admission_util(spec.device),
                                 reuse=reuse)
            deadline_abs = (spec.arrival_s + spec.deadline_s
                            if spec.deadline_s is not None else None)
            weight = spec.weight
            downgraded = False
            pred_ttft = None
            if self.slo is not None and (spec.deadline_s is not None
                                         or spec.tpot_slo_s is not None):
                dec = decide_admission(self.slo, plan, self, spec, now)
                pred_ttft = dec.pred_ttft_s
                if dec.action == "shed":
                    shed.append(ShedRecord(rid=rid, spec=spec, t_shed_s=now,
                                           pred_ttft_s=dec.pred_ttft_s,
                                           reason=dec.reason,
                                           pred_tpot_s=dec.pred_tpot_s))
                    return False
                if dec.bits < plan.quality_bits:
                    cold = dec.cold_chunks
                    if cold is None and plan.chunk_bits is not None:
                        # whole-request downgrade of a per-chunk plan:
                        # same per-chunk arithmetic, cold set = everyone
                        cold = frozenset(plan.chunk_bits)
                    if cold is not None:
                        # cold-chunk downgrade: only the low-saliency
                        # chunks drop to dec.bits (never upward); hot
                        # chunks keep their width and their fidelity
                        cb = dict(plan.chunk_bits) if plan.chunk_bits \
                            else {c: plan.quality_bits
                                  for c in plan.grid.chunks()}
                        bmap = dict(plan.bytes_map)
                        for c in cold:
                            b_c = cb.get(c, plan.quality_bits)
                            nb = min(b_c, dec.bits)
                            if nb < b_c:
                                bmap[c] = chunk_bytes_at_bits(
                                    bmap[c], b_c, nb)
                                cb[c] = nb
                        plan.bytes_map = bmap
                        plan.chunk_bits = cb
                    else:
                        # coarser stream quantization: fewer bytes on
                        # the wire at QUALITY_OF_BITS[dec.bits] fidelity
                        scale = dec.bits / plan.quality_bits
                        plan.bytes_map = {c: v * scale
                                          for c, v in
                                          plan.bytes_map.items()}
                        plan.quality_bits = dec.bits
                    downgraded = True
                if (self.run_queue is not None
                        and self.run_queue.discipline == "wfq"
                        and deadline_abs is not None
                        and weight == 1.0):
                    weight = self.slo.weight_for_slack(deadline_abs - now)
            if self.slo is not None and deadline_abs is not None \
                    and plan.controller is not None:
                # deadline-aware migration guard is part of the SLO layer:
                # without slo=, deadlines are recorded but never acted on,
                # so no-SLO baselines keep exact pre-SLO behavior
                plan.controller.set_deadline(deadline_abs)
            gt = GroundTruthLatency(
                self.profile, self.cfg.resolved_head_dim
                if self.cfg.num_heads else 64)
            t_pred = {c: plan.planner.tc[i]
                      for i, c in enumerate(plan.grid.chunks())}
            eng = HybridEngine(
                grid=plan.grid, chunk_bytes=plan.bytes_map,
                active_blocks=plan.active_map, t_comp_pred=t_pred,
                gt=gt, profile=self.profile, bw=integrator,
                cfg_model=self.cfg, util=self.static_util,
                controller=plan.controller,
                seed=self.seed + spec.seed,
                max_new_tokens=spec.max_new_tokens,
                preloaded=plan.reuse_local, store_hits=plan.reuse_store,
                store_model=plan.store_model)
            comp_total = plan_compute_seconds(plan)
            st = _ActiveRequest(rid=rid, spec=spec, plan=plan,
                                gen=eng.session(
                                    plan.schedule,
                                    context_len=plan.context_len,
                                    t_start=now,
                                    util_fn=lambda d=spec.device:
                                        self._coupled_util(d)),
                                admit_s=now, weight=weight,
                                deadline_abs=deadline_abs,
                                comp_total_s=comp_total,
                                downgraded=downgraded,
                                pred_ttft_s=pred_ttft,
                                obs_load=self.device_load(spec.device),
                                obs_backlog_s=self.device_backlog_s(
                                    spec.device),
                                obs_n_flows=self.active_flows(),
                                key_of=key_of)
            # context bytes still to assemble (preloaded prefix chunks
            # never move) — the rebalancer's per-device demand signal
            st.bytes_left = sum(v for c, v in plan.bytes_map.items()
                                if c not in plan.reuse_local)
            if self._memory:
                self._memory[spec.device].admit(rid, now)
                # resident bytes each assembled chunk adds (full-precision
                # context KV split evenly across the plan's chunk grid,
                # scaled to the server's resident storage width)
                st.kv_chunk_bytes = (
                    context_kv_bytes(self.cfg, plan.context_len)
                    * self.memory_model.resident_bits / 16.0
                    / max(plan.grid.size, 1))
            if self._kvstore is not None and key_of:
                if not st.kv_chunk_bytes:
                    # no memory server: prefix-cache accounting still
                    # needs the chunk's resident footprint
                    st.kv_chunk_bytes = (
                        context_kv_bytes(self.cfg, plan.context_len)
                        / max(plan.grid.size, 1))
                if plan.reuse_local:
                    # copy semantics: the new request materializes its
                    # own copy of each preloaded prefix chunk. Charge
                    # them now — no completion events ever fire for
                    # preloaded chunks — and co-own their prefix keys.
                    if self._memory:
                        charge_kv(st, len(plan.reuse_local)
                                  * st.kv_chunk_bytes)
                    for c in plan.reuse_local:
                        prefix_add(spec.device, rid, key_of[c],
                                   st.kv_chunk_bytes)
            active[rid] = st
            res = drive(st, prime=True)
            if res is not None:
                finalize(st, res)
            return True

        def finalize(st: _ActiveRequest, res):
            nonlocal makespan
            active.pop(st.rid)
            self._computing[st.spec.device].discard(st.rid)
            kv_bits = 0
            if self._memory:
                m = self._memory[st.spec.device]
                kv_bits = m.bits_of(st.rid)
                parked = False
                if self._kvstore is not None and st.key_of:
                    # keep the assembled prefix addressable for the next
                    # request sharing it (radix-cache-style parking; the
                    # segment is the preferred eviction victim)
                    parked = m.park(st.rid, now)
                if not parked:
                    m.release(st.rid, now)
                    if self._kvstore is not None:
                        prefix_unindex(st.spec.device, st.rid, forget=True)
            quality = B._mixed_quality(res, st.plan.quality_bits,
                                       chunk_bits=st.plan.chunk_bits,
                                       active_map=st.plan.active_map)
            ttft = res.ttft_s - arrival_s[st.rid]
            ttlt = res.ttlt_s - arrival_s[st.rid]
            met = None
            if st.spec.deadline_s is not None \
                    or st.spec.tpot_slo_s is not None:
                met = True
                if st.spec.deadline_s is not None:
                    met = met and ttft <= st.spec.deadline_s
                if st.spec.tpot_slo_s is not None and res.n_tokens_out > 1:
                    met = met and res.tpot_s <= st.spec.tpot_slo_s
            records.append(RequestRecord(
                rid=st.rid, spec=st.spec, policy=st.plan.policy,
                admit_s=st.admit_s, context_done_s=res.context_done_s,
                done_s=res.ttft_s,
                ttft_s=ttft,
                queue_s=st.admit_s - arrival_s[st.rid],
                energy_j=res.energy["total_j"], quality=quality,
                n_streamed=res.n_streamed, n_computed=res.n_computed,
                n_migrations=res.n_migrations,
                stream_busy_s=res.stream_busy_s,
                compute_busy_s=res.compute_busy_s,
                bytes_streamed=res.bytes_streamed,
                compute_wait_s=res.compute_wait_s,
                n_compute_queued=res.n_compute_queued,
                uplink_share=link_server.mean_share(st.rid),
                slo_class=st.spec.slo_class,
                deadline_s=st.spec.deadline_s,
                slo_met=met,
                quant_bits=st.plan.quality_bits,
                downgraded=st.downgraded,
                n_tokens_out=res.n_tokens_out, ttlt_s=ttlt,
                tpot_s=res.tpot_s, tpot_slo_s=st.spec.tpot_slo_s,
                stage_shares=link_server.stage_shares(st.rid),
                reload_s=st.reload_s, n_evictions=st.n_evictions,
                n_reloads=st.n_reloads, kv_bits=kv_bits,
                n_local_hits=res.n_reused, n_store_hits=res.n_store_hits,
                bytes_hit_stream=res.bytes_hit_stream))
            if self.predictor is not None:
                share = self.observed_bottleneck_share(st.rid)
                self.predictor.observe(
                    load=st.obs_load, capacity=self.capacity,
                    backlog_s=st.obs_backlog_s,
                    wait_s=res.compute_wait_s,
                    n_flows=None if share is None else st.obs_n_flows + 1,
                    share=share)
                self._n_finalized += 1
                if self.refresh_every \
                        and self._n_finalized % self.refresh_every == 0:
                    self.predictor.refresh()
            # decode-off: res.ttlt_s == res.ttft_s, so the makespan is
            # unchanged from first-token accounting
            makespan = max(makespan, res.ttlt_s)
            while queue:
                if gated(*queue[0]):
                    break           # re-checked at the next finalize
                if admit(*queue.pop(0)):
                    break

        # ---- hostile-world event machinery (reachable only when armed) --
        def abort_stream(st: _ActiveRequest) -> bool:
            """Kill `st`'s in-flight transfer (handoff / outage onset):
            partially delivered bytes are wasted — an entropy-coded
            chunk bitstream is undecodable from a prefix — and the chunk
            re-enters the session's backlog via ``StreamLost`` (the
            controller may flip it to local compute). False when nothing
            was in flight, or the transfer already finished and only its
            on-device dequant tail (STREAM_AVAIL) is pending."""
            if st.stream_chunk is None:
                return False
            rem = link_server.remaining(st.rid)
            if rem is None:
                return False
            delivered = max(st.stream_nbytes - rem, 0.0)
            link_server.complete(st.rid)
            chunk = st.stream_chunk
            st.stream_chunk = None
            scen_tele["n_streams_lost"] += 1
            scen_tele["bytes_lost"] += delivered
            res = drive(st, StreamLost(chunk, now, delivered))
            if res is not None:
                finalize(st, res)
            return True

        def do_handoff(dev: int, new_ap: int) -> None:
            """Re-associate `dev` with `new_ap`: flip the live AP map
            *first* (re-issued streams must ride the new path), then
            abort its in-flight transfers. Same-AP handoffs are counted
            no-ops; reload flows stay on the old path (a roaming reload
            keeps draining — finite outages recover, so it cannot
            starve)."""
            if dev in dead_devices:
                return
            if self._ap_now[dev] == new_ap:
                scen_tele["n_handoff_noop"] += 1
                return
            scen_tele["n_handoffs"] += 1
            self._ap_now[dev] = new_ap
            for st in list(active.values()):
                if st.spec.device == dev:
                    abort_stream(st)

        def do_churn(ce) -> None:
            """Device failure: every still-prefilling request on it
            loses its in-flight work and is re-placed through admission
            on a live device (same arrival time — TTFT includes the
            lost work); decoding requests finish locally (decode needs
            no uplink and their context is already resident)."""
            dev = ce.device
            if dev in dead_devices:
                return
            dead_devices.add(dev)
            scen_tele["n_churned"] += 1
            victims = [st for st in active.values()
                       if st.spec.device == dev and not st.decoding]
            for st in victims:
                rid = st.rid
                # the device is gone: silently drop its link flow and
                # queued/in-service compute; the session is dead — no
                # StreamLost, just close the generator
                if st.stream_chunk is not None \
                        and link_server.remaining(rid) is not None:
                    link_server.complete(rid)
                if st.comp_chunk is not None:
                    if self.run_queue is not None:
                        start_jobs(dev, self._run_queues[dev].cancel(
                            (rid, st.comp_chunk), now))
                    else:
                        self._computing[dev].discard(rid)
                st.gen.close()
                dead_rids.add(rid)
                if self._memory:
                    self._memory[dev].release(rid, now)
                if self._kvstore is not None:
                    prefix_unindex(dev, rid, forget=True)
                active.pop(rid)
                target = ce.new_device
                if target is None or target in dead_devices:
                    live = [d for d in range(self.n_devices)
                            if d not in dead_devices]
                    target = min(live, key=self.device_load) \
                        if live else None
                if target is None:
                    shed.append(ShedRecord(
                        rid=rid, spec=st.spec, t_shed_s=now,
                        pred_ttft_s=float("inf"), reason="churn"))
                    continue
                # re-admit as a fresh rid so the replacement rides the
                # normal admission path (SLO ladder, reuse, policy fn)
                new_rid = len(wls)
                wls.append(wls[rid])
                arrival_s[new_rid] = arrival_s[rid]
                scen_tele["n_replaced"] += 1
                events.push(now, EventKind.ARRIVAL, new_rid,
                            dataclasses.replace(st.spec, device=target))

        def rebalance(reason: str) -> bool:
            """Snapshot the fleet and let the rebalancer re-solve
            placement + policy fleet-wide; apply AP moves as handoffs
            (aborting in-flight streams on moved devices) and stash the
            policy hints for future admissions. False when there is no
            rebalancer or it declined to act."""
            if self.rebalancer is None or self._ap_now is None:
                return False
            demand = np.zeros(self.n_devices)
            rate_obs: dict[int, list] = {}
            for st in active.values():
                d = st.spec.device
                demand[d] += max(st.bytes_left, 0.0)
                tot_t = float(np.sum(st.plan.planner.tc))
                if tot_t > 0:
                    rate_obs.setdefault(d, []).append(
                        sum(st.plan.bytes_map.values()) / tot_t)
            comp_rate = np.array(
                [float(np.mean(rate_obs[d])) if d in rate_obs
                 else self.net.mean_bw for d in range(self.n_devices)])
            ap_health = np.ones(self.n_aps)
            for a in self._outage_now:
                ap_health[a] = scen.outage_floor_frac
            ap_flows = np.zeros(self.n_aps)
            for a in range(self.n_aps):
                stg = link_server.stages.get(
                    uplink_stage_name(a, self.n_aps))
                if stg is not None:
                    ap_flows[a] = len(stg.active)
            dec = self.rebalancer.decide(FleetState(
                now=now, demand=demand, ap_of_device=list(self._ap_now),
                ap_health=ap_health, ap_flows=ap_flows,
                mean_bw=self.net.mean_bw, comp_rate=comp_rate,
                reach=list(reach_of), dead=frozenset(dead_devices)))
            if dec is None:
                return False
            scen_tele["n_rebalances"] += 1
            for d, a in sorted(dec.placement.items()):
                do_handoff(d, a)
            self._policy_hints = dict(dec.policy_hint)
            return True

        guard = 0
        limit = 1000 + 200 * sum(w.n_t * w.n_l * max(w.n_h, 1) for w in wls) \
            + 50 * sum(s.max_new_tokens for s in specs)
        if self.memory_model is not None \
                and self.memory_model.capacity_bytes is not None:
            # evict/reload cycles add events per token under pressure
            limit *= 6
        if scen is not None:
            # loss/re-stream cycles, churn re-admissions and rebalance
            # handoffs add events per scenario event; the guard stays a
            # livelock net, not a budget
            limit = limit * 4 + 200 * n_scen_events
        while events or link_server.n_active():
            guard += 1
            if guard > limit:
                raise RuntimeError("cluster livelock")
            nc = link_server.next_completion()
            if nc is not None and nc[0] <= events.peek_t():
                n_link_events += 1
                t_done, rid = nc
                link_server.advance(t_done)
                link_server.complete(rid)
                now = t_done
                if isinstance(rid, int) and rid >= RELOAD_FLOW_BASE:
                    # reload restream leg landed: on-device dequant tail,
                    # then the leg counts down like the others
                    r = rid - RELOAD_FLOW_BASE
                    events.push(t_done + reloads[r][2],
                                EventKind.RELOAD_STREAM_DONE, r, None)
                    continue
                st = active[rid]
                # decode+dequant tail happens on-device after the transfer
                events.push(t_done + st.stream_t_proc,
                            EventKind.STREAM_AVAIL, rid,
                            (st.stream_chunk, st.stream_t0))
                continue
            if not events:
                break
            ev = events.pop()
            t, kind, rid, payload = ev.t, ev.kind, ev.rid, ev.payload
            link_server.advance(t)
            now = t
            if dead_rids and rid in dead_rids and kind in (
                    EventKind.COMPUTE_DONE, EventKind.STREAM_AVAIL,
                    EventKind.RELOAD_STREAM_DONE,
                    EventKind.RELOAD_DISK_DONE,
                    EventKind.RELOAD_COMPUTE_DONE):
                continue        # stale event for a churned request
            if kind == EventKind.ARRIVAL:
                if len(active) < self.max_concurrency and not queue \
                        and not gated(rid, payload):
                    admit(rid, payload)
                else:
                    queue.append((rid, payload))
            elif kind == EventKind.COMPUTE_DONE:
                chunk, t0 = payload
                st = active[rid]
                st.comp_done_s += t - t0
                st.comp_chunk = None
                st.bytes_left -= st.plan.bytes_map[chunk]
                if self.run_queue is not None:
                    started = self._run_queues[st.spec.device].complete(
                        (rid, chunk), t)
                    start_jobs(st.spec.device, started)
                else:
                    self._computing[st.spec.device].discard(rid)
                if self._memory:
                    charge_kv(st, st.kv_chunk_bytes)
                if self._kvstore is not None:
                    register_chunk(st, chunk, streamed=False)
                res = drive(st, Completion("compute", chunk, t0, t))
                if res is not None:
                    finalize(st, res)
            elif kind == EventKind.DECODE_DONE:
                dev = rid                      # decode events carry the
                d, t0 = payload                # device in the rid slot
                bat = self._batchers[dev]
                started = self._run_queues[dev].complete(
                    ("decode", dev, d.seq), t) \
                    if self.run_queue is not None else []
                bat.dispatch_done()
                start_jobs(dev, started)
                members = sorted(d.token_offsets)   # one sort per dispatch
                if self._memory:
                    # the dispatch read every member's KV and grew it by
                    # one token per generated token
                    m = self._memory[dev]
                    tkb = token_kv_bytes(self.cfg)
                    for r in members:
                        m.touch(r, now)
                        if tkb > 0:
                            charge_kv(active[r],
                                      len(d.token_offsets[r]) * tkb)
                # deliver this dispatch's tokens to every member session
                for r in members:
                    st = active[r]
                    times = tuple(t0 + off for off in d.token_offsets[r])
                    cls = DecodeDone if r in d.finished else DecodeTick
                    res = drive(st, cls(
                        t_start=t0, t_end=t, token_times=times,
                        batch_size=d.batch_size,
                        busy_share_s=d.busy_share[r]))
                    if res is not None:
                        finalize(st, res)
                submit_decode(dev)
            elif kind == EventKind.STREAM_AVAIL:
                chunk, t0 = payload
                st = active[rid]
                st.stream_chunk = None
                st.bytes_left -= st.stream_nbytes
                if self._memory:
                    charge_kv(st, st.kv_chunk_bytes)
                if self._kvstore is not None:
                    register_chunk(st, chunk, streamed=True)
                res = drive(st, Completion("stream", chunk, t0, t))
                if res is not None:
                    finalize(st, res)
            elif kind in (EventKind.RELOAD_STREAM_DONE,
                          EventKind.RELOAD_DISK_DONE):
                reload_leg_done(rid)
            elif kind == EventKind.RELOAD_COMPUTE_DONE:
                dev = active[rid].spec.device
                if self.run_queue is not None:
                    started = self._run_queues[dev].complete(
                        ("kvreload", rid), t)
                    start_jobs(dev, started)
                else:
                    self._computing[dev].discard(("kvreload", rid))
                reload_leg_done(rid)
            elif kind == EventKind.HANDOFF:
                h = payload
                if h.reachable is not None:
                    # soft handoff: the rebalancer may place the device
                    # on any reachable AP (and move others); without
                    # one, the roam lands on the event's new_ap
                    reach_of[h.device] = tuple(h.reachable)
                    if not rebalance("handoff"):
                        do_handoff(h.device, h.new_ap)
                else:
                    reach_of[h.device] = (h.new_ap,)
                    do_handoff(h.device, h.new_ap)
                    rebalance("handoff")
            elif kind == EventKind.CHURN:
                do_churn(payload)
                rebalance("churn")
            elif kind == EventKind.OUTAGE_START:
                w = payload
                scen_tele["n_outages"] += 1
                self._outage_now.add(w.ap)
                # rebalance first — devices it moves off the dying AP
                # lose their streams via the handoff path; stragglers
                # left behind lose theirs here
                rebalance("outage")
                for st in list(active.values()):
                    if self._ap_of(st.spec.device) == w.ap:
                        abort_stream(st)
            elif kind == EventKind.OUTAGE_END:
                self._outage_now.discard(payload.ap)
                rebalance("outage_end")
        wall_s = time.perf_counter() - t_wall0
        n_events = events.n_popped + n_link_events
        SIM_STATS.record(n_events, wall_s)
        self.last_sim_stats = {
            "n_events": n_events,
            "n_heap_events": events.n_popped,
            "n_link_completions": n_link_events,
            "wall_s": wall_s,
            "events_per_s": n_events / wall_s if wall_s > 0 else None,
        }
        assert not active and not queue, "cluster finished with stuck work"
        assert all(b.idle() for b in self._batchers.values()), \
            "cluster finished with undrained decode batches"
        assert not reloads, "cluster finished with in-flight reloads"
        mem_summary = None
        if self._memory:
            tele = [m.telemetry() for m in self._memory.values()]
            caps = [t["capacity_bytes"] for t in tele]
            mem_summary = {
                "capacity_bytes": (None if any(c is None for c in caps)
                                   else sum(caps)),
                "peak_resident_bytes": max(
                    t["peak_resident_bytes"] for t in tele),
                "resident_p99_bytes": max(
                    t["resident_p99_bytes"] for t in tele),
            }
            for k in ("n_evictions", "n_downgrades", "n_demotions",
                      "n_drops", "n_reloads", "reload_bytes", "n_retired",
                      "charged_bytes_total", "disk_bytes_written",
                      "disk_bytes_read", "disk_busy_s"):
                vals = [t[k] for t in tele if k in t]
                if vals:
                    mem_summary[k] = type(vals[0])(sum(vals))
        reuse_summary = None
        if self._kvstore is not None:
            prefix_tele = [p.telemetry() for p in self._prefix.values()]
            reuse_summary = {
                "store": self._kvstore.telemetry(),
                "local_hits_total": sum(r.n_local_hits for r in records),
                "store_hits_total": sum(r.n_store_hits for r in records),
                "bytes_hit_stream_total": sum(r.bytes_hit_stream
                                              for r in records),
                # bytes that actually crossed the cloud origin: streamed
                # minus the store-hit bytes served from the edge replica
                "egress_bytes_total": sum(r.bytes_streamed
                                          - r.bytes_hit_stream
                                          for r in records),
                "prefix_lookups": sum(t["n_lookups"] for t in prefix_tele),
                "prefix_hits": sum(t["n_hits"] for t in prefix_tele),
            }
        scen_summary = None
        if scen is not None:
            if self.rebalancer is not None:
                scen_tele["n_lp_solves"] = self.rebalancer.n_solves
                scen_tele["n_lp_warm_hits"] = self.rebalancer.n_warm_hits
            scen_summary = dict(scen_tele)
        # clear the whole telemetry surface so a reused cluster never
        # exposes one run's end-state to the next run's policy_fn
        self._link_server = None
        self._run_queues = {}
        self._computing = {}
        self._batchers = {}
        self._memory = {}
        self._kvstore = None
        self._prefix = {}
        self._ap_now = None
        self._outage_now = set()
        self._policy_hints = {}
        return FleetReport(records=sorted(records, key=lambda r: r.rid),
                           makespan_s=makespan, n_arrived=len(specs),
                           shed=sorted(shed, key=lambda s: s.rid),
                           memory=mem_summary, reuse=reuse_summary,
                           scenario=scen_summary)
