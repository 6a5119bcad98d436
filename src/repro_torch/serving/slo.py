"""SLO-aware admission for the serving cluster (deadline scheduling layer).

Requests carry per-class TTFT deadlines (``RequestSpec.deadline_s``,
relative to arrival). This module supplies the three admission-time
mechanisms the cluster composes on top of the resource servers:

  - **TTFT prediction** — :func:`predict_ttft` projects a request's TTFT
    from its plan (per-chunk predicted stream/compute costs) and the live
    resource servers: the bottleneck fair share across the shared stages
    of the device's path (AP uplink, cloud egress) with this flow added,
    and the device run queue's service backlog. With a refreshed online
    predictor on the cluster, the learned wait/share models replace the
    analytic contention terms.
  - **Quality shedding** — :func:`decide_admission` compares the
    prediction against the deadline. A predicted violation first walks
    the request's KV stream down the quantization bitrate ladder
    (``repro.compression.quantize.downgrade_ladder``: fewer bits, fewer
    bytes, lower fidelity — the "don't waste bits" degradation lever);
    with ``SLOPolicy.cold_frac > 0`` the ladder applies to only the
    request's *cold* (low-attention-mass) chunks first, so the hot
    chunks the response actually depends on keep their fidelity. If
    even the coarsest level misses, the request is shed (rejected)
    instead of poisoning everyone's tail.
  - **Deadline-derived WFQ weights** — :meth:`SLOPolicy.weight_for_slack`
    maps deadline slack at admission to the ``DeviceRunQueue`` weight
    classes, so "interactive vs. background" falls out of the deadlines
    instead of hand-set weights.

With continuous batched decoding armed (``RequestSpec.max_new_tokens >
0``), a request may additionally carry a **TPOT SLO**
(``RequestSpec.tpot_slo_s``): :func:`predict_tpot` projects the batched
per-token latency against the device's live decode occupancy, and a
predicted violation sheds at admission — the quantization ladder cannot
help there, since decode-step cost is independent of streamed bitrate.

Requests without a deadline (TTFT or TPOT) bypass all mechanisms: a
cluster with ``slo=SLOPolicy()`` but no deadlines in the trace is
bit-identical to one without the policy (tested in tests/test_cluster.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.compression.quantize import downgrade_ladder
from repro_torch.core.costs import t_store_hit
from repro_torch.core.costs import t_stream as chunk_stream_seconds
from repro_torch.core.engine import (context_kv_bytes,
                               decode_first_token_seconds,
                               decode_step_seconds)
from repro_torch.core.predictor import backlog_delay_s
from repro_torch.serving.memory import predicted_reload_stall_s


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Admission-control policy knobs.

    Parameters
    ----------
    downgrade : try coarser stream quantization before rejecting.
    shed : reject requests whose predicted TTFT misses the deadline even
        at the coarsest ladder level (False = admit best-effort at the
        coarsest level instead).
    ladder : explicit downgrade bit-widths (finest first); ``None`` uses
        every ``BITRATE_LEVELS`` entry coarser than the plan's bits.
    headroom : safety multiplier on the prediction (1.1 = require 10%
        slack; admission uses ``pred * headroom <= deadline``).
    weight_bins : ``((slack_le_s, weight), ...)`` sorted by slack — the
        deadline-to-WFQ-weight mapping; a request whose admission-time
        slack is <= the first threshold gets that weight, etc. The
        mapping applies only to deadline-carrying requests still at the
        default weight 1.0: a hand-set ``RequestSpec.weight`` != 1.0
        always wins (weight 1.0 *is* the "unset" sentinel — a trace
        that hand-assigns exactly 1.0 and also wants deadline weights
        untouched should disable the mapping with ``weight_bins=()``).
    base_weight : weight for requests with slack beyond every bin (and
        the effective weight of deadline-less requests).
    cold_frac : fraction of a request's chunks (coldest by attention
        mass) the downgrade ladder applies to before touching the rest:
        a predicted violation first walks the ladder over only the cold
        set — the hot chunks the response actually depends on keep
        their width — and falls back to the whole-request walk when
        even cold-only at the coarsest level misses. 0.0 (default) is
        the legacy whole-request downgrade, bit-identical.
    """
    downgrade: bool = True
    shed: bool = True
    ladder: Optional[tuple] = None
    headroom: float = 1.0
    weight_bins: tuple = ((2.0, 8.0), (5.0, 4.0))
    base_weight: float = 1.0
    cold_frac: float = 0.0

    def weight_for_slack(self, slack_s: float) -> float:
        """WFQ weight class for a request with `slack_s` of deadline
        slack left at admission (tighter deadline -> heavier weight)."""
        for thresh, weight in self.weight_bins:
            if slack_s <= thresh:
                return float(weight)
        return float(self.base_weight)


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    action: str                 # "admit" | "shed"
    bits: int                   # effective stream quantization bits
    pred_ttft_s: float          # the prediction that justified `action`
    downgraded: bool = False
    reason: str = "ttft"        # which SLO leg decided ("ttft" | "tpot")
    pred_tpot_s: Optional[float] = None
    # chunks the downgrade applies to (cold-chunk admission); None =
    # whole-request downgrade, the legacy semantics
    cold_chunks: Optional[frozenset] = None


def plan_compute_seconds(plan) -> float:
    """Total planned compute seconds of a request plan (the scheduler's
    per-chunk predictions over the compute-assigned chunks). Shared by
    the admission TTFT projection and the cluster's SRPT remaining-work
    bookkeeping so the two never drift."""
    return sum(float(plan.planner.tc[plan.grid.index(c)])
               for stage in plan.schedule.stages for c in stage.comp)


def predict_ttft(plan, cluster, spec, now: float, *,
                 bits: Optional[int] = None,
                 cold: Optional[frozenset] = None) -> float:
    """Projected TTFT (arrival -> first token) if `spec` is admitted now.

    The projection is the planner's own cost model evaluated against the
    *live* servers rather than an idle device and exclusive link:

      - stream path: planned stream bytes (scaled to `bits` when
        downgrading) over the projected per-flow bandwidth — the
        bottleneck across the shared stages of the device's path
        (``cluster.projected_flow_frac``: its AP uplink fair share with
        this flow added, and the cloud-egress share on three-hop trees),
        capped by the device's own NIC mean (the exclusive stage) —
        plus the on-device decode/dequant tails;
      - compute path: planned per-chunk compute predictions, with the
        contention wait modeled as the max of two regimes — occupancy
        dilation (the engine keeps one chunk outstanding per request, so
        every one of this request's chunks competes with ~``load`` other
        flows for ``capacity`` slots over its whole lifetime) and the
        drain of the service seconds already committed to the device
        (:func:`repro.core.predictor.backlog_delay_s`, which dominates
        when a few long jobs rather than many flows hold the queue).
        The two regimes count the same queued chunks, so they are
        max-combined, never summed;
      - plus elapsed admission-queue wait and the first-token decode.

    Both contention terms are **analytic fallbacks**: when the cluster
    carries a refreshed ``repro.core.predictor.LatencyPredictor``
    (``ServingCluster(predictor=..., refresh_every=...)``), the learned
    models replace them — ``predict_share`` (observed bottleneck link
    efficiency) supplants the profiled fair-share fraction and
    ``predict_wait_s`` (least-squares on realized queue waits) supplants
    the occupancy-dilation/backlog max. An unrefreshed or absent
    predictor leaves this function bit-identical to the analytic form.

    The two paths overlap in the engine, so the context time is their
    max — the same fluid approximation the offline planner uses. The
    plan's per-chunk predictions already carry the admission-time U
    feature, so the projection errs conservative under load: admitted
    deadline-class requests should actually meet their deadlines.
    """
    chunk_bits = getattr(plan, "chunk_bits", None)

    def _factor(c) -> float:
        """Byte scaling of chunk `c` under the candidate downgrade:
        `cold` restricts the downgrade to the cold set (hot chunks keep
        their width), per-chunk plans downgrade each chunk from its OWN
        width (never upward). The legacy projection — uniform plan,
        whole-request downgrade — reduces to bits / plan.quality_bits
        exactly."""
        if bits is None:
            return 1.0
        if cold is not None and c not in cold:
            return 1.0
        b_c = chunk_bits.get(c, plan.quality_bits) if chunk_bits \
            else plan.quality_bits
        return min(b_c, bits) / b_c

    pred = getattr(cluster, "predictor", None)
    if pred is not None and not getattr(pred, "refreshed", False):
        pred = None
    n_flows = cluster.active_flows()
    share = pred.predict_share(n_flows + 1) if pred is not None else None
    frac = share if share is not None \
        else cluster.projected_flow_frac(spec.device)
    # hostile-world scenarios: an AP inside an outage window delivers
    # only the scenario's floor fraction — admission must see the dead
    # link, not the profiled mean (1.0 on scenario-less clusters, so the
    # projection is unchanged there)
    health_fn = getattr(cluster, "uplink_health", None)
    if health_fn is not None:
        frac *= health_fn(spec.device)
    bw_eff = cluster.net.mean_bw * frac
    nic_bw = cluster.nic_mean_bw(spec.device)
    if nic_bw is not None:
        # NIC-staged topology: the flow drains at the slower of its NIC
        # and its shared-stage bottleneck — ignoring the NIC would
        # over-admit exactly when the NIC is the bottleneck
        bw_eff = min(bw_eff, nic_bw)
    # cross-request reuse folds into the projection the same way it
    # bends the plan: local prefix hits cost nothing on the wire, store
    # hits ride the cached-egress leg at its own (egress-free) fair
    # share. Empty sets / missing attributes = the pre-reuse projection,
    # bit-identical.
    reuse_local = getattr(plan, "reuse_local", frozenset())
    reuse_store = getattr(plan, "reuse_store", frozenset())
    store_model = getattr(plan, "store_model", None)
    bw_hit = bw_eff
    if reuse_store and store_model is not None:
        hit_frac_fn = getattr(cluster, "projected_hit_frac", None)
        hit_frac = hit_frac_fn(spec.device) if hit_frac_fn is not None \
            else frac
        if hit_frac_fn is not None and health_fn is not None:
            # the hit leg still crosses the (possibly dead) AP uplink
            hit_frac *= health_fn(spec.device)
        bw_hit = cluster.net.mean_bw * hit_frac
        if nic_bw is not None:
            bw_hit = min(bw_hit, nic_bw)
    t_stream = 0.0
    for stage in plan.schedule.stages:
        for c in stage.stream:
            if c in reuse_local:
                continue
            if c in reuse_store and store_model is not None:
                t_stream += t_store_hit(plan.bytes_map[c] * _factor(c),
                                        bw_hit, cluster.profile,
                                        store_model)
                continue
            # the planner's own per-chunk stream cost, at the projected
            # bottleneck bandwidth (keeps admission in lockstep with
            # planning if the stream cost model evolves)
            t_stream += chunk_stream_seconds(
                plan.bytes_map[c] * _factor(c), bw_eff, cluster.profile)
    t_comp = plan_compute_seconds(plan)
    wait = pred.predict_wait_s(cluster.device_load(spec.device),
                               cluster.capacity,
                               cluster.device_backlog_s(spec.device)) \
        if pred is not None else None
    if wait is not None:
        t_comp = t_comp + wait
    else:
        dilation = 1.0 + cluster.device_load(spec.device) \
            / max(cluster.capacity, 1)
        t_comp = max(t_comp * dilation,
                     t_comp + backlog_delay_s(
                         cluster.device_backlog_s(spec.device),
                         cluster.capacity))
    t_first = decode_first_token_seconds(cluster.cfg, plan.context_len,
                                         cluster.profile)
    # memory-armed clusters: admitting this context may push the device
    # over its KV budget, and the induced evict/reload churn lands
    # squarely in this request's first-token path (zero when the cluster
    # has no finite memory server — the bit-parity guarantee)
    t_stall = predicted_reload_stall_s(
        cluster, spec.device,
        context_kv_bytes(cluster.cfg, plan.context_len))
    return (now - spec.arrival_s) + max(t_stream, t_comp) + t_first + t_stall


def predict_tpot(cluster, spec, context_len: int) -> float:
    """Projected per-token decode latency if `spec` is admitted now: one
    batched decode step over the device's current decode occupancy plus
    this request, every sequence at this request's mid-response context
    length. Conservative in the same way batching is: joiners raise the
    step cost only through their KV reads, the weight-read term stays
    amortized. Quality downgrades do not enter — decode-step cost is
    independent of the streamed bitrate, so a TPOT violation cannot be
    downgraded away, only shed."""
    from repro_torch.serving.decode import DecodeConfig
    dcfg = getattr(cluster, "decode_cfg", None) or DecodeConfig()
    b = min(cluster.decode_occupancy(spec.device) + 1, dcfg.max_batch)
    mid_len = context_len + max(spec.max_new_tokens, 1) // 2
    step = decode_step_seconds(cluster.cfg, [mid_len] * b, cluster.profile)
    # evict/reload stalls amortize across the whole response: a sequence
    # parked for a reload delivers no tokens while the stall runs, which
    # is exactly a per-token latency hit of stall / n_tokens (zero on
    # memory-less clusters)
    stall = predicted_reload_stall_s(
        cluster, spec.device, context_kv_bytes(cluster.cfg, context_len))
    return step + stall / max(spec.max_new_tokens, 1)


def decide_admission(policy: SLOPolicy, plan, cluster, spec,
                     now: float) -> AdmissionDecision:
    """Admit / downgrade / shed `spec` against its TTFT deadline and —
    when the request decodes under a ``tpot_slo_s`` — its TPOT SLO.

    TTFT leg: walks the quantization ladder finest-first; the first
    bit-width whose predicted TTFT (with `policy.headroom`) meets the
    deadline wins. When none does, the request is shed (``policy.shed``)
    or admitted best-effort at the coarsest level. TPOT leg: a predicted
    per-token violation sheds outright (coarser bits don't speed decode).
    """
    assert spec.deadline_s is not None or spec.tpot_slo_s is not None, \
        "decide_admission needs a TTFT deadline or a TPOT SLO"

    if spec.deadline_s is None:
        dec = AdmissionDecision("admit", plan.quality_bits,
                                predict_ttft(plan, cluster, spec, now))
    else:
        dec = _decide_ttft(policy, plan, cluster, spec, now)
    if (dec.action == "admit" and policy.shed
            and spec.tpot_slo_s is not None and spec.max_new_tokens > 0):
        pred_tpot = predict_tpot(cluster, spec, plan.context_len)
        if pred_tpot * policy.headroom > spec.tpot_slo_s:
            return dataclasses.replace(dec, action="shed", reason="tpot",
                                       pred_tpot_s=pred_tpot)
        dec = dataclasses.replace(dec, pred_tpot_s=pred_tpot)
    return dec


def cold_chunk_set(plan, frac: float) -> frozenset:
    """The coldest `frac` of the plan's chunks by attention mass — the
    chunks a quality downgrade hurts least, since attention barely
    reads them. Deterministic (mass, chunk-id) order."""
    chunks = sorted(plan.active_map,
                    key=lambda c: (plan.active_map[c], c))
    return frozenset(chunks[:int(len(chunks) * frac)])


def _decide_ttft(policy: SLOPolicy, plan, cluster, spec,
                 now: float) -> AdmissionDecision:
    deadline = spec.deadline_s

    pred = predict_ttft(plan, cluster, spec, now)
    if pred * policy.headroom <= deadline:
        return AdmissionDecision("admit", plan.quality_bits, pred)

    ladder = policy.ladder if policy.ladder is not None \
        else downgrade_ladder(plan.quality_bits)
    if policy.downgrade:
        if policy.cold_frac > 0.0:
            # cold-chunk admission: walk the ladder over only the
            # low-saliency chunks first — the hot chunks the response
            # depends on keep their width
            cold = cold_chunk_set(plan, policy.cold_frac)
            if cold:
                for bits in ladder:
                    pred = predict_ttft(plan, cluster, spec, now,
                                        bits=bits, cold=cold)
                    if pred * policy.headroom <= deadline:
                        return AdmissionDecision("admit", bits, pred,
                                                 downgraded=True,
                                                 cold_chunks=cold)
        for bits in ladder:
            pred = predict_ttft(plan, cluster, spec, now, bits=bits)
            if pred * policy.headroom <= deadline:
                return AdmissionDecision("admit", bits, pred,
                                         downgraded=True)
    if policy.shed:
        return AdmissionDecision("shed", plan.quality_bits, pred)
    if policy.downgrade and ladder:
        return AdmissionDecision("admit", ladder[-1], pred,
                                 downgraded=True)
    return AdmissionDecision("admit", plan.quality_bits, pred)
