"""End-to-end context-loading pipelines: SparKV and the paper's baselines.

Every pipeline maps (model cfg, workload stats, device profile, network
profile) -> EngineResult via the shared discrete-event engine, so TTFT and
energy numbers are directly comparable:

  sparkv         potential-aware greedy + runtime controller (§IV)
  strong_hybrid  fixed positional split overlap [25] + same compression
  cachegen       stream-only, bitrate ladder chosen from profiled bw (SLO)
  kivi           stream-only, fixed asymmetric low-bit quantization
  local_prefill  compute-only with block-sparse attention

Quality is reported as a relative response-quality score: computed chunks
are exact; streamed chunks carry the quantization level's fidelity (the
bits->fidelity curve is validated against real-model logit agreement in
benchmarks/bench_quality_validation.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs.base import SparKVConfig
from repro_torch.core.chunks import Chunk, ChunkGrid
from repro_torch.core.controller import RuntimeController
from repro_torch.core.costs import (GroundTruthLatency, KVStoreModel,
                              NetworkProfile, PROFILES, chunk_bytes_at_bits,
                              t_store_hit, t_stream)
from repro_torch.core.engine import BandwidthIntegrator, HybridEngine
from repro_torch.core.predictor import LatencyPredictor
from repro_torch.core import scheduler as sched
from repro_torch.data.workloads import WorkloadChunks

# bits -> relative response-quality of streamed KV (validated in
# bench_quality_validation; paper operates at >= 0.9 F1). Total over
# every width in 2..8: per-chunk allocation keys this map by arbitrary
# snapped widths, and totality is the backstop for any pre-snap caller.
QUALITY_OF_BITS = {8: 1.0, 7: 0.9985, 6: 0.997, 5: 0.992, 4: 0.968,
                   3: 0.89, 2: 0.72}


@dataclasses.dataclass
class PipelineResult:
    name: str
    ttft_s: float
    energy_j: float
    quality: float
    engine: object
    extras: dict = dataclasses.field(default_factory=dict)


def _engine_grid(cfg, wl: WorkloadChunks, spcfg: SparKVConfig):
    """Scheduling grid. scheduler_mode="paper" keeps the paper's (t, l, h)
    granularity (per-head streaming heterogeneity is the point — Fig. 4);
    "engine" aggregates heads into physically-computable (t, l) units
    (the concrete serving engine always uses n_h == 1 workloads)."""
    if spcfg.scheduler_mode == "paper" and wl.n_h > 1:
        return _paper_grid(cfg, wl)
    grid = ChunkGrid(n_t=wl.n_t, n_l=wl.n_l, n_h=1)
    bytes_map, active_map = {}, {}
    for t in range(wl.n_t):
        for l in range(wl.n_l):
            c = Chunk(t, l, 0)
            bytes_map[c] = float(wl.chunk_bytes[t, l].sum())
            active_map[c] = float(wl.active_blocks[t, l].sum())
    return grid, bytes_map, active_map


def _paper_grid(cfg, wl: WorkloadChunks):
    grid = ChunkGrid(n_t=wl.n_t, n_l=wl.n_l, n_h=wl.n_h)
    bytes_map, active_map = {}, {}
    for c in grid.chunks():
        bytes_map[c] = float(wl.chunk_bytes[c.t, c.l, c.h])
        active_map[c] = float(wl.active_blocks[c.t, c.l, c.h])
    return grid, bytes_map, active_map


@dataclasses.dataclass
class Planner:
    """Planning costs (what the scheduler believes)."""
    grid: ChunkGrid
    ts: np.ndarray
    tc: np.ndarray
    predictor: LatencyPredictor

    @classmethod
    def build(cls, cfg, grid, bytes_map, active_map, profile_name: str,
              net: NetworkProfile, spcfg: SparKVConfig, *, util: float = 0.0,
              predictor: Optional[LatencyPredictor] = None):
        profile = PROFILES[profile_name]
        pred = predictor or _predictor_cache(cfg, profile_name)
        ts = np.zeros(grid.size)
        tc = np.zeros(grid.size)
        t_idx = np.array([c.t for c in grid.chunks()], float)
        layers = np.array([c.l for c in grid.chunks()])
        act = np.array([active_map[c] for c in grid.chunks()], float)
        tc = pred.t_comp_batch(t_idx, layers, act, util)
        if grid.n_h > 1:
            # per-head units: attn(head blocks) + dense share of the layer
            tc = tc - pred.t_dense * (1 - 1.0 / grid.n_h)
        for i, c in enumerate(grid.chunks()):
            ts[i] = t_stream(bytes_map[c], net.mean_bw, profile)
        return cls(grid=grid, ts=ts, tc=tc, predictor=pred)


_PRED_CACHE: dict = {}


def _predictor_cache(cfg, profile_name: str) -> LatencyPredictor:
    key = (cfg.name, profile_name)
    if key not in _PRED_CACHE:
        p = LatencyPredictor(cfg, PROFILES[profile_name])
        p.fit(4000, epochs=150)
        _PRED_CACHE[key] = p
    return _PRED_CACHE[key]


def _run_engine(cfg, grid, bytes_map, active_map, planner, schedule,
                profile_name, net, spcfg, *, util=0.0, controller=None,
                seed=0, context_len, bw_seed=0):
    profile = PROFILES[profile_name]
    rng = np.random.default_rng(bw_seed)
    total_bytes = sum(bytes_map.values())
    horizon = max(20.0, 4 * total_bytes / net.mean_bw + 10)
    trace = net.trace(rng, horizon)
    bw = BandwidthIntegrator(trace, 0.01)
    gt = GroundTruthLatency(profile, cfg.resolved_head_dim
                            if cfg.num_heads else 64)
    t_pred = {c: planner.tc[i] for i, c in enumerate(grid.chunks())}
    eng = HybridEngine(grid=grid, chunk_bytes=bytes_map,
                       active_blocks=active_map, t_comp_pred=t_pred,
                       gt=gt, profile=profile, bw=bw, cfg_model=cfg,
                       util=util, controller=controller, seed=seed)
    return eng.run(schedule, context_len=context_len)


@dataclasses.dataclass(frozen=True)
class ChunkReuse:
    """Resolved cross-request reuse for one request at admission: `local`
    chunks are already resident on the device (prefix cache — near-free),
    `store` chunks are cloud-store hits (stream the cached bitstream over
    the egress-free leg, costed by :func:`repro.core.costs.t_store_hit`
    under `model`). Disjoint sets; everything else is a miss."""
    local: frozenset = frozenset()
    store: frozenset = frozenset()
    model: Optional[KVStoreModel] = None


@dataclasses.dataclass
class RequestPlan:
    """Everything the engine needs to execute one request under a given
    policy — the planning half of a pipeline, without running it. Used by
    the multi-request cluster (repro.serving.cluster), which drives many
    plans against shared resource servers (link topology + device run
    queues) on one clock instead of calling the closed run_* loops. The
    ``util`` the plan was built with is the predictor's U feature at
    admission — the cluster sources it from live telemetry (queue
    occupancy / in-flight compute), not a hand-set dial."""
    policy: str
    grid: ChunkGrid
    bytes_map: dict
    active_map: dict
    planner: Planner
    schedule: object
    controller: Optional[RuntimeController]
    quality_bits: int
    context_len: int
    # cross-request reuse legs (empty = no reuse layer; defaults keep
    # pre-reuse plans bit-identical)
    reuse_local: frozenset = frozenset()
    reuse_store: frozenset = frozenset()
    store_model: Optional[KVStoreModel] = None
    # per-chunk adaptive quantization (Chunk -> BITRATE_LEVELS width).
    # None = uniform plan, every consumer takes its exact pre-per-chunk
    # path; set by plan_policy when SparKVConfig.alloc_schedule is armed
    # and mutated by the cluster's SLO cold-chunk downgrade.
    chunk_bits: Optional[dict] = None


def chunk_bits_for(wl: WorkloadChunks, grid: ChunkGrid,
                   spcfg: SparKVConfig,
                   base_bits: Optional[int] = None) -> Optional[dict]:
    """Per-chunk bit-widths for `wl` under the config's allocation
    schedule, keyed by `grid` chunks — or None when the schedule is the
    "uniform" sentinel (per-chunk machinery disarmed). The allocation is
    a pure function of the workload's measured signals, so the reuse
    layer's content keys and the planner compute identical widths
    independently."""
    name = getattr(spcfg, "alloc_schedule", "uniform")
    if name == "uniform":
        return None
    from repro_torch.compression.allocate import allocate_bits, schedule_of
    base = spcfg.quant_bits if base_bits is None else base_bits
    act, ent = wl.active_blocks, wl.entropy_bits
    if grid.n_h == 1 and wl.n_h > 1:
        # engine-granularity grid over a per-head workload: pool heads
        act = act.sum(axis=2, keepdims=True)
        ent = ent.mean(axis=1, keepdims=True)
    arr = allocate_bits(act, ent, base, schedule_of(name))
    return {c: int(arr[c.t, c.l, c.h]) for c in grid.chunks()}


def plan_policy(policy: str, cfg, wl: WorkloadChunks, profile_name: str,
                net: NetworkProfile, spcfg: SparKVConfig, *,
                util: float = 0.0, adapt: bool = True,
                slo_s: float = 2.0, kivi_bits: int = 3,
                reuse: Optional[ChunkReuse] = None) -> RequestPlan:
    """Build the schedule/controller for `policy` without executing it.

    `reuse` (resolved hits from the serving layer's content-key lookup)
    bends the planning costs before the scheduler runs: local prefix
    hits cost ~nothing on the stream path (the greedy planner front-loads
    them; the engine then skips them outright), store hits cost
    ``t_store_hit`` instead of the origin ``t_stream``. The third leg
    beside stream/compute."""
    if policy not in PIPELINES:
        raise KeyError(f"unknown policy {policy!r}; have {list(PIPELINES)}")
    grid, bmap, amap = _engine_grid(cfg, wl, spcfg)
    bits = spcfg.quant_bits
    if policy == "cachegen":
        from repro_torch.compression.quantize import BITRATE_LEVELS
        levels = [b for b in BITRATE_LEVELS if QUALITY_OF_BITS[b] >= 0.9]
        bits = levels[0]
        for b in levels:
            scale = b / spcfg.quant_bits
            bits = b
            if sum(bmap.values()) * scale / net.mean_bw <= slo_s:
                break
        bmap = {c: v * bits / spcfg.quant_bits for c, v in bmap.items()}
    elif policy == "kivi":
        bits = kivi_bits
        bmap = {c: v * bits / spcfg.quant_bits for c, v in bmap.items()}
    chunk_bits = chunk_bits_for(wl, grid, spcfg, base_bits=bits)
    if chunk_bits is not None:
        # per-chunk adaptive allocation: re-express each chunk's wire
        # bytes at its allocated width. Chunks held at the base width
        # keep their bytes verbatim — v*b/b is not an exact roundtrip
        # for non-power-of-two widths, and the "flat" schedule must be
        # bit-identical to the uniform plan
        bmap = {c: (v if chunk_bits[c] == bits
                    else chunk_bytes_at_bits(v, bits, chunk_bits[c]))
                for c, v in bmap.items()}
    planner = Planner.build(cfg, grid, bmap, amap, profile_name, net, spcfg,
                            util=util)
    if reuse is not None and (reuse.local or reuse.store):
        # bend the stream-side planning costs: a local prefix hit is
        # near-free (schedule it first, the engine skips it), a store hit
        # costs the cached-egress leg instead of the origin stream
        profile = PROFILES[profile_name]
        for i, c in enumerate(grid.chunks()):
            if c in reuse.local:
                planner.ts[i] = 1e-9   # ~free, nonzero: 1/ts priorities
            elif c in reuse.store and reuse.model is not None:
                planner.ts[i] = t_store_hit(bmap[c], net.mean_bw, profile,
                                            reuse.model)
    controller = None
    if policy == "sparkv":
        schedule = sched.GreedyScheduler(
            grid, planner.ts, planner.tc,
            stage_budget_s=spcfg.stage_budget_s,
            w_immediate=spcfg.w_immediate,
            w_potential=spcfg.w_potential).run()
        if adapt:
            controller = RuntimeController(spcfg, net.mean_bw)
            if reuse is not None and reuse.store:
                controller.set_store_hits(reuse.store)
    elif policy == "strong_hybrid":
        schedule = sched.positional_hybrid(grid, planner.ts, planner.tc)
    elif policy == "local_prefill":
        schedule = sched.compute_only(grid, planner.ts, planner.tc)
    else:                                   # cachegen / kivi: stream-only
        schedule = sched.stream_only(grid, planner.ts, planner.tc)
    return RequestPlan(policy=policy, grid=grid, bytes_map=bmap,
                       active_map=amap, planner=planner, schedule=schedule,
                       controller=controller, quality_bits=bits,
                       context_len=wl.context_len,
                       reuse_local=(reuse.local if reuse else frozenset()),
                       reuse_store=(reuse.store if reuse else frozenset()),
                       store_model=(reuse.model if reuse else None),
                       chunk_bits=chunk_bits)


def _mixed_quality(res, bits: int, *, chunk_bits: Optional[dict] = None,
                   active_map: Optional[dict] = None) -> float:
    """Response-quality score of one executed request.

    Uniform plans (chunk_bits None): the unweighted mix — computed
    chunks exact, streamed/reused chunks at QUALITY_OF_BITS[bits].

    Per-chunk plans: the *saliency-weighted* mix over the whole grid,
    each non-computed chunk at its own width's fidelity, weighted by the
    attention mass actually reading it (`active_map`). The weighting is
    the point of per-chunk allocation: QUALITY_OF_BITS is concave in
    bits, so an unweighted mean always favors uniform widths — but a
    response's fidelity is dominated by the chunks attention reads,
    which is exactly where the allocator spends the bits.
    """
    n_reused = getattr(res, "n_reused", 0)
    if chunk_bits is None:
        # reused chunks carry streamed fidelity: the cached artifact was
        # encoded at the same quantization level as a fresh stream
        n = res.n_streamed + res.n_computed + n_reused
        q_stream = QUALITY_OF_BITS[bits]
        return (res.n_computed * 1.0
                + (res.n_streamed + n_reused) * q_stream) / max(n, 1)
    computed = getattr(res, "computed_set", None) or set()
    wsum = qsum = 0.0
    for c, b in chunk_bits.items():
        w = float(active_map.get(c, 1.0)) if active_map else 1.0
        w = max(w, 1e-9)
        q = 1.0 if c in computed else QUALITY_OF_BITS[b]
        wsum += w
        qsum += w * q
    return qsum / max(wsum, 1e-12)


def _run_plan(plan: RequestPlan, cfg, profile_name, net, spcfg, *,
              util=0.0, seed=0) -> PipelineResult:
    res = _run_engine(cfg, plan.grid, plan.bytes_map, plan.active_map,
                      plan.planner, plan.schedule, profile_name, net, spcfg,
                      util=util, controller=plan.controller, seed=seed,
                      context_len=plan.context_len, bw_seed=seed + 991)
    extras = {}
    if plan.policy == "sparkv":
        extras["migrations"] = res.n_migrations
    elif plan.policy == "cachegen":
        extras["bits"] = plan.quality_bits
    return PipelineResult(plan.policy, res.ttft_s, res.energy["total_j"],
                          _mixed_quality(res, plan.quality_bits,
                                         chunk_bits=plan.chunk_bits,
                                         active_map=plan.active_map),
                          res, extras)


def run_sparkv(cfg, wl: WorkloadChunks, profile_name: str,
               net: NetworkProfile, spcfg: SparKVConfig, *, util=0.0,
               seed=0, adapt: bool = True) -> PipelineResult:
    plan = plan_policy("sparkv", cfg, wl, profile_name, net, spcfg,
                       util=util, adapt=adapt)
    return _run_plan(plan, cfg, profile_name, net, spcfg, util=util,
                     seed=seed)


def run_strong_hybrid(cfg, wl, profile_name, net, spcfg, *, util=0.0,
                      seed=0) -> PipelineResult:
    plan = plan_policy("strong_hybrid", cfg, wl, profile_name, net, spcfg,
                       util=util)
    return _run_plan(plan, cfg, profile_name, net, spcfg, util=util,
                     seed=seed)


def run_local_prefill(cfg, wl, profile_name, net, spcfg, *, util=0.0,
                      seed=0) -> PipelineResult:
    plan = plan_policy("local_prefill", cfg, wl, profile_name, net, spcfg,
                       util=util)
    return _run_plan(plan, cfg, profile_name, net, spcfg, util=util,
                     seed=seed)


def run_cachegen(cfg, wl, profile_name, net, spcfg, *, util=0.0, seed=0,
                 slo_s: float = 2.0) -> PipelineResult:
    """Stream-only with a bitrate ladder: pick the finest level whose
    projected delivery meets the SLO under profiled bandwidth."""
    plan = plan_policy("cachegen", cfg, wl, profile_name, net, spcfg,
                       util=util, slo_s=slo_s)
    return _run_plan(plan, cfg, profile_name, net, spcfg, util=util,
                     seed=seed)


def run_kivi(cfg, wl, profile_name, net, spcfg, *, util=0.0,
             seed=0, bits: int = 3) -> PipelineResult:
    """Stream-only with fixed asymmetric low-bit quantization (KIVI-like):
    2-bit-class keys/values -> small transfers, lower fidelity."""
    plan = plan_policy("kivi", cfg, wl, profile_name, net, spcfg,
                       util=util, kivi_bits=bits)
    return _run_plan(plan, cfg, profile_name, net, spcfg, util=util,
                     seed=seed)


PIPELINES = {
    "sparkv": run_sparkv,
    "strong_hybrid": run_strong_hybrid,
    "cachegen": run_cachegen,
    "kivi": run_kivi,
    "local_prefill": run_local_prefill,
}
