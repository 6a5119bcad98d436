"""The port's fleet stack against the JAX package's: the same trace, the
same knobs and the same planner costs give bit-identical fleet reports.

Both packages plan every admission through their ``core.baselines``
planner cache. Both caches hold one numpy stub here (``FrozenPlanner``,
around a CPU port predictor), so a last-ulp difference between XLA and
torch matmuls cannot flip a greedy choice; everything downstream of the
planner costs is numpy in both packages and must agree exactly.
"""
import dataclasses
import inspect
import math
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import repro.configs as jconfigs  # noqa: E402
import repro.core.costs as jcosts  # noqa: E402
import repro.core.predictor as jpredictor  # noqa: E402
import repro.serving.cluster as jcluster  # noqa: E402
import repro.serving.decode as jdecode  # noqa: E402
import repro.serving.scenarios as jscenarios  # noqa: E402
import repro.serving.slo as jslo  # noqa: E402
import repro.serving.traffic as jtraffic  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.core.costs as tcosts  # noqa: E402
import repro_torch.core.predictor as tpredictor  # noqa: E402
import repro_torch.device as tdevice  # noqa: E402
import repro_torch.serving.cluster as tcluster  # noqa: E402
import repro_torch.serving.decode as tdecode  # noqa: E402
import repro_torch.serving.engine as tengine  # noqa: E402
import repro_torch.serving.scenarios as tscenarios  # noqa: E402
import repro_torch.serving.slo as tslo  # noqa: E402
import repro_torch.serving.traffic as ttraffic  # noqa: E402
from repro.core import baselines as JB  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serving.engine import SparKVServer as JServer  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.core import baselines as TB  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import SparKVServer  # noqa: E402
from test_torch_serving import ARCH, SP as SERVER_SP  # noqa: E402
from test_torch_serving import FrozenPlanner, _port_context  # noqa: E402

NAME, PROFILE, NET = "sparkv-qwen3-4b", "jetson-orin", "campus-wifi"

JAX = types.SimpleNamespace(
    configs=jconfigs, costs=jcosts, cluster=jcluster, decode=jdecode,
    scenarios=jscenarios, slo=jslo, traffic=jtraffic, predictor=jpredictor)
TORCH = types.SimpleNamespace(
    configs=tconfigs, costs=tcosts, cluster=tcluster, decode=tdecode,
    scenarios=tscenarios, slo=tslo, traffic=ttraffic, predictor=tpredictor)


@pytest.fixture(scope="module")
def stub():
    p = tpredictor.LatencyPredictor(tconfigs.get_config(NAME),
                                    tcosts.PROFILES[PROFILE], device="cpu")
    p.fit(4000, epochs=150)
    return FrozenPlanner(p)


@pytest.fixture
def planned(stub, monkeypatch):
    """Both packages' planner caches hold the shared stub, for the full
    config and for the smoke servers' config."""
    for cache in (JB._PRED_CACHE, TB._PRED_CACHE):
        for name in (NAME, NAME + "-smoke"):
            monkeypatch.setitem(cache, (name, PROFILE), stub)
    return stub


def _fingerprint(report):
    """Every per-request observable, exactly as produced (the tuple of
    tests/test_simcore.py::_fleet_fingerprint)."""
    return [(r.spec.arrival_s, r.ttft_s, r.ttlt_s, r.energy_j,
             r.uplink_share,
             r.compute_wait_s, r.bytes_streamed, r.policy,
             tuple(sorted(r.stage_shares.items())))
            for r in report.records]


def _plain(obj):
    """A report's or spec's contents as plain values (numbers, strings,
    tuples, dicts), so the two packages' dataclasses compare; NaN reads
    as its repr, so two NaN fields compare equal."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            (f.name, _plain(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return tuple(sorted((k, _plain(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_plain(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.shape, obj.tobytes())
    if isinstance(obj, (float, np.floating)) and math.isnan(obj):
        return "nan"
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _assert_same_report(jrep, trep):
    assert _fingerprint(trep) == _fingerprint(jrep)
    assert _plain(trep.summary()) == _plain(jrep.summary())
    assert _plain(trep.records) == _plain(jrep.records)
    assert _plain(trep.shed) == _plain(jrep.shed)
    for extra in ("memory", "reuse", "scenario"):
        assert _plain(getattr(trep, extra)) == _plain(getattr(jrep, extra))


def _cluster(ns, **kw):
    kw.setdefault("max_concurrency", 8)
    return ns.cluster.ServingCluster(
        ns.configs.get_config(NAME),
        ns.configs.SparKVConfig(scheduler_mode="engine"), PROFILE, NET, **kw)


def _both(make_specs, make_cluster):
    """Run the same fleet through both packages; the traces must already
    be equal. Returns the two reports, reference first."""
    jspecs, tspecs = make_specs(JAX), make_specs(TORCH)
    assert _plain(tspecs) == _plain(jspecs)
    jrep = make_cluster(JAX).run(jspecs)
    trep = make_cluster(TORCH).run(tspecs)
    _assert_same_report(jrep, trep)
    return jrep, trep


def _poisson(n=16, rate=2.0, seed=5, max_context=2048):
    return lambda ns: ns.traffic.poisson_trace(n, rate,
                                               max_context=max_context,
                                               seed=seed)


# ---------------------------------------------------------------------------
# the cluster, copied: run queues x memory pressure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("discipline", ["fifo", "wfq", "srpt"])
@pytest.mark.parametrize("mem_cap", [None, 2e8])
def test_cluster_bit_identical(planned, discipline, mem_cap):
    """poisson_trace(16, 2.0, max_context=2048, seed=5) on 2 devices, as
    tests/test_simcore.py runs it: identical reports across run-queue
    disciplines, with and without KV memory pressure."""
    jrep, _ = _both(_poisson(), lambda ns: _cluster(
        ns, n_devices=2, run_queue=ns.costs.RunQueueModel(2, discipline),
        memory=(ns.costs.MemoryModel(capacity_bytes=mem_cap)
                if mem_cap else None)))
    assert len(jrep.records) == 16
    if mem_cap:
        assert jrep.memory["capacity_bytes"] == 2 * mem_cap


@pytest.mark.parametrize("policy", ["lru", "idle", "bits"])
def test_memory_pressure_with_decode_bit_identical(planned, policy):
    """First-token fleets never evict; decoding ones do. A budget under
    the fleet's peak residency forces evictions and reloads (or, under
    ``bits``, requantization) through the reload planner."""
    def specs(ns):
        prof = ns.traffic.TrafficProfile(
            rate_rps=2.0, arrival="poisson", n_devices=2, max_context=2048,
            out_len_mix=((24, 1.0),))
        return ns.traffic.generate_trace(prof, 10, seed=5)
    jrep, _ = _both(specs, lambda ns: _cluster(
        ns, n_devices=2, run_queue=ns.costs.RunQueueModel(2, "wfq"),
        decode=ns.decode.DecodeConfig(max_batch=4),
        memory=ns.costs.MemoryModel(capacity_bytes=4e8, policy=policy)))
    m = jrep.memory
    assert m["n_evictions"] + m["n_downgrades"] > 0


@pytest.mark.parametrize("coupling", [dict(closed_loop=True),
                                      dict(closed_loop=False,
                                           static_util=0.3)])
def test_contention_coupling_bit_identical(planned, coupling):
    """The legacy couplings (no run queue): closed-loop utilization from
    in-flight compute, and a static utilization."""
    _both(_poisson(n=12, rate=3.0, seed=2), lambda ns: _cluster(
        ns, max_concurrency=4, **coupling))


def test_kvstore_overlap_bit_identical(planned):
    """Cross-request reuse at 0.75 prefix overlap, a cloud-egress stage
    behind two AP uplinks:
    store hits, prefix-cache hits and the egress ledger agree."""
    def specs(ns):
        prof = ns.traffic.TrafficProfile(
            rate_rps=4.0, arrival="poisson", n_devices=2, max_context=2048,
            out_len_mix=((8, 1.0),), prefix_pool=3, prefix_zipf_a=1.2,
            prefix_frac=0.75)
        return ns.traffic.generate_trace(prof, 8, seed=17)
    jrep, _ = _both(specs, lambda ns: _cluster(
        ns, n_devices=2, n_aps=2, egress="cloud-egress",
        run_queue=ns.costs.RunQueueModel(2, "fifo"),
        decode=ns.decode.DecodeConfig(max_batch=4),
        kvstore=ns.costs.KVStoreModel(capacity_bytes=float(4 << 30),
                                      device_capacity_bytes=float(8 << 30))))
    assert jrep.reuse["store"]["n_hits"] + jrep.reuse["local_hits_total"] > 0


@pytest.mark.parametrize("case", ["downgrade", "shed"])
def test_slo_admission_bit_identical(planned, case):
    """Deadline-aware admission (tests/test_cluster.py's two overload
    scenarios): the same downgrades and the same sheds."""
    def specs(ns):
        S = ns.cluster.RequestSpec
        if case == "downgrade":
            return [S(arrival_s=0.2 * i, context_len=8192,
                      policy="strong_hybrid", seed=i, deadline_s=9.0,
                      slo_class="interactive") for i in range(8)]
        return ([S(arrival_s=0.0, context_len=8192, policy="sparkv",
                   seed=0, slo_class="batch")]
                + [S(arrival_s=0.4 * i, context_len=4096, policy="sparkv",
                     seed=i, deadline_s=5.0, slo_class="interactive")
                   for i in range(1, 8)])
    disc = "wfq" if case == "downgrade" else "srpt"
    n_q = 2 if case == "downgrade" else 1
    jrep, _ = _both(specs, lambda ns: _cluster(
        ns, run_queue=ns.costs.RunQueueModel(n_q, disc),
        slo=ns.slo.SLOPolicy()))
    s = jrep.summary()
    assert (s["n_downgraded"] if case == "downgrade" else s["n_shed"]) > 0


def test_decode_with_tpot_slo_bit_identical(planned):
    """Continuous batched decode after the first token, with a per-token
    SLO armed under SLO admission."""
    def specs(ns):
        prof = ns.traffic.TrafficProfile(
            rate_rps=2.0, arrival="poisson", n_devices=2, max_context=4096,
            out_len_mix=((8, 0.5), (24, 0.5)),
            slo_mix=(("interactive", 8.0, 0.05, 0.6),
                     ("batch", None, None, 0.4)))
        return ns.traffic.generate_trace(prof, 10, seed=4)
    jrep, _ = _both(specs, lambda ns: _cluster(
        ns, n_devices=2, run_queue=ns.costs.RunQueueModel(2, "wfq"),
        decode=ns.decode.DecodeConfig(max_batch=4), slo=ns.slo.SLOPolicy()))
    assert any(r.n_tokens_out > 1 for r in jrep.records)


def test_handoff_storm_with_rebalancer_bit_identical(planned):
    """A handoff storm over 4 devices and 2 APs under SLO admission, with
    the fleet LP rebalancer re-solving placement at each handoff."""
    def specs(ns):
        prof = ns.traffic.TrafficProfile(
            rate_rps=1.2, arrival="poisson", n_devices=4, max_context=4096,
            slo_mix=(("interactive", 3.5, 0.7), ("batch", None, 0.3)),
            flash_crowds=((0.5, 3.0, 4.0),))
        return ns.traffic.generate_trace(prof, 12, seed=11)

    def cluster(ns):
        sc = ns.scenarios
        storm = sc.ScenarioTrace(handoffs=sc.handoff_storm(
            4, 2, t_start_s=0.6, spacing_s=0.25))
        return _cluster(ns, n_devices=4, n_aps=2,
                        run_queue=ns.costs.RunQueueModel(2, "wfq"),
                        slo=ns.slo.SLOPolicy(), scenario=storm,
                        rebalancer=sc.FleetRebalancer())
    jrep, _ = _both(specs, cluster)
    assert jrep.scenario["n_handoffs"] >= 1
    assert jrep.scenario["n_rebalances"] >= 1


def test_telemetry_policy_bit_identical(planned):
    """Policies picked at admission from the live servers."""
    _both(_poisson(n=8, rate=3.0, seed=8),
          lambda ns: _cluster(ns, n_devices=2,
                              run_queue=ns.costs.RunQueueModel(1, "fifo"),
                              policy_fn=ns.cluster.telemetry_policy))


def test_predictor_refresh_bit_identical(planned):
    """The online contention refresh armed: the port's CPU predictor and
    the reference's receive the same observations and fit the same
    models. Only the numpy refresh runs here (the MLP is never called
    through ``predictor=``), so the tolerance is 0."""
    preds = {}

    def cluster(ns):
        cfg = ns.configs.get_config(NAME)
        prof = ns.costs.PROFILES[PROFILE]
        p = (ns.predictor.LatencyPredictor(cfg, prof, device="cpu")
             if ns is TORCH else ns.predictor.LatencyPredictor(cfg, prof))
        preds[ns is TORCH] = p
        return _cluster(ns, n_devices=2,
                        run_queue=ns.costs.RunQueueModel(1, "fifo"),
                        slo=ns.slo.SLOPolicy(), predictor=p, refresh_every=3)

    def specs(ns):
        prof = ns.traffic.TrafficProfile(
            rate_rps=1.5, arrival="poisson", n_devices=2, max_context=2048,
            slo_mix=(("interactive", 4.0, 0.7), ("batch", None, 0.3)))
        return ns.traffic.generate_trace(prof, 12, seed=5)
    _both(specs, cluster)
    jp, tp = preds[False], preds[True]
    assert tp.refreshed and jp.refreshed
    assert tp._wait_obs == jp._wait_obs and tp._share_obs == jp._share_obs
    assert tp.refresh() == jp.refresh()
    for load, cap, backlog in [(0, 1, 0.0), (3, 2, 1.5), (9, 1, 7.0)]:
        assert tp.predict_wait_s(load, cap, backlog) \
            == jp.predict_wait_s(load, cap, backlog)
    for n in (1, 2, 5):
        assert tp.predict_share(n) == jp.predict_share(n)
        assert tp.effective_capacity(3e6, n) == jp.effective_capacity(3e6, n)


@pytest.mark.parametrize("name", [
    "queue_utilization", "backlog_delay_s", "LatencyPredictor.observe",
    "LatencyPredictor.refresh", "LatencyPredictor.refreshed",
    "LatencyPredictor.predict_wait_s", "LatencyPredictor.predict_share",
    "LatencyPredictor.effective_capacity",
    "LatencyPredictor.t_comp_batch"])
def test_predictor_fleet_interface_matches_reference(name):
    """What the fleet copies call on the port's predictor module has the
    reference's signature (the port's constructor alone adds ``device``)."""
    def get(mod):
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj.fget if isinstance(obj, property) else obj
    assert inspect.signature(get(tpredictor)) \
        == inspect.signature(get(jpredictor))


# ---------------------------------------------------------------------------
# SparKVServer.serve_fleet (port code)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    """The reference's smoke server and the port's, on converted weights;
    the port's registered context is the reference's, as in
    tests/test_torch_serving.py."""
    jcfg = jconfigs.get_smoke(NAME, **ARCH)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    tm = build_model(tconfigs.get_smoke(NAME, **ARCH))
    jsrv = JServer(jm, jparams, jconfigs.SparKVConfig(**SERVER_SP),
                   chunk_tokens=32)
    tsrv = SparKVServer(tm, tparams, tconfigs.SparKVConfig(**SERVER_SP),
                        chunk_tokens=32, device="cpu")
    rng = np.random.default_rng(0)
    cids = []
    for n in (64,):
        cid = jsrv.register_context(rng.integers(0, jcfg.vocab_size,
                                                 size=(1, n)))
        tsrv.contexts[cid] = _port_context(jsrv.contexts[cid])
        cids.append(cid)
    tsrv._next_id = jsrv._next_id
    return jsrv, tsrv, cids


def test_serve_fleet_signature_matches_reference():
    assert inspect.signature(SparKVServer.serve_fleet) \
        == inspect.signature(JServer.serve_fleet)


def _jobs(cids, n=12):
    rng = np.random.default_rng(3)
    arrivals = np.cumsum(rng.exponential(0.2, n))
    pols = ["sparkv", "strong_hybrid", "cachegen", "local_prefill"]
    return [(cids[i % len(cids)], float(a), pols[i % 4])
            for i, a in enumerate(arrivals)]


@pytest.mark.parametrize("knobs", ["closed_loop", "wfq_slo_decode"])
def test_serve_fleet_bit_identical(planned, servers, knobs):
    """The same jobs on the reference's and the port's servers: the same
    fleet report. The second case arms the run queue, SLO admission with
    a deadline, and decode with a per-token SLO."""
    jsrv, tsrv, cids = servers
    jobs = _jobs(cids)
    if knobs == "closed_loop":
        kw = lambda ns: {}  # noqa: E731
    else:
        kw = lambda ns: dict(  # noqa: E731
            run_queue=ns.costs.RunQueueModel(2, "wfq"),
            slo=ns.slo.SLOPolicy(), deadline_s=1.0, max_new_tokens=4,
            tpot_slo_s=0.05, decode=ns.decode.DecodeConfig(max_batch=4))
    jrep = jsrv.serve_fleet(jobs, **kw(JAX))
    trep = tsrv.serve_fleet(jobs, **kw(TORCH))
    _assert_same_report(jrep, trep)
    assert len(trep.records) + len(trep.shed) == len(jobs)
    assert {r.policy for r in trep.records} >= {"sparkv", "local_prefill"}


def test_serve_fleet_on_cpu_never_asks_for_the_card(servers, monkeypatch):
    """An empty planner cache and a default device that raises where no
    caller named one: a CPU server's fleet still runs, since it trains its
    planner with its own device named before the cluster plans."""
    _, tsrv, cids = servers

    def no_card(device=None, _real=tdevice.resolve):
        if device is None and tdevice._NAMED.get() is None:
            raise AssertionError("the fleet asked for the default device")
        return _real(device)
    for mod in (tdevice, tpredictor, tengine):
        monkeypatch.setattr(mod, "resolve", no_card)
    key = (tsrv.model.cfg.name, tsrv.profile)
    monkeypatch.delitem(TB._PRED_CACHE, key, raising=False)
    rep = tsrv.serve_fleet(_jobs(cids, 6),
                           run_queue=tcosts.RunQueueModel(2, "wfq"))
    assert len(rep.records) == 6
    assert TB._PRED_CACHE[key].device == torch.device("cpu")
    with pytest.raises(AssertionError, match="default device"):
        TB._predictor_cache(tsrv.model.cfg, "jetson-agx")
