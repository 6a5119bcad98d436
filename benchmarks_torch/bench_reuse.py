"""Cross-request KV reuse: content-addressed prefix sharing vs. a
no-reuse fleet on a three-hop cloud-egress topology.

Through PR 7 every request streamed its full context from the cloud
origin, even when the fleet had just encoded the same system prompt a
second earlier. This bench arms the content-addressed reuse layer — the
finite :class:`repro.serving.kvstore.CloudKVStore` (cloud hits bypass
the shared egress stage) plus per-device prefix caches (local hits skip
the link entirely) — and measures what sharing is worth:

  - **overlap sweep** — the same Zipf-popular prefix pool at rising
    ``prefix_frac`` (0 → 0.75 of each request's blocks shared): goodput
    and cloud-egress bytes for the store-armed fleet vs. the identical
    trace with the store disabled, with the store's measured hit rate
    as the x-axis;
  - **0%-overlap parity** — at ``prefix_frac=0.0`` (content ids present,
    never two alike) the armed fleet's per-request fingerprints must be
    bit-identical to the disabled fleet: the reuse layer prices misses
    at exactly zero;
  - **multi-turn sessions** — ``session_trace`` chats that re-send their
    whole history each turn: the device prefix cache turns each turn's
    shared head into near-free local hits.

Acceptance: at the top overlap level the store-armed fleet beats the
no-reuse fleet on goodput (tok/s) *and* moves fewer cloud-egress bytes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core.costs import KVStoreModel, RunQueueModel
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.decode import DecodeConfig
from repro_torch.serving.traffic import TrafficProfile, generate_trace, \
    session_trace

from benchmarks_torch.common import save, table

# shared-prefix popularity: a handful of system prompts / RAG documents
# with Zipf-skewed draw frequency
POOL = 6
ZIPF_A = 1.2
OVERLAPS = (0.0, 0.25, 0.5, 0.75)
OVERLAPS_QUICK = (0.0, 0.75)

# decode so goodput (tok/s) is a meaningful axis, not just TTFT
OUT_LEN_MIX = ((64, 0.6), (192, 0.4))

STORE = KVStoreModel(capacity_bytes=float(4 << 30),
                     device_capacity_bytes=float(8 << 30))


def _cluster(cfg, spcfg, kv):
    # three-hop tree: per-device NICs -> per-AP uplinks -> one shared
    # cloud-egress stage. Cloud store hits replicate to the edge, so
    # they bypass the egress stage — the hop that binds under load.
    return ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                          n_devices=4, nic="device-nic", n_aps=2,
                          egress="cloud-egress",
                          max_concurrency=8,
                          run_queue=RunQueueModel(2, "fifo"),
                          decode=DecodeConfig(max_batch=4),
                          kvstore=kv)


def _egress_bytes(rep) -> float:
    if rep.reuse is not None:
        return rep.reuse["egress_bytes_total"]
    return sum(r.bytes_streamed for r in rep.records)


def _fingerprint(rep):
    return [(r.spec.arrival_s, r.ttft_s, r.ttlt_s, r.energy_j,
             r.bytes_streamed, r.policy)
            for r in rep.records]


def _row(label, overlap, rep) -> dict:
    s = rep.summary()
    reuse = rep.reuse or {}
    store = reuse.get("store", {})
    return {
        "config": label,
        "prefix_frac": overlap,
        "goodput_tok_s": s["goodput_tok_s"],
        "ttft_p50_s": s["ttft_p50_s"],
        "ttft_p99_s": s["ttft_p99_s"],
        "egress_gb": _egress_bytes(rep) / 1e9,
        "store_hit_rate": store.get("hit_rate"),
        "store_evictions": store.get("n_evictions"),
        "local_hits": reuse.get("local_hits_total"),
        "store_hits": reuse.get("store_hits_total"),
        "makespan_s": rep.makespan_s,
    }


def run(quick: bool = False):
    cfg = get_config("sparkv-qwen3-4b")
    spcfg = SparKVConfig(scheduler_mode="engine")
    n_req = 10 if quick else 16
    overlaps = OVERLAPS_QUICK if quick else OVERLAPS
    base_prof = TrafficProfile(rate_rps=4.0, arrival="poisson",
                               n_devices=4, max_context=8192,
                               out_len_mix=OUT_LEN_MIX,
                               prefix_pool=POOL, prefix_zipf_a=ZIPF_A)

    rows = []
    parity = None
    print(f"\n[reuse] {n_req} Poisson requests, pool={POOL}, "
          f"zipf_a={ZIPF_A}, overlap sweep {overlaps}")
    for frac in overlaps:
        prof = dataclasses.replace(base_prof, prefix_frac=frac)
        specs = generate_trace(prof, n_req, seed=17)
        off = _cluster(cfg, spcfg, None).run(specs)
        on = _cluster(cfg, spcfg, STORE).run(specs)
        rows.append(_row("no-reuse", frac, off))
        rows.append(_row("store", frac, on))
        if frac == 0.0:
            # content ids present but never two alike: the armed fleet
            # must price every miss at exactly zero
            parity = _fingerprint(off) == _fingerprint(on)
            assert parity, "0%-overlap armed fleet diverged from no-reuse"
        hr = on.reuse["store"]["hit_rate"]
        print(f"overlap {frac:.2f}: hit rate {hr:.2f}, goodput "
              f"{rows[-1]['goodput_tok_s']:.2f} vs "
              f"{rows[-2]['goodput_tok_s']:.2f} tok/s, egress "
              f"{rows[-1]['egress_gb']:.2f} vs "
              f"{rows[-2]['egress_gb']:.2f} GB")

    top = max(overlaps)
    on_top = next(r for r in rows
                  if r["config"] == "store" and r["prefix_frac"] == top)
    off_top = next(r for r in rows
                   if r["config"] == "no-reuse" and r["prefix_frac"] == top)
    acceptance = {
        "overlap": top,
        "store_goodput_tok_s": on_top["goodput_tok_s"],
        "no_reuse_goodput_tok_s": off_top["goodput_tok_s"],
        "store_egress_gb": on_top["egress_gb"],
        "no_reuse_egress_gb": off_top["egress_gb"],
        "store_hit_rate": on_top["store_hit_rate"],
        "zero_overlap_parity": parity,
        "store_wins": (on_top["goodput_tok_s"] > off_top["goodput_tok_s"]
                       and on_top["egress_gb"] < off_top["egress_gb"]),
    }
    print(f"acceptance @ overlap {top}: store "
          f"{on_top['goodput_tok_s']:.2f} tok/s / "
          f"{on_top['egress_gb']:.2f} GB egress vs no-reuse "
          f"{off_top['goodput_tok_s']:.2f} / {off_top['egress_gb']:.2f}"
          + ("  [acceptance met]" if acceptance["store_wins"] else ""))

    # multi-turn sessions: intra-session history reuse via the device
    # prefix cache (turn j's shared head = turn j-1's whole chain)
    n_sess = 3 if quick else 8
    sess_prof = dataclasses.replace(
        base_prof, rate_rps=0.25, prefix_frac=0.5,
        session_turns_mix=((2, 0.5), (4, 0.5)), think_time_s=6.0,
        turn_growth_chunks=1)
    sess = session_trace(sess_prof, n_sess, seed=23)
    s_off = _cluster(cfg, spcfg, None).run(sess)
    s_on = _cluster(cfg, spcfg, STORE).run(sess)
    sess_rows = [_row("sessions-no-reuse", None, s_off),
                 _row("sessions-store", None, s_on)]
    rows += sess_rows
    print(f"sessions ({n_sess} chats, {len(sess)} turns): store "
          f"{sess_rows[1]['goodput_tok_s']:.2f} tok/s, "
          f"{sess_rows[1]['local_hits']} local hits vs no-reuse "
          f"{sess_rows[0]['goodput_tok_s']:.2f} tok/s")

    print(table(rows, list(rows[0].keys()),
                title="\n[reuse] goodput / egress vs. prefix overlap"))
    save("reuse",
         {"rows": rows, "acceptance": acceptance,
          "pool": POOL, "zipf_a": ZIPF_A, "overlaps": list(overlaps),
          "store_capacity_gb": STORE.capacity_bytes / 2 ** 30,
          "n_requests": n_req, "n_sessions": n_sess},
         quick=quick)
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    a = ap.parse_args()
    run(quick=a.quick)
