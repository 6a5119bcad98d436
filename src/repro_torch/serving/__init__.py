"""Serving layer: single-request server, multi-request cluster, traffic.

- ``engine``    — SparKVServer: concrete context registration + per-request
  loading/decoding (real compression round-trip, real logit checks) on
  the server's device, and ``serve_fleet`` into the cluster.
- ``resources`` — generic discrete-event resource servers: fluid link
  stages/topologies (per-device NIC -> shared uplink) and the explicit
  FIFO/WFQ/SRPT device run queue.
- ``simcore``   — the typed event queue the cluster runs on, and the
  process-wide simulation throughput counters.
- ``cluster``   — ServingCluster: N concurrent loads on one clock, driving
  the resource servers (link topology + per-device run queues or the
  legacy closed-loop utilization coupling).
- ``decode``    — continuous batched decoding: per-device DecodeBatcher
  whose batched token dispatches share the device run queue with
  in-flight prefill chunks (full-response goodput, TPOT/TTLT metrics).
- ``memory``    — per-device KV memory server: residency, eviction under
  pressure, and the reload planner.
- ``kvstore``   — cross-request KV reuse: the cloud KV store and the
  per-device prefix cache.
- ``scenarios`` — hostile wireless worlds (handoffs, outages, churn) and
  the fleet LP rebalancer.
- ``traffic``   — arrival processes, request mixes, device routing, WFQ
  weight classes and SLO deadline classes for fleet runs.
- ``slo``       — SLO-aware admission: TTFT prediction against the live
  servers, quality shedding down the quantization bitrate ladder,
  deadline-derived WFQ weights.

Every module but ``engine`` is a copy of its ``repro.serving``
counterpart; their only device work is the planner MLP, reached through
``core.baselines``.
"""
