"""Serving layer: ``engine.SparKVServer``, the single-request loop.

The fleet stack of ``repro.serving`` (cluster, SLO, traffic) is not
ported yet; see ROADMAP.md, queue 1, item 8.
"""
