"""Workload synthesis and dataset profiles (paper Table III mixes)."""
