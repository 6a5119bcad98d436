"""Computation-latency predictor (paper §IV-C), PyTorch port of
``repro/core/predictor.py``.

A 2-hidden-layer MLP (48, 24 neurons) maps x = <t, s, U> (token-block
index, active attention blocks at 98% mass, device utilization) to the
sparse-attention latency of a non-final-layer chunk. Final layers are a
profiled constant (t_proj); dense ops are a near-constant offset t_dense.
Trained with SGD + MSE on profiled samples, 80/20 split. The MLP lives
on the predictor's device; ``t_comp_batch`` plans a whole grid in one
call, one device round trip.

The online contention refresh (``observe``/``refresh`` and the learned
wait and share models) is numpy, the reference's code unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.costs import DeviceProfile, GroundTruthLatency
from repro_torch.device import resolve


def queue_utilization(load: int, capacity: int, *,
                      cap: float = 0.95) -> float:
    """Map device run-queue occupancy (in-service + waiting jobs) to the
    predictor's U feature, clipped below 1 so planning costs stay
    finite."""
    return min(load / max(capacity, 1), cap)


def backlog_delay_s(backlog_s: float, capacity: int) -> float:
    """Expected extra wait a newly-submitted chunk sees from the device
    server's current service backlog: the backlog drains ``capacity``
    jobs at a time."""
    return backlog_s / max(capacity, 1)


def _init_mlp(generator: torch.Generator, device, sizes=(3, 48, 24, 1)):
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=generator, dtype=torch.float32,
                        device=device) * float(np.sqrt(2.0 / a))
        params.append({"w": w, "b": torch.zeros((b,), dtype=torch.float32,
                                                device=device)})
    return params


def _mlp_apply(params, x):
    h = x
    for i, lyr in enumerate(params):
        h = h @ lyr["w"] + lyr["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h[..., 0]


@dataclasses.dataclass
class FeatureScaler:
    mean: np.ndarray
    std: np.ndarray
    y_scale: float

    def fx(self, x):
        return (x - self.mean) / self.std


def _sgd_epoch(params, xb, yb, lr: float):
    """One SGD step on MSE; returns (new params, loss)."""
    leaves = [t.detach().requires_grad_(True)
              for lyr in params for t in (lyr["w"], lyr["b"])]
    live = [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
            for i in range(len(params))]
    loss = torch.mean((_mlp_apply(live, xb) - yb) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = [t - lr * g for t, g in zip(leaves, grads)]
    return ([{"w": new[2 * i], "b": new[2 * i + 1]}
             for i in range(len(params))], loss.detach())


class LatencyPredictor:
    """MLP predictor with profiled constants for t_dense / t_proj."""

    def __init__(self, cfg, profile: DeviceProfile, *, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.profile = profile
        self.device = resolve(device)
        self.gt = GroundTruthLatency(profile, cfg.resolved_head_dim
                                     if cfg.num_heads else 64)
        self.t_dense = self.gt.dense_seconds(cfg)
        self.t_proj = profile.t_proj_s
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = _init_mlp(gen, self.device)
        self.scaler: FeatureScaler | None = None
        # online contention-refresh state (serving telemetry)
        self.obs_window = 1024               # newest observations kept
        self._wait_obs: list[tuple] = []     # (load, cap, backlog_s, wait_s)
        self._share_obs: list[tuple] = []    # (n_flows, bottleneck share)
        self._wait_coef: np.ndarray | None = None
        self._eta_hat: float | None = None

    # ---- training data from profiling runs ----
    def profile_samples(self, n: int, rng: np.random.Generator,
                        max_t: int = 40, max_blocks: float = 4000.0):
        from repro_torch.data.workloads import sample_profiling_features
        t, s = sample_profiling_features(rng, n, max_t=max_t)
        s = np.minimum(s, max_blocks)
        u = rng.uniform(0.0, 0.85, n)
        y = np.array([self.gt.attn_seconds(si, ui, rng)
                      for si, ui in zip(s, u)])
        x = np.stack([t, s, u], axis=1)
        return x.astype(np.float32), (y * 1e3).astype(np.float32)  # ms

    def fit(self, n_samples: int = 6000, *, epochs: int = 400,
            lr: float = 3e-3, batch: int = 256, seed: int = 0) -> dict:
        rng = np.random.default_rng(seed)
        x, y = self.profile_samples(n_samples, rng)
        n_tr = int(0.8 * n_samples)
        idx = rng.permutation(n_samples)
        tr, te = idx[:n_tr], idx[n_tr:]
        self.scaler = FeatureScaler(x[tr].mean(0), x[tr].std(0) + 1e-6,
                                    1.0)
        xtr = torch.from_numpy(self.scaler.fx(x[tr])).to(self.device)
        ytr = torch.from_numpy(y[tr]).to(self.device)
        params = self.params
        steps = max(1, n_tr // batch)
        for ep in range(epochs):
            perm = torch.from_numpy(rng.permutation(n_tr)).to(self.device)
            cur_lr = lr * (0.5 ** (ep // 150))
            for s_i in range(steps):
                sl = perm[s_i * batch:(s_i + 1) * batch]
                params, _ = _sgd_epoch(params, xtr[sl], ytr[sl], cur_lr)
        self.params = params
        report = {
            "train": self.evaluate(x[tr], y[tr]),
            "test": self.evaluate(x[te], y[te]),
            "n_samples": n_samples,
        }
        return report

    def evaluate(self, x, y) -> dict:
        pred = self.predict_ms(x)
        roof = np.array([self.gt.roofline_estimate(s) * 1e3
                         for s in x[:, 1]])
        err = np.abs(pred - y)
        rerr = np.abs(roof - y)
        return {
            "mlp_mae_ms": float(err.mean()),
            "mlp_mape": float((err / np.maximum(y, 1e-6)).mean()),
            "roofline_mae_ms": float(rerr.mean()),
            "roofline_mape": float((rerr / np.maximum(y, 1e-6)).mean()),
            "improvement": float(rerr.mean() / max(err.mean(), 1e-12)),
        }

    def predict_ms(self, x: np.ndarray) -> np.ndarray:
        assert self.scaler is not None, "fit() first"
        xs = self.scaler.fx(np.asarray(x, np.float32)).astype(np.float32)
        with torch.no_grad():
            out = _mlp_apply(self.params,
                             torch.from_numpy(xs).to(self.device))
        return out.cpu().numpy()

    # ---- scheduler-facing API ----
    def t_comp(self, t_idx: int, layer: int, active_blocks: float,
               util: float) -> float:
        """Seconds for chunk (t, l); final layer is projection-only."""
        if layer == self.cfg.num_layers - 1:
            return self.t_proj
        x = np.array([[t_idx, active_blocks, util]], np.float32)
        return float(self.predict_ms(x)[0]) * 1e-3 + self.t_dense

    def t_comp_batch(self, t_idx: np.ndarray, layers: np.ndarray,
                     active_blocks: np.ndarray,
                     util: float) -> np.ndarray:
        x = np.stack([t_idx, active_blocks,
                      np.full_like(active_blocks, util, dtype=float)],
                     axis=1).astype(np.float32)
        ms = self.predict_ms(x)
        out = ms * 1e-3 + self.t_dense
        out = np.where(layers == self.cfg.num_layers - 1, self.t_proj, out)
        return np.maximum(out, 1e-6)

    # ---- online contention refresh (serving telemetry) ----
    def observe(self, *, load: int, capacity: int, backlog_s: float,
                wait_s: float, n_flows: int | None = None,
                share: float | None = None) -> None:
        """Record one served request's contention outcome: the device
        occupancy / service backlog it was admitted against and the
        queue wait it actually experienced, plus — when it streamed —
        the flow count at admission and the observed bottleneck link
        share. Observations buffer until :meth:`refresh`; only the
        newest ``obs_window`` are kept."""
        self._wait_obs.append((float(load), float(max(capacity, 1)),
                               float(backlog_s), float(max(wait_s, 0.0))))
        del self._wait_obs[:-self.obs_window]
        if n_flows is not None and share is not None:
            self._share_obs.append((float(max(n_flows, 1)),
                                    float(np.clip(share, 0.0, 1.0))))
            del self._share_obs[:-self.obs_window]

    @property
    def refreshed(self) -> bool:
        """True once refresh() has fit at least one contention model."""
        return self._wait_coef is not None or self._eta_hat is not None

    def refresh(self, *, min_samples: int = 8,
                ridge: float = 1e-3) -> dict | None:
        """Retrain the contention models on the buffered observations:
        a ridge least-squares wait model on (occupancy/capacity,
        backlog/capacity), and the aggregate link efficiency ``eta_hat``
        solving share ~= eta/n. Either stays None below ``min_samples``;
        returns a fit report or None when nothing was trainable."""
        report: dict = {}
        if len(self._wait_obs) >= min_samples:
            obs = np.asarray(self._wait_obs)
            x = self._wait_features(obs[:, 0], obs[:, 1], obs[:, 2])
            y = obs[:, 3]
            gram = x.T @ x + ridge * np.eye(x.shape[1])
            self._wait_coef = np.linalg.solve(gram, x.T @ y)
            pred = np.maximum(x @ self._wait_coef, 0.0)
            report.update(n_wait_obs=len(self._wait_obs),
                          wait_mae_s=float(np.abs(pred - y).mean()))
        if len(self._share_obs) >= min_samples:
            obs = np.asarray(self._share_obs)
            self._eta_hat = float(np.clip((obs[:, 0] * obs[:, 1]).mean(),
                                          0.05, 1.0))
            report.update(n_share_obs=len(self._share_obs),
                          eta_hat=self._eta_hat)
        return report or None

    @staticmethod
    def _wait_features(load, capacity, backlog_s) -> np.ndarray:
        load = np.atleast_1d(np.asarray(load, float))
        cap = np.maximum(np.atleast_1d(np.asarray(capacity, float)), 1.0)
        backlog = np.atleast_1d(np.asarray(backlog_s, float))
        return np.stack([load / cap, backlog / cap,
                         np.ones_like(load)], axis=1)

    def predict_wait_s(self, load: int, capacity: int,
                       backlog_s: float) -> float | None:
        """Learned device queue wait; None before the first refresh."""
        if self._wait_coef is None:
            return None
        x = self._wait_features(load, capacity, backlog_s)
        return max(float((x @ self._wait_coef)[0]), 0.0)

    def predict_share(self, n_flows: int) -> float | None:
        """Learned per-flow bottleneck link share with `n_flows` active;
        None before a successful share refresh."""
        if self._eta_hat is None:
            return None
        return min(self._eta_hat / max(n_flows, 1), 1.0)

    def effective_capacity(self, mean_bw: float, n_flows: int = 1) -> float:
        """Aggregate deliverable bandwidth of a fair-shared link carrying
        ``n_flows``: profiled mean scaled by the learned contention
        efficiency (the profiled mean itself when unrefreshed)."""
        share = self.predict_share(max(n_flows, 1))
        if share is None:
            return float(mean_bw)
        return float(mean_bw * share * max(n_flows, 1))
