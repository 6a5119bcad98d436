"""The port's latency predictor (torch MLP) against the JAX package's."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.costs import PROFILES as JPROFILES  # noqa: E402
from repro.core.predictor import LatencyPredictor as JPredictor  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import convert_predictor  # noqa: E402
from repro_torch.core import predictor as TP  # noqa: E402
from repro_torch.core.costs import PROFILES  # noqa: E402


@pytest.fixture(scope="module")
def jax_predictor():
    p = JPredictor(jget_config("sparkv-qwen3-4b"), JPROFILES["jetson-orin"])
    p.fit(600, epochs=5)
    return p


def _port_with_weights_of(jp):
    tp = TP.LatencyPredictor(get_config("sparkv-qwen3-4b"),
                             PROFILES["jetson-orin"], device="cpu")
    tp.params, tp.scaler = convert_predictor(
        jax.tree.map(np.asarray, jp.params), jp.scaler, device="cpu")
    return tp


def test_predict_ms_matches_jax(jax_predictor):
    """Same weights and scaler: fp32 MLP outputs agree to fp32 rounding
    of sums taken in different orders (rtol 1e-5)."""
    tp = _port_with_weights_of(jax_predictor)
    rng = np.random.default_rng(2)
    x = np.stack([rng.integers(0, 40, 500), rng.uniform(1, 4000, 500),
                  rng.uniform(0, 0.85, 500)], axis=1).astype(np.float32)
    np.testing.assert_allclose(tp.predict_ms(x), jax_predictor.predict_ms(x),
                               rtol=1e-5, atol=1e-5)
    t_idx, act = x[:, 0], x[:, 1]
    layers = rng.integers(0, 36, 500)
    np.testing.assert_allclose(
        tp.t_comp_batch(t_idx, layers, act, 0.3),
        jax_predictor.t_comp_batch(t_idx, layers, act, 0.3), rtol=1e-5)
    assert tp.t_comp(3, 35, 100.0, 0.1) == jax_predictor.t_comp(3, 35, 100.0,
                                                                0.1)


def test_torch_fit_beats_roofline():
    """A torch-trained MLP (own init, so own weights) meets the thresholds
    of tests/test_system.py: > 2.5x lower error than the roofline
    estimator, MAPE < 0.35."""
    tp = TP.LatencyPredictor(get_config("sparkv-qwen3-4b"),
                             PROFILES["jetson-orin"], device="cpu")
    rep = tp.fit(3000, epochs=120)
    assert rep["test"]["improvement"] > 2.5
    assert rep["test"]["mlp_mape"] < 0.35


def test_contention_refresh_matches_jax():
    """The numpy refresh models are the reference's code: same fits on
    the same observations."""
    cfg, prof = get_config("sparkv-qwen3-4b"), PROFILES["jetson-orin"]
    tp = TP.LatencyPredictor(cfg, prof, device="cpu")
    jp = JPredictor(jget_config("sparkv-qwen3-4b"), JPROFILES["jetson-orin"])
    rng = np.random.default_rng(4)
    for _ in range(20):
        kw = dict(load=int(rng.integers(0, 16)), capacity=8,
                  backlog_s=float(rng.uniform(0, 2)),
                  wait_s=float(rng.uniform(0, 1)),
                  n_flows=int(rng.integers(1, 6)),
                  share=float(rng.uniform(0.1, 1)))
        tp.observe(**kw)
        jp.observe(**kw)
    assert tp.refresh() == jp.refresh()
    assert tp.predict_wait_s(5, 8, 0.7) == jp.predict_wait_s(5, 8, 0.7)
    assert tp.effective_capacity(1e6, 3) == jp.effective_capacity(1e6, 3)
    assert TP.queue_utilization(7, 4) == 0.95
    assert TP.backlog_delay_s(2.0, 4) == 0.5
