"""The port's examples (``examples_torch/``) against the reference's
(``examples/``) on the CPU, under one shared planner
(``tools/bench_parity.py::shared_planner``: both packages' planner caches
hand out the port's CPU predictor, so a last-ulp difference between XLA
and torch cannot flip a greedy choice).

- serve_fleet (a copy, run through ``examples_torch.run ... --device
  cpu``) prints the reference's lines, line for line; it prints no
  wall-clock field. serve_under_volatility, the slow one, is held the same
  way in tests/test_torch_examples_volatility.py.
- quickstart (a port) runs on the reference's weights, converted. The
  context's workload it measures (per chunk: active blocks, entropy,
  compressed bytes) is the reference's but for the few 5-bit codes that a
  bf16 ulp of the prefill moves: active blocks equal, entropies within
  0.01 bits and chunk bytes within 0.5% (fig4's tolerances in
  tools/bench_parity.py). The plans are held in two layers. On the
  workload it measured, each policy's streamed and computed chunk counts
  equal the reference's and its simulated TTFT and energy are within rel
  1e-3 (the bytes' 0.5% moves them by at most about that much). On the
  reference's workload (the port's server handed the reference's
  measurement), counts, TTFT and energy equal the reference's to rel
  1e-6. Fidelity (top-1 agreement over 8 decoded tokens) is within one
  token (1/8) of the reference's in both.
"""
import contextlib
import dataclasses
import io
import math
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import bench_parity  # noqa: E402

import examples_torch.run as RUN  # noqa: E402

EXACT = 1e-6         # counts, TTFT and energy (simulated), same workload
MEASURED = 1e-3      # TTFT and energy on the workload each measured
FIDELITY = 1 / 8     # one decoded token of 8


def stdout_of(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return buf.getvalue(), out


def test_serve_fleet_prints_the_reference_lines():
    with bench_parity.shared_planner():
        ref, _ = stdout_of(lambda: runpy.run_path(
            str(ROOT / "examples" / "serve_fleet.py"), run_name="__main__"))
        port, _ = stdout_of(lambda: RUN.main(["serve_fleet", "--device",
                                              "cpu"]))
    assert len(ref.splitlines()) > 10
    assert port.splitlines() == ref.splitlines()


@pytest.fixture(scope="module")
def quickstart():
    """The reference's quickstart, then the port's on its weights twice:
    as it is, and with its server handed the reference's workload."""
    import repro.serving.engine as jengine
    import repro_torch.core.baselines as tb
    import repro_torch.serving.engine as tengine
    from repro_torch.convert import convert_params
    from repro_torch.data.workloads import WorkloadChunks

    import examples_torch.quickstart as Q

    served, workloads = {}, {}

    def recording(mod, tag):
        generate, register = (mod.SparKVServer.generate,
                              mod.SparKVServer.register_context)

        def gen(self, cid, prompt, max_new=8, *, policy="sparkv", **kw):
            r = generate(self, cid, prompt, max_new, policy=policy, **kw)
            served.setdefault(tag, {})[policy] = r
            return r

        def reg(self, tokens):
            cid = register(self, tokens)
            workloads[tag] = self.contexts[cid].wl
            return cid
        return gen, reg

    def handed_reference(register):
        def reg(self, tokens):
            cid = register(self, tokens)
            ref = workloads["ref"]
            self.contexts[cid].wl = WorkloadChunks(**{
                f.name: getattr(ref, f.name)
                for f in dataclasses.fields(WorkloadChunks)})
            return cid
        return reg

    with pytest.MonkeyPatch.context() as mp, bench_parity.shared_planner():
        gen, reg = recording(jengine, "ref")
        mp.setattr(jengine.SparKVServer, "generate", gen)
        mp.setattr(jengine.SparKVServer, "register_context", reg)
        out = {}
        out["ref_stdout"], ref = stdout_of(lambda: runpy.run_path(
            str(ROOT / "examples" / "quickstart.py"), run_name="__main__"))
        # the port's server fits its planner only where the cache has
        # none: give it the shared one
        cfg = ref["cfg"]
        mp.setitem(tb._PRED_CACHE, (cfg.name, "jetson-orin"),
                   tb._predictor_cache(cfg, "jetson-orin"))
        params = convert_params(ref["params"], "cpu")
        register = tengine.SparKVServer.register_context
        _, reg = recording(tengine, "port")
        mp.setattr(tengine.SparKVServer, "register_context", reg)
        out["port_stdout"], out["port"] = stdout_of(
            lambda: Q.main(["--device", "cpu"], params=params))
        mp.setattr(tengine.SparKVServer, "register_context",
                   handed_reference(register))
        _, out["port_on_ref_wl"] = stdout_of(
            lambda: Q.main(["--device", "cpu"], params=params))
    out["ref"] = served["ref"]
    out["workloads"] = workloads
    out["policies"] = Q.POLICIES
    return out


def test_quickstart_measures_the_reference_workload(quickstart):
    a, b = quickstart["workloads"]["ref"], quickstart["workloads"]["port"]
    assert (a.n_t, a.n_l, a.n_h, a.context_len, a.chunk_tokens) == \
        (b.n_t, b.n_l, b.n_h, b.context_len, b.chunk_tokens)
    np.testing.assert_array_equal(b.active_blocks, a.active_blocks)
    np.testing.assert_allclose(b.entropy_bits, a.entropy_bits, atol=0.01)
    np.testing.assert_allclose(b.chunk_bytes, a.chunk_bytes, rtol=0.005)
    # the context line: tokens, chunks and compressed MB
    assert quickstart["port_stdout"].splitlines()[0] == \
        quickstart["ref_stdout"].splitlines()[0]


@pytest.mark.parametrize("run,rel", [("port", MEASURED),
                                     ("port_on_ref_wl", EXACT)])
def test_quickstart_plans_as_the_reference(quickstart, run, rel):
    ref, port = quickstart["ref"], quickstart[run]
    assert set(ref) == set(port) == set(quickstart["policies"])
    for policy in quickstart["policies"]:
        a, b = ref[policy], port[policy]
        assert (b.n_streamed, b.n_computed) == (a.n_streamed, a.n_computed), \
            policy
        assert math.isclose(b.ttft_s, a.ttft_s, rel_tol=rel), \
            (policy, b.ttft_s, a.ttft_s)
        assert math.isclose(b.energy_j, a.energy_j, rel_tol=rel), \
            (policy, b.energy_j, a.energy_j)
        assert abs(b.top1_agreement - a.top1_agreement) <= FIDELITY, policy
    assert port["local_prefill"].top1_agreement == 1.0
    assert port["sparkv"].n_streamed > 0
    assert port["cachegen"].n_computed == 0
