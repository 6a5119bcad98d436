"""One run of one cell: set-up, the measured window, the metrics.

Everything a run does is found by name from ``BENCHMARK.json``: the cell's
traffic mix (``cardbench/traffic/<traffic>.json``), its configuration file
(the ``file`` of its ``configs`` entry), the limits of its correctness
check (``cardbench/limits/<cell>.json``), and one reader a metric
(``cardbench/metrics/<metric>.py``, whose ``read(ctx)`` returns a number,
or None where it finds nothing to read). The configuration file names the
module that builds the program's configuration of it
(``cardbench/programs/<program>.py``) and the plain reference that judges
it (``cardbench/reference/<reference>.py``).

A request is one ``SparKVServer.generate(cid, prompt, max_new=N,
policy=P, compare_exact=False, seed=s)``, issued by one client in a closed
loop. The harness observes the server on the instance, changing nothing it
computes: ``model.decode_step`` (the tokens fed, the logits, the cache's
tail it wrote, and a CUDA event after the call that yields the first
output token), ``assemble``
(the cache a request assembled), and ``record_function`` ranges around
``load_context``, ``assemble`` and ``_decode`` for the traced run.

What it reads of the program, whatever the model, are its KV layers (the
reference's ``kv_layers``) in one order: the rows of a registered
context's ``StoredContext.exact_k`` and ``exact_v`` (L, 1, S, hkv, hd),
the rows of the decode cache's ``tail_k`` and ``tail_v`` after a step,
the rows of the (k, v) ``assemble`` returns, and the layer ``l`` of a
streamed chunk (t, l), which ``ServeResult.n_streamed`` counts.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch

from cardbench import devtrace as T
from cardbench import weights
from cardbench.generator import Traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the traced part of a --trace 1 window: at least this many requests and
# this many seconds (the profiler's record of a whole window is too large
# to reduce within a run's time)
TRACE_REQUESTS = 2
TRACE_SECONDS = 3.0


# ---------------------------------------------------------------- spec
def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    config: dict
    limits: dict
    end_to_end: list
    per_layer: list


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of ``BENCHMARK.json`` with its files and the
    metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def mine(metrics):
        return [m for m in metrics
                if name in m.get("workloads", [name])]
    return Cell(name=name, chips=entry["chips"],
                workload=load_json(HERE / "traffic"
                                   / f"{entry['traffic']}.json"),
                config=load_json(root / conf["file"]),
                limits=load_json(HERE / "limits" / f"{name}.json")["limits"],
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))


def reader(metric: str):
    """The ``read`` function of ``cardbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _named(package: str, key: str, config: dict):
    """The module ``cardbench.<package>.<config[key]>``; the key is
    required."""
    if key not in config:
        raise KeyError(f"configuration {config.get('name')!r} has no "
                       f"{key!r} key")
    return importlib.import_module(f"cardbench.{package}.{config[key]}")


def reference_module(config: dict):
    """The plain reference the configuration names."""
    return _named("reference", "reference", config)


def port_config(config: dict):
    """The program's model configuration and SparKVConfig of a
    configuration, from the program module it names."""
    return _named("programs", "program", config).config(config)


# -------------------------------------------------------------- clocks
class Stamp:
    """A point in a request: a CUDA event recorded on the stream, or the
    host clock on the CPU. Read only after the device is synchronised."""

    def __init__(self, device: torch.device):
        if device.type == "cuda":
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record()
            self.t = None
        else:
            self.ev, self.t = None, time.perf_counter()

    def ms_to(self, later: "Stamp") -> float:
        if self.ev is not None:
            return self.ev.elapsed_time(later.ev)
        return (later.t - self.t) * 1e3


# ------------------------------------------------------------ requests
@dataclasses.dataclass
class Request:
    i: int
    context: int
    prompt: np.ndarray
    max_new: int
    traced: bool = False
    steps: int = 0
    issue: Stamp = None
    first: Stamp = None
    ret: Stamp = None
    fed: list = dataclasses.field(default_factory=list)
    logits: list = dataclasses.field(default_factory=list)
    assembled: tuple = None          # (k, v, streamed [(t, l)])
    tail: tuple = None               # the cache's tail K, V after a step
    tokens: np.ndarray = None
    n_streamed: int = 0
    phase: dict = None
    ttft_ms: float = None
    after_first_ms: float = None
    served_s: float = None           # host clock, issue to return

    @property
    def n_prompt(self) -> int:
        return len(self.prompt)


class Observer:
    """Wrappers set on the server instance; what they keep goes to the
    request in flight (``current``)."""

    def __init__(self, srv, device):
        self.current: Request | None = None
        model = srv.model
        step, assemble = model.decode_step, srv.assemble
        load, decode = srv.load_context, srv._decode
        rf = torch.profiler.record_function

        def decode_step(params, cache, token, pos):
            out = step(params, cache, token, pos)
            r = self.current
            if r is not None:
                r.fed.append(token)
                r.logits.append(out[0])
                r.tail = (out[1]["tail_k"], out[1]["tail_v"])
                if r.steps == r.n_prompt:
                    r.first = Stamp(device)
                r.steps += 1
            return out

        def assemble_and_keep(st, streamed):
            with rf(T.PREFIX + "assemble"):
                k, v = assemble(st, streamed)
            r = self.current
            if r is not None and streamed:
                r.assembled = (k, v, [(c.t, c.l) for c in streamed])
            return k, v

        def load_context(*a, **kw):
            with rf(T.PREFIX + "load_context"):
                return load(*a, **kw)

        def decode_loop(*a, **kw):
            with rf(T.PREFIX + "_decode"):
                return decode(*a, **kw)

        model.decode_step = decode_step
        srv.assemble = assemble_and_keep
        srv.load_context = load_context
        srv._decode = decode_loop


# ----------------------------------------------------------------- run
def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """Set-up, window and readings of one cell on one device."""

    def __init__(self, c: Cell, seed: int, device, t_start: float):
        self.c = c
        self.seed = int(seed)
        self.device = torch.device(device)
        self.t_start = t_start
        self.split: dict = {}
        self.requests: list[Request] = []
        self.trace = None

    def _lap(self, name, t0) -> float:
        sync(self.device)
        t = time.perf_counter()
        self.split[name] = t - t0
        return t

    def setup(self) -> None:
        from repro_torch.models import build_model
        from repro_torch.serving.engine import SparKVServer
        c, dev = self.c, self.device
        t = time.perf_counter()
        self.split["import_and_init"] = t - self.t_start
        self.model_cfg, spcfg = port_config(c.config)
        model = build_model(self.model_cfg)
        self.params = weights.make(model.abstract_params(),
                                   self.model_cfg.num_layers, self.seed, dev)
        t = self._lap("weights", t)
        self.srv = SparKVServer(model, self.params, spcfg,
                                profile=c.config["profile"],
                                network=c.workload["network"],
                                seed=self.seed, device=dev)
        self.obs = Observer(self.srv, dev)
        self.traffic = Traffic(c.workload, self.model_cfg.vocab_size,
                               self.seed)
        self.cids = [self.srv.register_context(x)
                     for x in self.traffic.contexts]
        t = self._lap("register_context", t)
        for k in ("prefill", "quantize", "mask", "huffman_encode"):
            self.split[f"register_context.{k}"] = self.srv.phase_s[k]
        plan0 = self.srv.phase_s["plan"]
        self._serve(-1, self.traffic.warm_up())
        t = self._lap("warm_up", t)
        self.split["warm_up.plan"] = self.srv.phase_s["plan"] - plan0
        self.setup_s = t - self.t_start
        self.requests.clear()

    def _serve(self, i: int, spec: dict, traced: bool = False,
               settle: bool = True) -> Request:
        srv = self.srv
        r = Request(i=i, context=spec["context"], prompt=spec["prompt"],
                    max_new=self.c.workload["max_new"], traced=traced)
        before = dict(srv.phase_s)
        self.obs.current = r
        t0 = time.perf_counter()
        r.issue = Stamp(self.device)
        with torch.profiler.record_function(T.PREFIX + "request"):
            res = srv.generate(self.cids[r.context], r.prompt,
                               max_new=r.max_new,
                               policy=self.c.workload["policy"],
                               compare_exact=False, seed=spec["plan_seed"])
        r.ret = Stamp(self.device)
        r.served_s = time.perf_counter() - t0
        self.obs.current = None
        if settle:
            self._settle(r)
        r.phase = {k: srv.phase_s[k] - before.get(k, 0.0)
                   for k in srv.phase_s}
        r.tokens, r.n_streamed = res.tokens, res.n_streamed
        if i >= 0:
            self.requests.append(r)
        return r

    @staticmethod
    def _settle(r: Request) -> None:
        """Host copies of what the check reads, made once the request has
        returned (the program has read its tokens back by then, so the
        device is idle): the fed tokens (T,), the logits (T, padded
        vocab), the tail's K and V (L, T, hkv, hd) and the assembled
        cache. The card keeps nothing of the harness's from one request
        to the next, so ``memory_peak_bytes`` is the program's peak and
        at most the one request's references held until it returns."""
        r.fed = torch.cat([t.reshape(-1) for t in r.fed]).cpu()
        r.logits = torch.cat([x.reshape(1, -1) for x in r.logits]).cpu()
        if r.tail is not None:
            r.tail = tuple(x[:, 0, :r.steps].cpu() for x in r.tail)
        if r.assembled is not None:
            k, v, streamed = r.assembled
            r.assembled = (k.cpu(), v.cpu(), streamed)

    def window(self, seconds: float, trace: bool) -> None:
        """Requests one after the other until `seconds` have passed; the
        window closes when the request in flight then returns. Python's
        cyclic collector is off for the window, with set-up's objects
        frozen out of it, so that no pass over the whole process lands in
        one request's time."""
        gc.collect()
        gc.freeze()
        gc.disable()
        try:
            self._window(seconds, trace)
        finally:
            gc.enable()
            gc.unfreeze()

    def _window(self, seconds: float, trace: bool) -> None:
        t0 = time.perf_counter()
        i = 0
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(T.WINDOW):
                    while i < TRACE_REQUESTS or (
                            time.perf_counter() - t0 < TRACE_SECONDS):
                        self._serve(i, self.traffic.request(i), traced=True,
                                    settle=False)
                        i += 1
                        if time.perf_counter() - t0 >= seconds:
                            break
                    sync(self.device)
            # the traced requests' copies are made outside the trace, so
            # that it holds the program's device work alone
            for r in self.requests:
                self._settle(r)
            self.trace = T.summarize(prof)
        while i == 0 or time.perf_counter() - t0 < seconds:
            self._serve(i, self.traffic.request(i))
            i += 1
        sync(self.device)
        self.window_s = time.perf_counter() - t0
        for r in self.requests:
            if r.first is None:
                raise RuntimeError(f"request {r.i} yielded no first token")
            r.ttft_ms = r.issue.ms_to(r.first)
            r.after_first_ms = r.first.ms_to(r.ret)
        self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.device.type == "cuda" else 0)

    def summary(self) -> dict:
        """Each request of the window, in order, for a look at how its
        times move within a run: prompt tokens, streamed chunks, TTFT and
        the time after the first token (ms), host seconds from issue to
        return, and the Huffman decode and plan spans (s)."""
        rs = self.requests
        return {"prompt": [r.n_prompt for r in rs],
                "streamed": [r.n_streamed for r in rs],
                "ttft_ms": [r.ttft_ms for r in rs],
                "after_first_ms": [r.after_first_ms for r in rs],
                "served_s": [r.served_s for r in rs],
                "huffman_decode_s": [r.phase.get("huffman_decode", 0.0)
                                     for r in rs],
                "plan_s": [r.phase.get("plan", 0.0) for r in rs]}

    def failed(self) -> int:
        return sum(1 for r in self.requests
                   if r.tokens is None or len(r.tokens) != r.max_new)

    # ------------------------------------------------------------ metrics
    def context(self) -> "Context":
        timed = [r for r in self.requests if not r.traced] or self.requests
        kind = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        peaks = load_json(HERE / "peaks.json")
        peak = next((v for k, v in peaks.items() if kind.startswith(k)),
                    None)
        return Context(requests=timed,
                       traced=[r for r in self.requests if r.traced],
                       window_s=self.window_s,
                       served_s=sum(r.served_s for r in timed),
                       setup_s=self.setup_s,
                       trace=self.trace, model=self.c.config["model"],
                       sparkv=self.c.config["sparkv"],
                       workload=self.c.workload, peak=peak,
                       step_flops=reference_module(self.c.config).step_flops)

    def metrics(self, trace: bool) -> dict:
        ctx = self.context()
        out = {}
        for m in (self.c.per_layer if trace else self.c.end_to_end):
            v = reader(m["name"])(ctx)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out


@dataclasses.dataclass
class Context:
    """What a metric's reader reads. ``requests``: the window's requests
    outside the traced part (all of them without a trace); ``traced``:
    those inside it; ``served_s``: the host seconds from issue to return
    summed over ``requests`` (the window less the harness's bookkeeping
    between requests); ``trace``: ``trace.summarize``'s dict or None;
    ``peak``: the device's row of ``peaks.json`` or None;
    ``step_flops(model, kv_len)``: the model operations of one decode
    step."""
    requests: list
    traced: list
    window_s: float
    served_s: float
    setup_s: float
    trace: dict
    model: dict
    sparkv: dict
    workload: dict
    peak: dict
    step_flops: object
