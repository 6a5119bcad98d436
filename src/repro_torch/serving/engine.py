"""SparKV serving engine (PyTorch port of ``repro/serving/engine.py``).

Context-reuse serving: a reusable context is registered once ("cloud"
side: exact KV + per-chunk quantized+Huffman bitstreams + chunk stats);
each request then *loads* that context through a policy pipeline
(sparkv / strong_hybrid / cachegen / local_prefill):

  - timing & energy come from the discrete-event engine (virtual clock,
    real compressed bytes, ground-truth compute latencies);
  - the KV cache content is assembled concretely on the server's device:
    streamed chunks are entropy-decoded on the host, then dequantized by
    one kv_dequant launch a request straight into the device cache;
    computed chunks take the exact values.

``phase_s`` accumulates the wall seconds of each phase (prefill,
quantize, huffman_encode, mask, plan, huffman_decode, dequant, decode);
each phase ends with a device synchronise so its time is its own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from repro_torch.compression import huffman
from repro_torch.compression.quantize import quantize
from repro_torch.configs.base import SparKVConfig
from repro_torch.core import baselines as B
from repro_torch.core.chunks import Chunk
from repro_torch.core.costs import NETWORKS, PROFILES
from repro_torch.core.predictor import LatencyPredictor
from repro_torch.data.workloads import WorkloadChunks
from repro_torch.device import resolve, sync
from repro_torch.kernels.kv_dequant.ops import dequantize_into
from repro_torch.models.api import Model


@dataclasses.dataclass
class StoredContext:
    tokens: np.ndarray                 # (1, S)
    exact_k: torch.Tensor              # (L, 1, S, hkv, hd) fp32, on device
    exact_v: torch.Tensor
    encoded: dict                      # Chunk(t,l,0) -> (enc_k, enc_v, qt_k, qt_v)
    wl: WorkloadChunks
    n_chunks: int


@dataclasses.dataclass
class ServeResult:
    ttft_s: float
    energy_j: float
    tokens: np.ndarray
    top1_agreement: float
    mean_kl: float
    n_streamed: int
    n_computed: int
    migrations: int
    wall_s: float


class SparKVServer:
    def __init__(self, model: Model, params, spcfg: SparKVConfig,
                 *, profile: str = "jetson-orin",
                 network: str = "campus-wifi", capacity: int = 8,
                 chunk_tokens: Optional[int] = None, seed: int = 0,
                 device=None):
        self.model = model
        self.params = params
        self.spcfg = spcfg
        self.profile = profile
        self.network = network
        self.capacity = capacity
        self.chunk_tokens = chunk_tokens or spcfg.chunk_tokens
        self.seed = seed
        self.device = resolve(device)
        self.contexts: dict[int, StoredContext] = {}
        self.active_requests = 0
        self._next_id = 0
        self.phase_s: dict[str, float] = defaultdict(float)

    def utilization(self) -> float:
        return min(self.active_requests / self.capacity, 1.0)

    @contextlib.contextmanager
    def _phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            self.phase_s[name] += time.perf_counter() - t0

    # ---------------- cloud side ----------------
    def register_context(self, tokens: np.ndarray) -> int:
        """Precompute exact KV + compressed chunk artifacts (cloud).

        With ``spcfg.alloc_schedule`` armed, the artifacts are encoded
        at per-chunk widths: a first base-width pass measures the entropy
        signal, the allocator turns (attention mass x entropy) saliency
        into per-chunk bits, and any chunk allocated off the base width
        is re-quantized at its own width before entropy coding."""
        cfg = self.model.cfg
        s = tokens.shape[1]
        ct = self.chunk_tokens
        if tokens.shape[0] != 1 or s % ct:
            raise ValueError(f"one context per registration, of a length "
                             f"that is a multiple of {ct}; got "
                             f"{tokens.shape}")
        with self._phase("prefill"):
            tok = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                  device=self.device)
            _, cache = self.model.prefill(self.params, {"tokens": tok})
            exact_k = cache["k"].float()                # (L, 1, S, hkv, hd)
            exact_v = cache["v"].float()
            k = exact_k.cpu().numpy()
            v = exact_v.cpu().numpy()
        n_t, n_l = s // ct, cfg.num_layers

        # pass 1: base-width quantization + the measured entropy signal
        quant = {}
        ent = np.zeros((n_l, 1))
        with self._phase("quantize"):
            for t in range(n_t):
                for l in range(n_l):
                    kc = k[l, 0, t * ct:(t + 1) * ct]
                    vc = v[l, 0, t * ct:(t + 1) * ct]
                    qk = quantize(kc, self.spcfg.quant_bits,
                                  self.spcfg.quant_group)
                    qv = quantize(vc, self.spcfg.quant_bits,
                                  self.spcfg.quant_group)
                    quant[Chunk(t, l, 0)] = (qk, qv)
                    ent[l, 0] += (huffman.entropy_bits(qk.codes, 1 << qk.bits)
                                  + huffman.entropy_bits(qv.codes,
                                                         1 << qv.bits)
                                  ) / (2 * n_t)

        # per-chunk allocation: re-quantize off-base chunks at their own
        # width
        with self._phase("mask"):
            active = self._measure_active_blocks(tokens, n_t, n_l)
        if getattr(self.spcfg, "alloc_schedule", "uniform") != "uniform":
            from repro_torch.compression.allocate import (allocate_bits,
                                                          schedule_of)
            bits_arr = allocate_bits(
                active, ent, self.spcfg.quant_bits,
                schedule_of(self.spcfg.alloc_schedule))
            with self._phase("quantize"):
                for c, (qk, qv) in list(quant.items()):
                    b = int(bits_arr[c.t, c.l, 0])
                    if b != self.spcfg.quant_bits:
                        kc = k[c.l, 0, c.t * ct:(c.t + 1) * ct]
                        vc = v[c.l, 0, c.t * ct:(c.t + 1) * ct]
                        quant[c] = (quantize(kc, b, self.spcfg.quant_group),
                                    quantize(vc, b, self.spcfg.quant_group))

        encoded = {}
        chunk_bytes = np.zeros((n_t, n_l, 1))
        with self._phase("huffman_encode"):
            for c, (qk, qv) in quant.items():
                ek = huffman.encode(qk.codes, 1 << qk.bits, n_streams=64)
                ev = huffman.encode(qv.codes, 1 << qv.bits, n_streams=64)
                encoded[c] = (ek, ev, qk, qv)
                chunk_bytes[c.t, c.l, 0] = (ek.payload_bytes()
                                            + ev.payload_bytes()
                                            + qk.header_bytes()
                                            + qv.header_bytes())

        wl = WorkloadChunks(
            n_t=n_t, n_l=n_l, n_h=1, active_blocks=active,
            entropy_bits=ent, chunk_bytes=chunk_bytes,
            head_pattern=np.zeros((n_l, 1), np.int64),
            context_len=s, chunk_tokens=ct)
        cid = self._next_id
        self._next_id += 1
        self.contexts[cid] = StoredContext(
            tokens=tokens, exact_k=exact_k, exact_v=exact_v,
            encoded=encoded, wl=wl, n_chunks=n_t * n_l)
        return cid

    def _measure_active_blocks(self, tokens, n_t, n_l) -> np.ndarray:
        """Per-(t, l) active kv blocks from pooled block scores."""
        from repro_torch.sparse.mask import block_scores, select_blocks
        ct = self.chunk_tokens
        qb = min(self.spcfg.q_block, ct)
        kb = min(self.spcfg.kv_block, ct)
        # use embeddings as a cheap q/k surrogate at serving time
        tok = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                              device=self.device)
        x = self.params["emb"][tok].float()                   # (1, S, d)
        sc = block_scores(x, x, q_block=qb, kv_block=kb, causal=True)
        _, cnt = select_blocks(sc, mass=self.spcfg.attention_mass,
                               q_block=qb, kv_block=kb)
        cnt = cnt[0].cpu().numpy().astype(np.float64)        # (n_qb,)
        rows_per_chunk = ct // qb
        per_t = cnt.reshape(n_t, rows_per_chunk).sum(axis=1)
        out = np.broadcast_to(per_t[:, None, None],
                              (n_t, n_l, 1)).copy()
        # deeper layers tend denser (observed in the measurement study)
        depth = np.linspace(0.8, 1.2, n_l)[None, :, None]
        return out * depth

    # ---------------- edge side ----------------
    def _ensure_predictor(self) -> None:
        """Train the planner's latency MLP on this server's device, as
        ``baselines._predictor_cache`` would on first use (same samples
        and epochs), so a CPU server never builds one for the card."""
        key = (self.model.cfg.name, self.profile)
        if key not in B._PRED_CACHE:
            p = LatencyPredictor(self.model.cfg, PROFILES[self.profile],
                                 device=self.device)
            p.fit(4000, epochs=150)
            B._PRED_CACHE[key] = p

    def load_context(self, cid: int, *, policy: str = "sparkv",
                     util: Optional[float] = None, seed: Optional[int] = None):
        """Run the loading pipeline; returns (bf16 cache, PipelineResult)."""
        st = self.contexts[cid]
        u = self.utilization() if util is None else util
        net = NETWORKS[self.network]
        with self._phase("plan"):
            self._ensure_predictor()
            res = B.PIPELINES[policy](self.model.cfg, st.wl, self.profile,
                                      net, self.spcfg, util=u,
                                      seed=seed or self.seed)
        streamed = sorted(getattr(res.engine, "streamed_set", set()))
        k, v = self.assemble(st, streamed)
        cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
        return cache, res

    def assemble(self, st: StoredContext, streamed) -> tuple:
        """The fp32 (k, v) cache with each streamed chunk replaced by its
        decoded + dequantized values, written on the device."""
        ct = self.chunk_tokens
        k = st.exact_k.clone()
        v = st.exact_v.clone()
        decoded = []
        with self._phase("huffman_decode"):
            for c in streamed:
                ek, ev, qk, qv = st.encoded[c]
                dk = huffman.decode(ek)
                dv = huffman.decode(ev)
                if not (np.array_equal(dk, qk.codes)
                        and np.array_equal(dv, qv.codes)):
                    raise RuntimeError(f"bitstream corruption in chunk {c}")
                qk2 = dataclasses.replace(qk, codes=dk.astype(np.uint8))
                qv2 = dataclasses.replace(qv, codes=dv.astype(np.uint8))
                decoded.append((c, qk2, qv2))
        with self._phase("dequant"):
            if decoded:
                # one launch over every streamed chunk, K and V, written
                # straight into the cache at its (layer, token-range) slot;
                # per-chunk adaptive widths take the mixed form
                qts = [q for _, qk2, qv2 in decoded for q in (qk2, qv2)]
                dests = [x[c.l, 0, c.t * ct:(c.t + 1) * ct]
                         for c, _, _ in decoded for x in (k, v)]
                dequantize_into(qts, dests,
                                mixed=len({q.bits for q in qts}) > 1)
        return k, v

    def generate(self, cid: int, prompt: np.ndarray, max_new: int = 8,
                 *, policy: str = "sparkv", compare_exact: bool = True,
                 seed: Optional[int] = None) -> ServeResult:
        """Serve one request: load context via `policy`, feed the prompt,
        decode max_new tokens greedily; quality vs the exact cache."""
        t_wall = time.time()
        self.active_requests += 1
        try:
            st = self.contexts[cid]
            cache, res = self.load_context(cid, policy=policy, seed=seed)
            toks, logits_seq = self._decode(st, cache, prompt, max_new)
            if compare_exact:
                exact_cache = {"k": st.exact_k.to(torch.bfloat16),
                               "v": st.exact_v.to(torch.bfloat16)}
                etoks, elogits = self._decode(st, exact_cache, prompt,
                                              max_new)
                agree = float(np.mean(toks == etoks))
                kl = float(np.mean([_kl(e, a) for e, a
                                    in zip(elogits, logits_seq)]))
            else:
                agree, kl = 1.0, 0.0
            eng = res.engine
            return ServeResult(
                ttft_s=res.ttft_s, energy_j=res.energy_j, tokens=toks,
                top1_agreement=agree, mean_kl=kl,
                n_streamed=eng.n_streamed, n_computed=eng.n_computed,
                migrations=getattr(eng, "n_migrations", 0),
                wall_s=time.time() - t_wall)
        finally:
            self.active_requests -= 1

    def _decode(self, st: StoredContext, cache, prompt, max_new):
        """Greedy decode; the next token stays on the device, so the loop
        does not wait for the host until the end."""
        cfg = self.model.cfg
        s = st.tokens.shape[1]
        with self._phase("decode"):
            full = self.model.init_cache(1, s, device=self.device)
            full["k"] = cache["k"][:, :, :s].to(full["k"].dtype)
            full["v"] = cache["v"][:, :, :s].to(full["v"].dtype)
            toks, logits_list = [], []
            cur = None
            pos = s
            feed = list(prompt) + [None] * max_new
            for tok in feed:
                if tok is None:
                    tok_t = cur
                else:
                    tok_t = torch.tensor([int(tok)], device=self.device)
                logits, full = self.model.decode_step(self.params, full,
                                                      tok_t, pos)
                pos += 1
                lf = logits[0].float()
                cur = lf[:cfg.vocab_size].argmax().reshape(1)
                toks.append(cur)
                logits_list.append(lf)
            n = len(prompt)
            out_toks = torch.cat(toks[n:]).cpu().numpy()
            out_logits = [lf.cpu().numpy() for lf in logits_list[n:]]
        return out_toks, out_logits


def _kl(p_logits: np.ndarray, q_logits: np.ndarray) -> float:
    p = p_logits - p_logits.max()
    q = q_logits - q_logits.max()
    lp = p - np.log(np.exp(p).sum())
    lq = q - np.log(np.exp(q).sum())
    return float(np.sum(np.exp(lp) * (lp - lq)))
