"""Whether what the timed path produced is correct, against the plain
reference, once the window has closed.

Numbers compared (each against its limit in ``limits/<cell>.json``):

- ``kv_prefill_err``: the registered contexts' KV as the program stores
  it (its prefill) against the reference's float32 prefill of the same
  tokens and weights: a token's relative error ||program - reference|| /
  ||reference|| over its kv heads, the median over the context's tokens,
  the largest over layers and K or V.
- ``kv_stream_err`` (cells whose requests stream): every chunk of the
  cache each request assembled, in quantization steps, against
  the reference's quantize-and-dequantize of the program's stored chunk
  (streamed chunks), or against that stored chunk itself (the rest); the
  largest. The reference follows the program's stored KV here, since one
  rounding of a 5-bit code apart moves a value by a whole step; the
  stored KV is ``kv_prefill_err``'s to judge.
- ``logit_err``: each request's logits, at every step it ran,
  against the reference's over the same prompt and served tokens after a
  cache of its own (its prefill, the streamed chunks through its own
  quantizer): ||program - reference|| / ||reference - mean|| a position,
  the median over the window's positions.
- ``kv_decode_err``: the KV each request's decode steps wrote
  (the tail of the cache as its last step left it) against the KV the
  reference's steps add over the same tokens: a token's relative error,
  the median over the window's tokens, the largest over layers and K or
  V.
- ``kv_first_layer_err``: the same KV errors in the first KV layer (in a
  transformer, layer 0, whose K and V depend on the token fed and nothing
  before it): the largest over the window's tokens. A served token other
  than the one the program fed on reads about 1.4 there.
- ``token_gap``: at every position where a request produced a
  token, how far the reference's logit of that token lies below the
  reference's best, in standard deviations of the reference's logits;
  the largest. In a MoE cell the float8 control's widest gap reads no
  higher than the program's (its tokens follow the reference's as
  closely as the bfloat16 router's flips let the program's), so there
  the limit lies between the program's readings and those of a token
  altered where it is produced, which no other number sees.

The medians stand where a largest value would be the rare token whose
routed experts a rounding changes: a MoE router's k-th and (k+1)-th
choices lie close for a few tokens in a hundred, and there the program's
bfloat16 router picks another expert than the float32 reference.

Every request of the window is judged. The control (``control=True``) is
the reference in the program's place, in the precisions below those the
configuration states: float8 e4m3 for the bfloat16 model, 4 bits for the
5-bit chunks. A cell compares the numbers its limits file names.

The reference is the module the configuration names
(``harness.reference_module``). The KV numbers run over its ``kv_layers``,
which are the rows of the program's stored KV, of its decode tail and of
an assembled cache, and the l of a streamed chunk (t, l); "the first KV
layer" is the first of them. Whatever else a reference's context state
holds (a recurrent layer's) passes to its ``decode`` untouched, so that
the logits and the token gap judge it.
"""
from __future__ import annotations

import numpy as np
import torch

from cardbench import harness
from cardbench.reference import common as C


class Judge:
    """Reference readings of one run's outputs.

    reference: the reference module; stored: per context, the program's
    stored (k, v), each (L, S, hkv, hd) float32, a row for each of the
    reference's ``kv_layers``; contexts: per context, its (S,) token ids;
    model, sparkv: the configuration's blocks; params: the benchmark's
    weights."""

    def __init__(self, reference, model: dict, sparkv: dict, params: dict,
                 contexts: list, stored: list, device, *,
                 control: bool = False):
        self.m, self.sp = model, sparkv
        self.device = device
        self.control = control
        self.layers = reference.kv_layers(model)
        self.ref = reference.Reference(model, params)
        self.low = (reference.Reference(model, params, low=C.fp8)
                    if control else None)
        self.toks = [torch.as_tensor(np.asarray(c).reshape(-1),
                                     device=device) for c in contexts]
        self.stored = stored
        self.bits = sparkv["quant_bits"]
        with C.plain_fp32():
            self.ref_kv = [self.ref.context_kv(t) for t in self.toks]
            self.low_kv = ([self.low.context_kv(t) for t in self.toks]
                           if control else None)
        for kv in stored + self.ref_kv:
            self._rows("KV", kv[0])
        self._ctx = {}
        self._want = {}

    def _rows(self, what: str, x) -> None:
        """x has one row for each KV layer."""
        if x.shape[0] != len(self.layers):
            raise ValueError(f"{what} has {x.shape[0]} rows; the reference's"
                             f" KV layers are {self.layers}")

    # ---- KV ----
    def kv_token_errors(self) -> list:
        """A (S,) tensor of each token's relative error for every context,
        K or V, and layer."""
        kvs = self.low_kv if self.control else self.stored
        out = []
        for pk, rk in zip(kvs, self.ref_kv):
            for p, r in zip(pk[:2], rk[:2]):
                for l in range(len(self.layers)):
                    d = torch.linalg.vector_norm((p[l] - r[l]).flatten(1),
                                                 dim=1)
                    n = torch.linalg.vector_norm(r[l].flatten(1), dim=1)
                    out.append(d / n.clamp(min=1e-30))
        return out

    def kv_prefill_err(self) -> float:
        return max(float(e.median()) for e in self.kv_token_errors())

    def _chunk(self, x, t, l):
        ct = self.sp["chunk_tokens"]
        return x[l, t * ct:(t + 1) * ct]

    def kv_stream_err(self, context: int, assembled: tuple) -> float:
        """Largest gap, in steps, of an assembled (k, v) (each (L, 1, S,
        hkv, hd)) against the stored chunks, quantized where streamed."""
        return max([0.0, *self.stream_gaps(context, assembled).values()])

    def stream_gaps(self, context: int, assembled: tuple) -> dict:
        """{(K 0 or V 1, t, l): the chunk's largest gap in steps} of an
        assembled cache."""
        k_a, v_a, streamed = assembled
        self._rows("the assembled cache", k_a)
        streamed = set(streamed)
        g = self.sp["quant_group"]
        ct = self.sp["chunk_tokens"]
        gaps = {}
        for i, x_a in enumerate((k_a[:, 0], v_a[:, 0])):
            x_p = self.stored[context][i]
            for t in range(x_p.shape[1] // ct):
                for l in range(len(self.layers)):
                    key = (context, i, t, l)
                    if key not in self._want:
                        p = self._chunk(x_p, t, l)
                        codes, step, lo = C.quantize(p, self.bits, g)
                        self._want[key] = (
                            C.dequantize(codes, step, lo),
                            step.double()[:, None],
                            C.roundtrip(p, self.bits - 1, g)
                            if self.control else None)
                    deq, step, low = self._want[key]
                    got = self._chunk(x_a, t, l).to(self.device)
                    if (t, l) in streamed:
                        want = deq
                        got = low if self.control else got
                    else:
                        want = self._chunk(x_p, t, l).double().reshape(-1, g)
                    gap = (got.double().reshape(-1, g) - want).abs() / step
                    gaps[(i, t, l)] = float(gap.max())
        return gaps

    # ---- logits ----
    def _cache(self, state, streamed, bits):
        """A context state (k, v, *rest) with each streamed (t, l) chunk
        of k and v quantized at `bits`; the rest as it is."""
        if not streamed:
            return state
        k, v = state[0].clone(), state[1].clone()
        for x in (k, v):
            for t, l in streamed:
                c = self._chunk(x, t, l)
                c.copy_(C.roundtrip(c, bits, self.sp["quant_group"]))
        return (k, v, *state[2:])

    def _ref_ctx(self, context, streamed):
        key = (context, tuple(sorted(streamed)))
        if key not in self._ctx:
            self._ctx[key] = self._cache(self.ref_kv[context], streamed,
                                         self.bits)
        return self._ctx[key]

    def request(self, r) -> tuple:
        """(errors, gaps, kv, altered) of one request: the relative logit
        error at each step, the token gap at each position that produced
        a token, each token's relative error of the KV its step wrote,
        (2, L, T) for K and V, and the gap that the token after the chosen
        one in the vocabulary would read at each position (what a token
        altered where it is produced reads: a fault's reading). Reads
        r.prompt, r.fed (the token each step was fed), r.tokens (served),
        r.logits (each step's program logits), r.tail (the program's tail
        K and V after the last step), r.context, r.assembled; the last
        three are host copies."""
        n, v = r.n_prompt, self.m["vocab_size"]
        streamed = r.assembled[2] if r.assembled else []
        seq = np.concatenate([np.asarray(r.prompt), [int(r.fed[n])],
                              np.asarray(r.tokens)[:-1]])
        seq = torch.as_tensor(seq, dtype=torch.long, device=self.device)
        t = seq.shape[0]
        with C.plain_fp32():
            ref, ref_k, ref_v = self.ref.decode(
                self._ref_ctx(r.context, streamed), seq)
            if self.control:
                ctx = self._cache(self.low_kv[r.context], streamed,
                                  self.bits - 1)
                got, got_k, got_v = self.low.decode(ctx, seq)
            else:
                self._rows("the decode tail", r.tail[0])
                got = r.logits[:, :v].to(self.device).float()
                got_k, got_v = (x[:, :t].to(self.device).float()
                                for x in r.tail)
        got_kv = torch.stack([got_k, got_v]).flatten(3)
        ref_kv = torch.stack([ref_k, ref_v]).flatten(3)
        kv = (torch.linalg.vector_norm(got_kv - ref_kv, dim=3)
              / torch.linalg.vector_norm(ref_kv, dim=3).clamp(min=1e-30))
        centred = ref - ref.mean(-1, keepdim=True)
        err = (torch.linalg.vector_norm(got - ref, dim=-1)
               / torch.linalg.vector_norm(centred, dim=-1))
        # the token each generating position chose: the program's own, or
        # the control's first
        pos = torch.arange(n - 1, seq.shape[0], device=self.device)
        if self.control:
            chosen = got[pos].argmax(-1)
        else:
            chosen = torch.cat([seq[n:], torch.as_tensor(
                np.asarray(r.tokens)[-1:], device=self.device)])
        best = ref[pos].amax(-1)
        sd = ref[pos].std(-1)
        gap = (best - ref[pos, chosen]) / sd
        altered = (best - ref[pos, (chosen + 1) % v]) / sd
        return (err.cpu().numpy(), gap.cpu().numpy(), kv,
                altered.cpu().numpy())


def judge(run, *, control: bool = False, positions: list = None,
          tokens: list = None) -> dict:
    """The numbers for a finished run (harness.Run), over every request
    of its window. `positions`, a list, receives each request's (errors,
    gaps, altered-token gaps); `tokens` the contexts' per-token KV
    errors."""
    c = run.c
    reqs = run.requests
    stored = [(run.srv.contexts[cid].exact_k[:, 0],
               run.srv.contexts[cid].exact_v[:, 0]) for cid in run.cids]
    j = Judge(harness.reference_module(c.config), c.config["model"],
              c.config["sparkv"], run.params, run.traffic.contexts, stored,
              run.device, control=control)
    out = {"kv_prefill_err": j.kv_prefill_err()}
    if tokens is not None:
        tokens.extend(j.kv_token_errors())
    streaming = [r for r in reqs if r.assembled is not None]
    if streaming:
        out["kv_stream_err"] = max(j.kv_stream_err(r.context, r.assembled)
                                   for r in streaming)
    per = [j.request(r) for r in reqs]
    if positions is not None:
        positions.extend((e, g, a) for e, g, _, a in per)
    out["logit_err"] = float(np.median(np.concatenate(
        [e for e, _, _, _ in per])))
    kv = torch.cat([k for _, _, k, _ in per], dim=2)
    out["kv_decode_err"] = float(kv.median(dim=2).values.max())
    out["kv_first_layer_err"] = float(kv[:, 0].max())
    out["token_gap"] = float(max(g.max() for _, g, _, _ in per))
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers `limits`
    names: each read, finite and within its limit."""
    rows = {k: {"value": numbers.get(k), "limit": lim}
            for k, lim in limits.items()}
    ok = bool(rows) and all(
        r["value"] is not None and np.isfinite(r["value"])
        and r["value"] <= r["limit"] for r in rows.values())
    return ok, rows
