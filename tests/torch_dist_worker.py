"""One rank of a multi-rank case of tests/test_torch_distributed.py (gloo
on the CPU). Not a test module: the test starts WORLD_SIZE copies of

    python tests/torch_dist_worker.py <case> <json args> <out dir>

with RANK, WORLD_SIZE and STORE (a FileStore path) in the environment.
JAX and the JAX package are blocked before anything is imported: the
port must run without them. Rank 0 writes <out dir>/result.json.
"""
import sys

BLOCKED = ("jax", "jaxlib", "repro")


class _Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked: " + name)
        return None


sys.meta_path.insert(0, _Block())

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)
warnings.filterwarnings("ignore")

from repro_torch.configs import TrainConfig, get_smoke  # noqa: E402
from repro_torch.configs.base import (MoEConfig, ModelConfig,  # noqa: E402
                                      ShapeConfig)
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.distributed.sharding import (Sharding,  # noqa: E402
                                              make_rules, spec_placements,
                                              use_rules)
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.training.trainer import (build_train_step,  # noqa: E402
                                          data_batch, jit_train_step,
                                          shard_tree)
from repro_torch.tree import leaves, tree_map  # noqa: E402

CPU = "cpu"
RANK = int(os.environ["RANK"])


def draw(model, seed):
    """fp32 weights for the param defs, drawn with numpy in the
    reference's leaf order: normal leaves N(0, 1) * scale, the zeros/ones
    leaves moved by N(0, 0.1^2) so that they are tested."""
    rng = np.random.default_rng(seed)

    def one(d):
        w = rng.normal(size=d.shape) * (d.scale if d.init == "normal"
                                        else 0.1)
        return to_tensor((w + (d.init == "ones")).astype(np.float32), CPU)
    return tree_map(one, model.param_defs())


def full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def rel_err(a, b) -> float:
    """max |a - b| over the leaf's largest magnitude (floored at 1e-3)."""
    a, b = full(a).float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3)


def per_shard_moe(n_data):
    """The sharded dispatch's semantics on one device: every token routed
    as moe_block_local routes it, the router loss of each data shard's
    tokens averaged over the shards (the reference's pmean)."""
    local = L.moe_block_local

    def moe_block(cfg, p, x):
        y, _ = local(cfg, p, x)
        auxs = [local(cfg, p, xc)[1] for xc in x.chunk(n_data)]
        return y, sum(auxs) / n_data
    return moe_block


def case_step(arch, mesh_shape, axes, overrides, steps=2, batch=4, seq=32,
              microbatches=1, masked=0):
    """jit_train_step on the mesh against build_train_step on one rank,
    from the same numpy-drawn fp32 weights and data_batch, both with
    `microbatches`; the last label of the first `masked` rows is masked
    out (-1), so that the microbatches' loss normalizers differ."""
    L.bf16_grad_barrier = lambda x: x
    moe = overrides.pop("moe", None)
    cfg = dataclasses.replace(get_smoke(arch), **overrides)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    model = build_model(cfg)
    mesh = make_local_mesh(tuple(mesh_shape), tuple(axes), device=CPU)
    rules = make_rules(cfg, mesh)
    # the reference's default schedule (lr 3e-4, 100 warmup steps): Adam's
    # first steps move every element by about lr * sign(g), so a larger
    # lr turns fp32 noise in near-zero grads into param differences
    tcfg = TrainConfig(total_steps=4, microbatches=microbatches)
    shape = ShapeConfig("t", "train", seq, batch)
    n_data = rules.axis_size(rules.table["batch"])

    def batches():
        for step in range(steps):
            b = data_batch(cfg, tcfg, step, batch, seq, device=CPU)
            if "frames" in b:
                b["frames"] = b["frames"].float()
            if masked:
                b["tokens"][:masked, -1] = -1
            yield b

    # one rank, no mesh
    base_moe = L.moe_block
    if cfg.moe is not None:
        L.moe_block = per_shard_moe(n_data)
    step1, opt1 = build_train_step(model, tcfg)
    p1 = draw(model, 2)
    s1 = opt1.init(p1)
    m1 = []
    for b in batches():
        p1, s1, m = step1(p1, s1, b)
        m1.append(m)
    L.moe_block = base_moe

    # the mesh
    stepn, optn = jit_train_step(model, tcfg, rules,
                                 model.input_pspecs(shape, rules))
    pn = shard_tree(draw(model, 2), model.param_shardings(rules))
    sn = optn.init(pn)
    mn = []
    for b in batches():
        pn, sn, m = stepn(pn, sn, b)
        mn.append(m)
    placements = {str(i): str(tuple(x.placements))
                  for i, x in enumerate(leaves(pn))}
    errs = {"params": max(rel_err(a, b) for a, b in
                          zip(leaves(pn), leaves(p1))),
            "m": max(rel_err(a, b) for a, b in
                     zip(leaves(sn.m), leaves(s1.m))),
            "v": max(rel_err(a, b) for a, b in
                     zip(leaves(sn.v), leaves(s1.v)))}
    return {
        "loss": [[float(a["loss"]), float(b["loss"])] for a, b in
                 zip(mn, m1)],
        "grad_norm": [[float(a["grad_norm"]), float(b["grad_norm"])]
                      for a, b in zip(mn, m1)],
        "count": int(sn.count), "errs": errs,
        "fallbacks": dict(rules.fallbacks),
        "table": {k: list(v) for k, v in rules.table.items()},
        "placements": placements,
        "dtensors": all(type(x).__name__ == "DTensor" for x in
                        leaves(pn) + leaves(sn.m) + leaves(sn.v)),
    }


def moe_cfg(n_exp):
    """tests/test_sharding.py's MoE block config."""
    return ModelConfig(name="t", family="moe", num_layers=2, d_model=32,
                       num_heads=4, num_kv_heads=2, d_ff=16, vocab_size=128,
                       moe=MoEConfig(num_experts=n_exp, experts_per_token=2,
                                     capacity_factor=8.0))


def moe_inputs(n_exp, seed=0):
    """fp32 MoE block weights and a (4, 8, 32) input, drawn with numpy
    (tests/test_torch_distributed.py draws the same for the reference)."""
    cfg = moe_cfg(n_exp)
    rng = np.random.default_rng(seed)
    defs = L.moe_defs(cfg)
    p = {k: (rng.normal(size=defs[k].shape) * defs[k].scale
             ).astype(np.float32) for k in sorted(defs)}
    x = rng.normal(size=(4, 8, 32)).astype(np.float32)
    return cfg, p, x


def case_moe(n_exp, weight_stationary, out):
    """moe_block (sent to moe_block_sharded on the (2, 4) mesh) against
    moe_block_local, forward and gradients; y and aux saved for the
    comparison with the reference's shard_map dispatch. The router loss
    is each data shard's averaged (FSDP layout) or all tokens' (the
    weight-stationary layout gathers them), as the reference's."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    cfg, pn, xn = moe_inputs(n_exp)
    mesh = make_local_mesh((2, 4), device=CPU)
    rules = make_rules(cfg, mesh, weight_stationary=weight_stationary)
    defs = L.moe_defs(cfg)
    r = torch.from_numpy(np.random.default_rng(1).normal(
        size=xn.shape).astype(np.float32))

    def loss(y, aux):
        return (y * r).sum() + aux

    # one device: the routing of moe_block_local, the router loss per
    # data shard averaged (the sharded dispatch's semantics)
    p1 = {k: torch.from_numpy(v).requires_grad_() for k, v in pn.items()}
    x1 = torch.from_numpy(xn).requires_grad_()
    y1, aux1 = L.moe_block_local(cfg, p1, x1)
    if not weight_stationary:     # else every rank routes all tokens
        aux1 = per_shard_moe(2)(cfg, p1, x1)[1]
    g1 = torch.autograd.grad(loss(y1, aux1), [x1, *p1.values()])

    pd = {k: rules.distribute(torch.from_numpy(v), defs[k].axes)
          .requires_grad_() for k, v in pn.items()}
    xd = rules.distribute(torch.from_numpy(xn), ("batch", None, None)
                          ).requires_grad_()
    with use_rules(rules), implicit_replication():
        yd, auxd = L.moe_block(cfg, pd, xd)
        gd = torch.autograd.grad(loss(yd, auxd), [xd, *pd.values()])
    y_full, aux_full = yd.full_tensor(), auxd.full_tensor()
    grads = [rel_err(a, b) for a, b in zip(gd, g1)]
    if RANK == 0:
        np.savez(os.path.join(out, "moe.npz"), y=y_full.detach().numpy(),
                 aux=aux_full.detach().numpy())
    return {"y_err": float((y_full - y1).abs().max()),
            "aux": float(aux_full), "aux_oracle": float(aux1),
            "grad_errs": grads, "is_dtensor": isinstance(yd, DTensor),
            "placements": {k: str(tuple(v.placements))
                           for k, v in pd.items()},
            "y_placements": str(tuple(yd.placements))}


def case_psum(steps=2):
    """compressed_psum over the world: the mean of each leaf against the
    exact mean, to int8 rounding; the residual carried from step to
    step (error feedback)."""
    from repro_torch.training.compression import (compressed_psum,
                                                  init_error_state)
    n = dist.get_world_size()
    rng = np.random.default_rng(100 + RANK)
    shapes = {"a": (64, 32), "b": (7,)}
    err = init_error_state({k: torch.zeros(v) for k, v in shapes.items()})
    tot_avg = {k: torch.zeros(v) for k, v in shapes.items()}
    tot_g = {k: torch.zeros(v) for k, v in shapes.items()}
    worst, res_err = 0.0, 0.0
    for _ in range(steps):
        g = {k: torch.from_numpy(rng.normal(0, 0.01, v).astype(np.float32))
             for k, v in shapes.items()}
        gf = {k: g[k] + err[k] for k in g}
        avg, new_err = compressed_psum(g, err)
        for k in g:
            exact = gf[k].clone()
            dist.all_reduce(exact)
            exact /= n
            scale = gf[k].abs().max() + 1e-12
            dist.all_reduce(scale, op=dist.ReduceOp.MAX)
            scale = scale / 127.0
            # each rank rounds to the shared grid: half a step at most
            worst = max(worst, float((avg[k] - exact).abs().max() / scale))
            q = torch.clamp(torch.round(gf[k] / scale), -127, 127)
            res_err = max(res_err, float((new_err[k] - (gf[k] - q * scale))
                                         .abs().max()))
            tot_avg[k] += avg[k]
            tot_g[k] += g[k]
        err = new_err
    # error feedback: what was sent over the steps is the mean of the
    # grads less the mean of the final residuals
    ef = 0.0
    for k in shapes:
        want = tot_g[k] - err[k]
        dist.all_reduce(want)
        want /= n
        ef = max(ef, float((tot_avg[k] - want).abs().max()))
    return {"world": n, "worst_in_steps": worst, "residual_err": res_err,
            "ef_err": ef,
            "residual_nonzero": float(sum(e.abs().sum() for e in
                                          err.values()))}


def case_elastic(out, steps=2):
    """Train 2 steps on a (1, 4) mesh and save; continue 2 steps there,
    and from the checkpoint on (4, 1) and (2, 2) (restored with
    `shardings`): the same params at the end."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed.sharding import Sharding
    from repro_torch.training.optimizer import AdamWState
    from torch.distributed.tensor import Replicate
    L.bf16_grad_barrier = lambda x: x
    cfg = get_smoke("qwen2.5-3b")
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=8)
    shape = ShapeConfig("t", "train", 32, 4)

    def on(mesh_shape):
        mesh = make_local_mesh(mesh_shape, device=CPU)
        rules = make_rules(cfg, mesh)
        fn, opt = jit_train_step(model, tcfg, rules,
                                 model.input_pspecs(shape, rules))
        return mesh, rules, fn, opt

    def train(fn, p, st, first):
        for step in range(first, first + steps):
            p, st, _ = fn(p, st, data_batch(cfg, tcfg, step, 4, 32,
                                            device=CPU))
        return p, st

    _, rules, fn, opt = on((1, 4))
    p = shard_tree(draw(model, 2), model.param_shardings(rules))
    p, st = train(fn, p, opt.init(p), 0)
    cm = CheckpointManager(os.path.join(out, "ckpt"), async_save=True)
    cm.save({"params": p, "opt": st}, steps)
    cm.wait()
    like = {"params": p, "opt": st}
    p, st = train(fn, p, st, steps)
    want = [full(x) for x in leaves(p)]
    errs = {}
    for mesh_shape in ((4, 1), (2, 2)):
        mesh, rules, fn, _ = on(mesh_shape)
        sh = model.param_shardings(rules)
        rep = Sharding(mesh, (Replicate(),) * mesh.ndim)
        state, step = cm.restore_latest(like=like, shardings={
            "params": sh, "opt": AdamWState(sh, sh, rep)})
        assert step == steps
        placed = [str(tuple(x.placements)) for x in leaves(state["params"])]
        q, _ = train(fn, state["params"], state["opt"], steps)
        errs[str(mesh_shape)] = {
            "err": max(rel_err(a, b) for a, b in zip(leaves(q), want)),
            "placements": placed}
    return {"ckpt": os.path.join(out, "ckpt"), "step": steps,
            "meshes": errs}


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


def case_shards(layouts):
    """Every param of each (mesh, arch, weight_stationary) layout laid
    out by the rules: which global indices each rank holds, per dim (a
    rank's block is the product of those index sets)."""
    from torch.distributed.tensor import distribute_tensor
    res = {}
    for mesh_shape, axes, arch, overrides, ws in layouts:
        cfg = get_smoke(arch)
        if overrides:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **overrides))
        mesh = make_local_mesh(tuple(mesh_shape), tuple(axes), device=CPU)
        rules = make_rules(cfg, mesh, weight_stationary=ws)
        model = build_model(cfg)
        mine = {}
        for path, d in _paths(model.param_defs()):
            n = int(np.prod(d.shape))
            full_t = torch.arange(n, dtype=torch.float64).reshape(d.shape)
            loc = distribute_tensor(full_t, mesh,
                                    rules.placements(d.axes, d.shape),
                                    src_data_rank=None).to_local()
            v = loc.numpy().astype(np.int64)
            strides = np.cumprod((1,) + d.shape[::-1])[:-1][::-1]
            idx = [sorted(set(((v // st) % sz).ravel().tolist()))
                   for st, sz in zip(strides, d.shape)]
            block = full_t.numpy()[np.ix_(*idx)]
            assert np.array_equal(block, loc.numpy()), (path, idx)
            mine[path] = idx
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        key = f"{arch}|{'x'.join(map(str, mesh_shape))}|{ws}"
        res[key] = {path: [r[path] for r in every] for path in mine}
    return res


def _inputs(cfg, batch, seq, seed):
    """A prefill's inputs and `steps` decode tokens, drawn with numpy."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        x = {"frames": torch.from_numpy(rng.normal(
            size=(batch, seq, cfg.d_model)).astype(np.float32) * 0.5)}
    else:
        x = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(batch, seq)).astype(np.int64))}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         size=(8, batch)).astype(np.int64))
    return x, toks


def _errs(got, want, pre=""):
    """{path: rel_err} over the tensor leaves of two like trees."""
    if isinstance(want, dict):
        out = {}
        for k in want:
            out.update(_errs(got[k], want[k], f"{pre}/{k}"))
        return out
    if isinstance(want, (tuple, list)):
        out = {}
        for i, (a, b) in enumerate(zip(got, want)):
            out.update(_errs(a, b, f"{pre}/{i}"))
        return out
    return {pre or "/": rel_err(got, want)}


def _placements(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_placements(tree[k], f"{pre}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, a in enumerate(tree):
            out.update(_placements(a, f"{pre}/{i}"))
        return out
    return {pre: str(tuple(tree.placements))}


def case_serve(archs, mesh_shape, axes, steps=4, batch=4, seq=32):
    """Sharded prefill (the prefill rules) and `steps` sharded decode
    steps (weight-stationary rules) of each arch's smoke config, fp32,
    against the same on one rank without a mesh, from the same
    numpy-drawn weights and inputs. The prefill's outputs are laid out by
    prefill_out_axes, the decode cache by cache_axes."""
    from repro_torch.models.api import lay_out
    from repro_torch.training.trainer import partitioned
    mesh = make_local_mesh(tuple(mesh_shape), tuple(axes), device=CPU)
    res = {}
    for arch in archs:
        cfg = get_smoke(arch)
        if cfg.moe is not None:       # no assignment dropped
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        model = build_model(cfg)
        params = draw(model, 3)
        x, toks = _inputs(cfg, batch, seq, 5)
        encdec = cfg.family == "encdec"
        pos0 = 0 if encdec else seq

        def run(rules_pre, rules_dec, params_pre, params_dec, x, toks):
            with torch.no_grad(), partitioned(rules_pre):
                out = model.prefill(params_pre, x)
                if rules_pre is not None:
                    out = lay_out(out, model.prefill_out_axes(), rules_pre)
            pre = out if encdec else out[1]
            logits = [] if encdec else [out[0]]
            with torch.no_grad(), partitioned(rules_dec):
                cache = model.decode_cache(pre, rules_dec)
                if rules_dec is not None:
                    cache = lay_out(cache, model.cache_axes(), rules_dec)
                for i in range(steps):
                    lg, cache = model.decode_step(params_dec, cache, toks[i],
                                                  pos0 + i)
                    logits.append(lg)
            return out, logits, cache

        ref = run(None, None, params, params, x, toks)
        rp = make_rules(cfg, mesh)
        rd = make_rules(cfg, mesh, weight_stationary=True)
        pp = shard_tree(params, model.param_shardings(rp))
        pd = shard_tree(draw(model, 3), model.param_shardings(rd))
        xs = shard_tree(x, {k: Sharding(mesh, spec_placements(mesh, v))
                            for k, v in model.input_pspecs(
                                ShapeConfig("p", "prefill", seq, batch),
                                rp).items()})
        ts = [rd.distribute(t, ("batch",)) for t in toks]
        got = run(rp, rd, pp, pd, xs, ts)
        from torch.distributed.tensor import DTensor
        res[arch] = {
            "prefill": _errs(got[0], ref[0]),
            "logits": [rel_err(a, b) for a, b in zip(got[1], ref[1])],
            "cache": _errs(got[2], ref[2]),
            "dtensors": all(isinstance(t, DTensor) for t in
                            leaves(got[2]) + list(got[1])),
            "cache_placements": _placements(got[2]),
            "fallbacks": dict(rp.fallbacks),
        }
    return res


CASES = {"step": case_step, "moe": case_moe, "psum": case_psum,
         "elastic": case_elastic, "shards": case_shards,
         "serve": case_serve}


def main():
    case, args, out = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
    if case in ("moe", "elastic"):
        args["out"] = out
    world = int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", store=dist.FileStore(
        os.environ["STORE"], world), rank=RANK, world_size=world)
    try:
        res = CASES[case](**args)
        if RANK == 0:
            with open(os.path.join(out, "result.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
