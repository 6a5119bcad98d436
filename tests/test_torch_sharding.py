"""The port's sharding layer against the JAX package, in one process and
without a process group: the logical axes of every param, the rule
tables and their fallbacks, the resolved PartitionSpecs on the two
production meshes (stubs, as tests/test_sharding.py uses), the inputs and
caches of every dry-run cell, the abstract params and the optimizer
state's specs. Then tests/test_sharding.py's resolver properties,
restated against the port, and the spec -> DTensor placement mapping.
Everything here is exact: the port's specs and tables equal the
reference's as tuples.
"""
import jax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import ASSIGNED_ARCHS, SHAPES  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import shape_applicable  # noqa: E402
from repro.distributed.sharding import make_rules as jmake_rules  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.training.optimizer import AdamW as JAdamW  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ARCHS = list(ASSIGNED_ARCHS) + ["sparkv-qwen3-4b"]


def _stub(multi_pod: bool, size: int = 16):
    class Mesh:
        axis_names = ("pod", "data", "model") if multi_pod \
            else ("data", "model")
        shape = ({"pod": 2, "data": size, "model": size} if multi_pod
                 else {"data": size, "model": size})
    return Mesh()


def _walk(t, pre=""):
    """(path, leaf) of a nested dict, keys sorted; a tuple is a leaf."""
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _walk(t[k], f"{pre}/{k}")
    else:
        yield pre, t


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_tree_matches_reference(arch):
    jdefs = jbuild(jget_config(arch)).param_defs()
    tdefs = build_model(get_config(arch)).param_defs()
    assert TL.axes_tree(tdefs) == JL.axes_tree(jdefs)
    # leaf for leaf, in tree.py's order (jax.tree.flatten's)
    jl = jax.tree.leaves(jdefs, is_leaf=JL.is_def)
    tl = flatten(tdefs)[0]
    assert [(d.shape, d.axes, d.init, d.scale, d.dtype) for d in tl] == \
        [(tuple(d.shape), d.axes, d.init, d.scale, d.dtype) for d in jl]
    with pytest.raises(AssertionError):
        TL.ParamDef((2, 3), ("embed",))


@pytest.mark.parametrize("sp", [False, True], ids=["", "sp"])
@pytest.mark.parametrize("ws", [False, True], ids=["", "ws"])
@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_param_specs_match_reference(arch, multi_pod, ws, sp):
    jr = jmake_rules(jget_config(arch), _stub(multi_pod),
                     weight_stationary=ws, sp_activations=sp)
    tr = S.make_rules(get_config(arch), _stub(multi_pod),
                      weight_stationary=ws, sp_activations=sp)
    assert tr.table == jr.table and tr.weight_stationary == ws
    js = dict(_walk(JL.pspec_tree(jbuild(jget_config(arch)).param_defs(), jr)))
    ts = dict(_walk(build_model(get_config(arch)).param_pspecs(tr)))
    assert sorted(js) == sorted(ts)
    for path in js:
        assert isinstance(ts[path], S.PartitionSpec)
        assert tuple(ts[path]) == tuple(js[path]), path
    assert tr.fallbacks == jr.fallbacks


CELLS = [(arch, name) for arch in ARCHS for name, shape in SHAPES.items()
         if shape_applicable(jget_config(arch), shape)[0]]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_inputs_match_reference(arch, shape):
    """input_specs / train_batch_shape (shapes, dtypes), input_pspecs,
    cache_axes, abstract_params and the AdamW state's specs of every
    dry-run cell, on the 16x16 mesh."""
    jm, tm = jbuild(jget_config(arch)), build_model(get_config(arch))
    sc = SHAPES[shape]
    jr = jmake_rules(jm.cfg, _stub(False))
    tr = S.make_rules(tm.cfg, _stub(False))

    def shapes(tree):
        return {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for p, v in _walk(tree)}

    jin = jm.input_specs(sc)
    tin = tm.input_specs(sc)
    assert sorted(jin) == sorted(tin)
    for k in jin:
        if k == "cache":
            assert shapes(tin[k]) == {p: (tuple(v.shape), str(v.dtype))
                                      for p, v in _walk(jin[k])}
            assert all(v.device.type == "meta" for _, v in _walk(tin[k]))
        else:
            assert (tuple(tin[k].shape), str(tin[k].dtype)[6:]) == \
                (tuple(jin[k].shape), str(jin[k].dtype))
            assert tin[k].device.type == "meta"
    assert shapes(tm.train_batch_shape(sc)) == shapes(tin)
    jp = jm.input_pspecs(sc, jr)
    tp = tm.input_pspecs(sc, tr)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        if k == "cache":
            jc, tc = dict(_walk(jp[k])), dict(_walk(tp[k]))
            assert sorted(jc) == sorted(tc)
            assert all(tuple(tc[p]) == tuple(jc[p]) for p in jc)
        else:
            assert tuple(tp[k]) == tuple(jp[k]), k
    assert dict(_walk(tm.cache_axes())) == dict(_walk(jm.cache_axes()))
    ja = {p: (tuple(v.shape), str(v.dtype)) for p, v in
          _walk(jm.abstract_params())}
    ta = tm.abstract_params()
    assert {p: (tuple(v.shape), str(v.dtype)[6:]) for p, v in
            _walk(ta)} == ja
    assert all(v.device.type == "meta" for _, v in _walk(ta))
    # the optimizer state: specs, and abstract moments in moment_dtype
    jo = JAdamW(JTrainConfig(), jm.cfg.moment_dtype)
    to = AdamW(TrainConfig(), tm.cfg.moment_dtype)
    jst = jo.state_pspecs(jm.param_pspecs(jr))
    tst = to.state_pspecs(tm.param_pspecs(tr))
    assert tuple(tst.count) == tuple(jst.count) == ()
    for jtree, ttree in ((jst.m, tst.m), (jst.v, tst.v)):
        jt, tt = dict(_walk(jtree)), dict(_walk(ttree))
        assert all(tuple(tt[p]) == tuple(jt[p]) for p in jt)
    jab = jo.abstract_state(jm.abstract_params())
    tab = to.abstract_state(ta)
    assert {p: (tuple(v.shape), str(v.dtype)[6:]) for p, v in
            _walk(tab.m)} == {p: (tuple(v.shape), str(v.dtype)) for p, v
                              in _walk(jab.m)}
    assert tab.count.shape == () and tab.count.dtype == torch.int32


# ------------------------------- tests/test_sharding.py, against the port


def test_resolver_divisibility_fallback():
    rules = S.make_rules(get_config("phi3-medium-14b"), _stub(True))
    spec = rules.spec(("batch", None, "heads", None), (256, 1, 40, 128))
    assert spec[2] is None                        # 40 heads % 16: fell back
    assert rules.table["heads"] == ()
    spec2 = rules.spec(("batch", "seq", None, None), (256, 4096, 40, 128))
    assert spec2[1] == "model"                    # sequence parallelism


def test_resolver_no_axis_reuse():
    rules = S.make_rules(get_config("qwen2.5-3b"), _stub(True))
    spec = rules.spec(("batch", "expert_cap", None), (256, 512, 64))
    used = [a for part in spec if part for a in
            (part if isinstance(part, tuple) else (part,))]
    assert len(used) == len(set(used))
    assert spec[0] == ("pod", "data") and spec[1] is None


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_resolve_for_all_archs(arch):
    mesh = _stub(True)
    model = build_model(get_config(arch))
    rules = S.make_rules(model.cfg, mesh)
    defs = flatten(model.param_defs())[0]
    specs = [s for _, s in _walk(model.param_pspecs(rules))]
    assert len(defs) == len(specs)
    for d, s in zip(defs, specs):
        for dim, part in zip(d.shape, tuple(s) + (None,) * 8):
            if part is None:
                continue
            axes = part if isinstance(part, tuple) else (part,)
            assert dim % rules.axis_size(axes) == 0, (arch, d.shape, s)


# ------------------------------------------ specs -> DTensor placements


def test_spec_placements_follow_the_split_order():
    """Each tensor dim's axes become Shard on their mesh dims; an axis
    that the spec splits after one the mesh puts later takes
    _StridedShard with that later axis's size (a right-to-left split)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    mesh = _stub(True)
    pl = S.spec_placements(mesh, S.PartitionSpec(("pod", "data"), None,
                                                 "model"))
    assert pl == (Shard(0), Shard(0), Shard(2))
    pl = S.spec_placements(mesh, S.PartitionSpec(None, ("model", "pod",
                                                        "data")))
    assert pl == (_StridedShard(1, split_factor=16),
                  _StridedShard(1, split_factor=16), Shard(1))
    assert S.spec_placements(mesh, S.PartitionSpec(None, None)) == \
        (Replicate(),) * 3
    # granite-moe's 40 experts over 16: the weight-stationary layout
    # splits d_ff over ("model", "data"), model-major
    rules = S.make_rules(get_config("granite-moe-3b-a800m"), _stub(False),
                         weight_stationary=True)
    assert rules.placements(("experts", "embed_fsdp", "mlp"),
                            (40, 1536, 512)) == \
        (_StridedShard(2, split_factor=16), Shard(2))


def test_partition_spec_is_a_tuple():
    p = S.PartitionSpec(("pod", "data"), None)
    assert p == (("pod", "data"), None) and isinstance(p, tuple)
    assert repr(p).startswith("PartitionSpec(")
    assert S.PartitionSpec() == ()


def test_constrain_is_the_identity_without_rules_or_dtensors():
    x = torch.ones(4, 3)
    assert S.constrain(x, "batch", None) is x
    with S.use_rules(S.make_rules(get_config("qwen2.5-3b"), _stub(False))):
        assert S.current_rules() is not None
        assert S.constrain(x, "batch", None) is x
    assert S.current_rules() is None


def test_mesh_needs_a_process_group():
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    with pytest.raises(RuntimeError, match="no process group"):
        make_local_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        make_production_mesh(device="cpu")


def test_production_mesh_needs_its_world(tmp_path):
    """A one-rank gloo group: the 1 x 1 local mesh, and the production
    meshes refused for want of 256 or 512 ranks."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_local_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert S.mesh_shape(mesh) == {"data": 1, "model": 1}
        rules = S.make_rules(get_config("qwen2.5-3b"), mesh)
        assert rules.n_devices == 1
        assert rules.table == jmake_rules(jget_config("qwen2.5-3b"),
                                          _stub(False, 1)).table
        # nothing divides over a mesh of one: every param replicated
        assert all(p == (None,) * len(p) for _, p in _walk(
            build_model(get_config("qwen2.5-3b")).param_pspecs(rules)))
        with pytest.raises(RuntimeError, match="256"):
            make_production_mesh(device="cpu")
        with pytest.raises(RuntimeError, match="512"):
            make_production_mesh(multi_pod=True, device="cpu")
    finally:
        dist.destroy_process_group()


def test_spmd_helpers_are_plain_on_plain_tensors():
    """Without DTensors the sharded path's helpers are the plain
    computations, bit for bit."""
    from repro_torch.distributed import spmd
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 8, generator=g)
    w = torch.randn(8, 3, 4, generator=g)
    assert torch.equal(spmd.einsum("bsd,dhk->bshk", x, w),
                       torch.einsum("bsd,dhk->bshk", x, w))
    assert not spmd.is_dtensor(x)
