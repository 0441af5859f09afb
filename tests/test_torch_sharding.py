"""The port's sharding metadata against the JAX reference, exactly: mesh
axes, partition specs, abstract shapes and dtypes, for all ten configs at
full size.

No device is touched: the reference's ``sharding.set_mesh`` is handed a
stand-in mesh (``axis_names`` and a ``shape`` mapping, all its spec
functions read), the port's a ``launch.mesh.Mesh`` of the same axes, and
both build specs and abstract parameters without allocating
(``jax.eval_shape``; the ``meta`` device).  A spec is compared as the tuple
of its entries.  ~15 s on one worker, most of it the reference's
``abstract_init`` (``eval_shape`` of every config's init, once per mesh).
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as RC
from repro.launch import train as JTR
from repro.models import layers as JL, moe as JMOE, sharding as JS, transformer as JT

import repro_torch.configs as C
from repro_torch import convert
from repro_torch.launch import train as TR
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models import layers as L, moe as MOE, sharding as S, transformer as T
from repro_torch.tree import tree_leaves

MESHES = {"1x1": (("data", "model"), (1, 1)), "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
ARCHS = list(C.ARCH_IDS)
OPTS = ("adam", "momentum", "sgd", "adafactor")


def _set(mesh_id):
    names, sizes = MESHES[mesh_id]
    JS.set_mesh(types.SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes))))
    S.set_mesh(Mesh(names, sizes))


@pytest.fixture(autouse=True)
def _no_mesh_after():
    yield
    JS.set_mesh(None)
    S.set_mesh(None)


def _jspecs(tree):
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=lambda t: isinstance(t, JP))]


def _tspecs(tree):
    return [tuple(s) for s in tree_leaves(tree, is_leaf=S.is_spec)]


def _jshapes(tree):
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(tree)]


def _tshapes(tree):
    return [(tuple(x.shape), str(x.dtype).removeprefix("torch.")) for x in tree_leaves(tree)]


_REF = {}


def _ref_abstract(mesh_id, arch):
    """The reference's (ShapeDtypeStructs, specs), once per mesh and config."""
    if (mesh_id, arch) not in _REF:
        _REF[(mesh_id, arch)] = JT.abstract_init(JT.build(RC.get(arch)))
    return _REF[(mesh_id, arch)]


def test_meshes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512
    assert make_host_mesh().shape == {"data": 1, "model": 1} and make_host_mesh().size == 1


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_sanitize_and_batch_axes(mesh_id):
    _set(mesh_id)
    assert S.batch_axes() == JS.batch_axes()
    assert S.has_axis("pod") == JS.has_axis("pod")
    rng = np.random.default_rng(0)
    entries = [None, "data", "model", "pod", ("pod", "data"), ("data", "model")]
    for _ in range(200):
        nd = int(rng.integers(1, 5))
        dims = [1, 2, 3, 8, 16, 24, 32, 128, 256, 4096]
        shape = tuple(int(rng.choice(dims)) for _ in range(nd))
        picks = rng.integers(0, len(entries), int(rng.integers(0, nd + 1)))
        spec = [entries[int(i)] for i in picks]
        assert tuple(S.sanitize(shape, S.P(*spec))) == tuple(JS.sanitize(shape, JP(*spec)))
        assert S.axis_size("data") == JS.axis_size("data")


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_head_and_expert_axes(mesh_id):
    _set(mesh_id)
    for arch in ARCHS:
        cfg, rcfg = C.get(arch), RC.get(arch)
        for model_size in (1, 2, 8, 16, 32):
            for cache in (False, True):
                assert tuple(L.kv_head_spec(cfg, model_size, for_cache=cache)) \
                    == tuple(JL.kv_head_spec(rcfg, model_size, for_cache=cache)), arch
        if cfg.moe:
            assert MOE._expert_ff_axis(cfg) == JMOE._expert_ff_axis(rcfg), arch


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_params_specs_and_shapes(mesh_id, arch):
    """``param_specs`` and ``abstract_init``'s specs leaf for leaf in
    ``jax.tree`` order, the abstract shapes and dtypes, ``fsdp_specs`` at
    the default ``min_size`` and at 16, and the optimizer state's specs."""
    _set(mesh_id)
    ref_sds, ref_specs = _ref_abstract(mesh_id, arch)
    model = T.build(C.get(arch))
    params, specs = T.abstract_init(model)
    assert all(t.device.type == "meta" for t in tree_leaves(params))
    assert _tspecs(specs) == _jspecs(ref_specs)
    assert _tspecs(T.param_specs(model)) == _jspecs(ref_specs)
    assert _tshapes(params) == _jshapes(ref_sds)
    for kw in ({}, {"min_size": 16}):
        assert _tspecs(T.fsdp_specs(params, specs, **kw)) \
            == _jspecs(JT.fsdp_specs(ref_sds, ref_specs, **kw))
    fsdp, ref_fsdp = T.fsdp_specs(params, specs), JT.fsdp_specs(ref_sds, ref_specs)
    for name in OPTS:
        got = TR.opt_state_specs(name, params, fsdp)
        want = JTR.opt_state_specs(name, ref_sds, ref_fsdp)
        assert _tspecs(got) == _jspecs(want), name
        if name == "adam":
            assert isinstance(got, TR.optim.AdamState)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs(mesh_id, arch):
    """``cache_specs`` at batch 0, 1 and 128 (and each layer's entry in the
    port's per-layer order), ``input_specs`` for the four shapes and their
    ``batch_specs``."""
    _set(mesh_id)
    cfg, rcfg = C.get(arch), RC.get(arch)
    model, rmodel = T.build(cfg), JT.build(rcfg)
    for batch in (0, 1, 128):
        got, want = T.cache_specs(model, batch=batch), JT.cache_specs(rmodel, batch=batch)
        assert _tspecs(got) == _jspecs(want)
        for plan in T.layer_plans(model):
            assert _tspecs(T.cache_entry_spec(cfg, plan, batch=batch)) \
                == _jspecs(JT.cache_entry_spec(rcfg, plan, batch=batch))
    for shape in C.SHAPES:
        got, want = C.input_specs(cfg, shape), RC.input_specs(rcfg, shape)
        assert list(got) == list(want)
        assert _tshapes(got) == _jshapes(want)
        assert all(t.device.type == "meta" for t in got.values())
        if C.SHAPES[shape]["kind"] != "decode":
            assert _tspecs(TR.batch_specs(cfg, got)) == _jspecs(JTR.batch_specs(rcfg, want))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_init_is_the_trainers_tree(arch):
    """At the reduced size, ``abstract_init`` equals in shape and dtype the
    stacked tree the trainer holds, drawn on the CPU."""
    model = T.build(C.get(arch).reduced())
    params, _ = T.abstract_init(model)
    drawn = convert.stack_model_params(model, T.init_params(model, 0, "cpu"))
    assert _tshapes(params) == _tshapes(drawn)
    assert [t.requires_grad for t in tree_leaves(params)] == [False] * len(tree_leaves(params))


def test_shardings_and_trainer_mesh():
    """``sharding_for``/``shardings_for`` give the per-device shape and
    bytes under the sanitized spec; the trainer refuses a mesh of more
    than one device."""
    mesh = make_production_mesh()
    S.set_mesh(mesh)
    sh = S.sharding_for(S.P("data", "model"))
    assert sh.shard_shape((32, 4096)) == (2, 256)
    assert sh.shard_shape((1, 4096)) == (1, 256)              # batch 1: data dropped
    assert sh.shard_bytes((32, 4096), torch.bfloat16) == 2 * 256 * 2
    specs = TR.shardings_for(mesh, {"a": S.P(None, "model"), "b": [S.P()]})
    assert specs["a"].shard_shape((3, 32)) == (3, 2) and specs["b"][0].shard_shape(()) == ()
    S.set_mesh(None)
    assert S.sharding_for(S.P()) is None
    with pytest.raises(ValueError):
        TR.Trainer(C.get("qwen3-1.7b").reduced(), mesh, device="cpu")
    tr = TR.Trainer(C.get("qwen3-1.7b").reduced(), make_host_mesh(), device="cpu")
    assert tr.mesh.size == 1 and S.get_mesh() is tr.mesh
