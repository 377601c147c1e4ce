"""The launch layer's tables, sharding rules and abstract specs against
the reference, on the CPU, with no multi-device mesh.

The rules are pure functions of a leaf's path, its shape and the mesh's
axis sizes, so both packages are held on the same stand-in meshes of
(16, 16) and (2, 16, 16) (the reference's own ``FakeMesh`` idea, from
``tests/test_sharding_rules.py``) and on abstract trees: the reference's
``jax.eval_shape`` against the port's meta tensors. Per registered arch
at full width: every param and adapter leaf's spec at ``model_size=16``
and the abstract state's shapes and dtypes; per arch and input shape:
``input_specs`` (shapes and dtypes) and every batch and cache leaf's
spec. A model-parallel mesh over more than one device raises, citing
ROADMAP Queue 1 item 12b; the fleet mesh builds.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.launch import sharding as jsh
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro_torch import config as pconfig
from repro_torch.config import LoRAConfig, get_arch, get_input_shape
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding as sh
from repro_torch.launch import specs as specs
from repro_torch.launch import train as ptrain

torch.set_num_threads(1)

ARCHS = pconfig.list_archs()
SHAPES = sorted(pconfig.INPUT_SHAPES)
RANK = 8


class FakeMesh:
    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


MESHES = {"16x16": FakeMesh(("data", "model"), (16, 16)),
          "2x16x16": FakeMesh(("pod", "data", "model"), (2, 16, 16))}


def _ref_leaves(tree):
    """{path string: leaf} of a reference tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jsh._path_str(p): leaf for p, leaf in flat}


def _port_leaves(tree):
    out = {}
    sh.map_with_path(lambda p, leaf: out.__setitem__(sh._path_str(p), leaf),
                     tree)
    return out


def _dtype(leaf):
    return str(leaf.dtype).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _states(arch):
    """(reference abstract_state, port abstract_state) at full width."""
    jcfg, cfg = jconfig.get_arch(arch), get_arch(arch)
    ref = jtrain.abstract_state(jcfg, jconfig.LoRAConfig(rank=RANK),
                                rank=RANK)
    port = ptrain.abstract_state(cfg, LoRAConfig(rank=RANK), rank=RANK)
    return ref, port


def test_registries_agree():
    assert ARCHS == jconfig.list_archs()
    assert SHAPES == sorted(jconfig.INPUT_SHAPES)


def test_input_shape_table_equals_reference():
    for name in SHAPES:
        got, want = get_input_shape(name), jconfig.get_input_shape(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(KeyError):
        get_input_shape("train_8k")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_config_equals_reference(multi_pod):
    got = pconfig.MeshConfig(multi_pod=multi_pod)
    want = jconfig.MeshConfig(multi_pod=multi_pod)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.shape, got.axis_names, got.num_chips) == \
        (want.shape, want.axis_names, want.num_chips)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_state_equals_reference(arch):
    """Shapes and dtypes of params (bf16), adapters and Adam state, leaf
    by leaf, on the meta device."""
    (jp, ja, jo), (pp, pa, po) = _states(arch)
    for ref, port in ((jp, pp), (ja, pa), (jo.mu, po.mu), (jo.nu, po.nu)):
        r, p = _ref_leaves(ref), _port_leaves(port)
        assert sorted(r) == sorted(p)
        for k in r:
            assert tuple(p[k].shape) == tuple(r[k].shape), k
            assert _dtype(p[k]) == str(r[k].dtype), k
            assert p[k].device.type == "meta", k
    assert po.step.dtype == torch.int32 and po.step.shape == ()
    assert str(jo.step.dtype) == "int32"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch):
    """Every param and adapter leaf's spec at model_size=16."""
    (jp, ja, _), (pp, pa, _) = _states(arch)
    for ref, port, is_adapter in ((jp, pp, False), (ja, pa, True)):
        flat, _ = jax.tree_util.tree_flatten_with_path(ref)
        p = _port_leaves(port)
        for path, leaf in flat:
            want = jsh.param_spec(path, leaf, is_adapter=is_adapter,
                                  model_size=16)
            key = jsh._path_str(path)
            got = sh.param_spec(tuple(key.split("/")), p[key],
                                is_adapter=is_adapter, model_size=16)
            assert got == tuple(want), (key, got, want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_input_specs_equal_reference(arch, shape):
    """input_specs' shapes and dtypes, the window rules, and every batch
    or cache leaf's spec on both stand-in meshes."""
    jcfg, cfg = jconfig.get_arch(arch), get_arch(arch)
    js, ps = jconfig.get_input_shape(shape), get_input_shape(shape)
    assert specs.has_attention_cache(cfg) == jspecs.has_attention_cache(jcfg)
    assert specs.needs_window(cfg, ps) == jspecs.needs_window(jcfg, js)
    assert specs.cache_len_for(cfg, ps) == jspecs.cache_len_for(jcfg, js)
    want, got = jspecs.input_specs(jcfg, js), specs.input_specs(cfg, ps)
    r, p = _ref_leaves(want), _port_leaves(got)
    assert sorted(r) == sorted(p)
    for k in r:
        assert tuple(p[k].shape) == tuple(r[k].shape), k
        assert _dtype(p[k]) == str(r[k].dtype), k
        assert p[k].device.type == "meta", k
    for mesh in MESHES.values():
        if js.mode == "decode":
            flat, _ = jax.tree_util.tree_flatten_with_path(want["caches"])
            for path, leaf in flat:
                key = jsh._path_str(path)
                assert sh.cache_spec(tuple(key.split("/")), p["caches/" + key],
                                     mesh) == tuple(jsh.cache_spec(
                                         path, leaf, mesh)), key
        else:
            for k, leaf in want["batch"].items():
                assert sh.batch_spec(mesh, leaf.ndim, leaf.shape[0]) == \
                    tuple(jsh.batch_spec(mesh, leaf.ndim, leaf.shape[0])), k
            got_tree = sh.batch_shardings(mesh, got["batch"])
            assert got_tree == {k: sh.batch_spec(mesh, v.ndim, v.shape[0])
                                for k, v in got["batch"].items()}


@pytest.mark.parametrize("name", ["16x16", "2x16x16"])
def test_mesh_axes_equal_reference(name):
    mesh = MESHES[name]
    assert pmesh.data_axes(mesh) == tuple(
        a for a in mesh.axis_names if a in ("pod", "data"))
    assert sh.batch_axes(mesh) == jsh.batch_axes(mesh)
    for b in (1, 2, 8, 16, 32, 256, 512):
        assert sh._dp_for(mesh, b) == jsh._dp_for(mesh, b)
    assert pmesh.model_axis(mesh) == "model"


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-2.7b",
                                  "grok-1-314b", "rwkv6-7b"])
def test_tree_shardings_drop_what_does_not_divide(arch):
    """The safety net at reduced size: a spec whose axis does not divide
    its dimension on a (16, 3) mesh replicates, as the reference's
    ``tree_shardings`` decides leaf by leaf."""
    import importlib
    mod = importlib.import_module(
        "repro.configs." + arch.replace("-", "_").replace(".", "_")
        .replace("grok_1", "grok1"))
    jcfg = mod.reduced()
    pmod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")
        .replace("grok_1", "grok1"))
    cfg = pmod.reduced()
    jp, _, _ = jtrain.abstract_state(jcfg, jconfig.LoRAConfig(rank=4),
                                     rank=4)
    pp, _, _ = ptrain.abstract_state(cfg, LoRAConfig(rank=4), rank=4)
    mesh = FakeMesh(("data", "model"), (16, 3))
    specs_tree = sh.tree_shardings(mesh, pp)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    dropped = 0
    for path, leaf in flat:
        spec = tuple(jsh.param_spec(path, leaf, model_size=3))
        ok = all(ax is None or leaf.shape[i] % mesh.shape[ax] == 0
                 for i, ax in enumerate(spec))
        dropped += not ok
        port_path = tuple(int(k) if k.isdigit() else k
                          for k in jsh._path_str(path).split("/"))
        assert sh._at(specs_tree, port_path) == (spec if ok else ()), path
    assert dropped > 0


def test_fleet_specs_equal_reference():
    """fleet_spec and fleet_shardings (which leaves shard the fleet axis)
    against the reference's on a one-device fleet mesh."""
    jmesh = jax.make_mesh((1,), ("fleet",))
    mesh = pmesh.make_fleet_mesh(1, device="cpu")
    tree = {"lanes": np.zeros((6, 3, 2)), "per_task": np.zeros((2, 6)),
            "scalar": np.zeros(()), "other": np.zeros((4, 5))}
    for axis_pos, fleet_size in ((0, 6), (1, 6), (0, None)):
        want = jsh.fleet_shardings(jmesh, tree, axis_pos=axis_pos,
                                   fleet_size=fleet_size)
        got = sh.fleet_shardings(
            mesh, {k: torch.zeros(v.shape) for k, v in tree.items()},
            axis_pos=axis_pos, fleet_size=fleet_size)
        assert {k: tuple(v.spec) for k, v in want.items()} == got
    for nd in (1, 3):
        for pos in range(nd):
            assert sh.fleet_spec(nd, axis_pos=pos) == tuple(
                jsh.fleet_spec(nd, axis_pos=pos))


def test_one_device_meshes_run_and_constrain_as_identity():
    x = torch.ones(2, 3)
    for mesh in (None, pmesh.make_mesh((1, 1), ("data", "model"), "cpu"),
                 pmesh.make_fleet_mesh(device="cpu")):
        assert sh.make_constrain(mesh, True)(x) is x
        assert sh.fleet_constrainer(mesh, 2)(x) is x
    m = pmesh.make_fleet_mesh(device="cpu")
    assert (m.axis_names, m.sizes, m.size) == (("fleet",), (1,), 1)
    assert m.device == torch.device("cpu")


def test_more_devices_than_visible_raise_as_the_reference():
    with pytest.raises(ValueError, match="visible"):
        pmesh.make_fleet_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="visible"):
        pmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError):
        jax.make_mesh((16, 16), ("data", "model"))


def test_multi_device_mesh_raises_citing_item_12(monkeypatch):
    """A model-parallel mesh over more than one device: building one,
    constraining on one, or a train step on one raises
    NotImplementedError (item 12b); nothing silently replicates. The
    fleet mesh builds over every visible device (the sharded fleet)."""
    monkeypatch.setattr(pmesh, "visible_devices", lambda device: 4)
    for n, build in ((2, lambda: pmesh.make_fleet_mesh(2, device="cpu")),
                     (4, lambda: pmesh.make_fleet_mesh(device="cpu"))):
        m = build()
        assert m.sizes == (n,) and m.devices == (torch.device("cpu"),) * n
    with pytest.raises(NotImplementedError, match="item 12"):
        pmesh.make_mesh((2, 2), ("data", "model"), "cpu")
    for mesh in MESHES.values():
        with pytest.raises(NotImplementedError, match="item 12"):
            sh.make_constrain(mesh, True)
        with pytest.raises(NotImplementedError, match="item 12"):
            ptrain.make_train_step(get_arch("smollm-135m"), LoRAConfig(),
                                   mesh)
    with pytest.raises(NotImplementedError, match="item 12"):
        sh.fleet_constrainer(FakeMesh(("fleet",), (2,)), 6)
    with pytest.raises(NotImplementedError, match="item 12"):
        sh.placement_errors(MESHES["16x16"], {}, {}, torch.device("cpu"))


def test_specs_allocate_nothing():
    """long_500k's caches and grok-1's params stay on the meta device."""
    cfg = get_arch("zamba2-2.7b")
    s = specs.input_specs(cfg, get_input_shape("long_500k"))
    k = s["caches"]["shared_attn"]["k"]
    assert k.device.type == "meta"
    assert tuple(k.shape)[2] == specs.LONG_CONTEXT_WINDOW
    assert specs.sds((3, 4), torch.bfloat16).device.type == "meta"
