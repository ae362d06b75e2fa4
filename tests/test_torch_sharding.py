"""The port's sharding rules against the JAX package's: param, optimizer
state and cache specs of all ten architectures at full size (shapes
only), on three meshes, under every combination of the FSDP and ZeRO-1
flags; the blocks of a rank (local_shape, shard_tensor, gather_tensor)."""
import itertools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import RunConfig as JaxRunConfig
from repro.models.model import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_adamw as jax_init_adamw
from repro.sharding import rules as jax_rules
from repro_torch.configs import ARCHS, MeshConfig, RunConfig
from repro_torch.launch.mesh import (Mesh, MeshShape, make_production_mesh,
                                     mesh_config)
from repro_torch.models.model import Model
from repro_torch.optim import OptState
from repro_torch.sharding import rules

MESHES = [MeshConfig((2, 4), ("data", "model")),
          MeshConfig((16, 16), ("data", "model")),
          MeshConfig((2, 16, 16), ("pod", "data", "model"))]
FLAGS = [dict(zip(("fsdp_params", "fsdp_experts", "zero1"), bits))
         for bits in itertools.product((False, True), repeat=3)]


def duck(cfg: MeshConfig):
    """The JAX side's mesh: a shape dict and axis names, no devices."""
    return SimpleNamespace(shape=dict(zip(cfg.axes, cfg.shape)),
                           axis_names=tuple(cfg.axes))


def flat_jax(tree):
    out = {}
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    for path, spec in jax.tree_util.tree_leaves_with_path(tree,
                                                          is_leaf=is_spec):
        key = ".".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        out[key] = tuple(spec)
    return out


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v)
    return out


def jax_shapes(arch, dtype="float32"):
    model = JaxModel(JAX_ARCHS[arch], JaxRunConfig(param_dtype=dtype))
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def shapes():
    """Full-size parameter shapes of each architecture, both packages."""
    return {arch: (jax_shapes(arch),
                   Model(cfg, RunConfig(), device="meta")._param_shapes())
            for arch, cfg in ARCHS.items()}


@pytest.mark.parametrize("mesh_cfg", MESHES, ids=lambda m: "x".join(
    map(str, m.shape)))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_opt_state_specs_equal_the_references(shapes, arch,
                                                        mesh_cfg):
    jp, tp = shapes[arch]
    mesh = duck(mesh_cfg)
    port_mesh = MeshShape(mesh_cfg)
    jopt = jax.eval_shape(lambda: jax_init_adamw(jp, JaxAdamWConfig()))
    for flags in FLAGS:
        jrun, trun = JaxRunConfig(**flags), RunConfig(**flags)
        js = jax_rules.param_specs(jp, mesh, jrun)
        ts = rules.param_specs(tp, port_mesh, trun)
        assert flat(ts) == flat_jax(js), (arch, flags)
        jo = jax_rules.opt_state_specs(jopt, js, jp, mesh, jrun)
        for master in (None, True):
            to = rules.opt_state_specs(OptState(None, None, None, master),
                                       ts, tp, port_mesh, trun)
            assert to.step == tuple(jo.step) == ()
            for field in ("m", "v"):
                assert flat(getattr(to, field)) == \
                    flat_jax(getattr(jo, field)), (arch, flags, field)
            if master:
                assert flat(to.master) == flat_jax(jo.m), (arch, flags)
            else:
                assert to.master is None


@pytest.mark.parametrize("mesh_cfg", MESHES, ids=lambda m: "x".join(
    map(str, m.shape)))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_the_references(arch, mesh_cfg):
    cfg = ARCHS[arch]
    B, S = 64, 256
    mesh = duck(mesh_cfg)
    for quant in (False, True):
        if quant and (cfg.family == "ssm" or cfg.attention_kind == "mla"):
            continue            # no int8 cache for these
        jrun = JaxRunConfig(kv_cache_dtype="int8" if quant else "compute")
        jcache = jax.eval_shape(
            lambda: JaxModel(JAX_ARCHS[arch], jrun).init_caches(B, S))
        tcache = Model(cfg, RunConfig(), device="meta").init_caches(
            B, S, device="meta", quant=quant)
        for gb in (B, 3):
            assert flat(rules.cache_specs(tcache, MeshShape(mesh_cfg),
                                          RunConfig(), gb)) == \
                flat_jax(jax_rules.cache_specs(jcache, mesh, jrun, gb))


@pytest.mark.parametrize("mesh_cfg", MESHES + [MeshConfig((4,), ("pipe",))],
                         ids=lambda m: "x".join(map(str, m.shape)))
def test_batch_spec_and_no_mesh(mesh_cfg):
    for ndim in (1, 2, 3):
        assert rules.batch_spec(MeshShape(mesh_cfg), ndim) == \
            tuple(jax_rules.batch_spec(duck(mesh_cfg), ndim))
    assert rules.batch_spec(None) == ()
    tree = {"a": np.zeros((4, 4)), "b": {"wq": np.zeros((2, 4, 2))}}
    assert flat(rules.param_specs(tree, None, RunConfig())) == \
        {"a": (), "b.wq": ()}


def test_chatglm_kv_heads_fall_back_to_replicated():
    """The reference's divisibility fallback (tests/test_distribution.py):
    32 query heads split over a 4-way model axis, 2 KV heads replicated."""
    tp = Model(ARCHS["chatglm3-6b"], RunConfig(), device="meta")
    specs = rules.param_specs(tp._param_shapes(),
                              MeshShape(MeshConfig((2, 4), ("data", "model"))),
                              RunConfig())
    assert specs["layers"]["attn"]["wq"] == (None, None, "model", None)
    assert specs["layers"]["attn"]["wk"] == (None, None, None, None)


def test_production_mesh_and_mesh_config():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")
    assert mesh_config(multi) == MeshConfig((2, 16, 16),
                                            ("pod", "data", "model"))


@pytest.mark.parametrize("spec", [("model", None), (None, "data"),
                                  (("data", "model"), None),
                                  (("model", "data"), None), ("data", "model"),
                                  ("model", "data"), ()])
def test_shard_and_gather_round_trip(spec):
    cfg = MeshConfig((2, 4), ("data", "model"))
    full = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    shape = MeshShape(cfg)
    blocks = [rules.shard_tensor(full, spec, shape,
                                 coords=shape.coords_of(r))
              for r in range(cfg.n_devices)]
    assert all(b.shape == rules.local_shape(full.shape, spec, MeshShape(cfg))
               for b in blocks)
    np.testing.assert_array_equal(
        rules.gather_tensor(blocks, spec, MeshShape(cfg)), full)
    tblocks = [rules.shard_tensor(torch.from_numpy(full), spec, shape,
                                  coords=shape.coords_of(r))
               for r in range(cfg.n_devices)]
    assert torch.equal(rules.gather_tensor(tblocks, spec, MeshShape(cfg)),
                       torch.from_numpy(full))


def test_mesh_coordinates_are_row_major():
    cfg = MeshConfig((2, 2, 2), ("pod", "data", "model"))
    shape = MeshShape(cfg)
    coords = [shape.coords_of(r) for r in range(8)]
    assert coords[5] == {"pod": 1, "data": 0, "model": 1}
    assert shape.index_of(("pod", "data"), 5) == 2
    assert shape.ranks_along("data", 5) == (5, 7)
    assert shape.ranks_along(("pod", "data"), 5) == (1, 3, 5, 7)
    # a rank's mesh reads its own coordinates from the same place
    mesh = Mesh.alone(cfg, 5, "cpu")
    assert mesh.coords == coords[5]
    assert mesh.index(("pod", "data")) == 2
    assert mesh.axis_ranks(("pod", "data")) == (1, 3, 5, 7)
    assert mesh.size(("data", "model")) == 4
    full = np.arange(16.0).reshape(4, 4)
    assert rules.shard_tensor(full, ("data", "model"), mesh).tolist() == \
        [[2.0, 3.0], [6.0, 7.0]]
    # `base`: a block already split over data is cut over model only
    rows = rules.shard_tensor(full, ("data",), mesh)
    assert rules.shard_tensor(rows, ("data", "model"), mesh,
                              base=("data",)).tolist() == \
        [[2.0, 3.0], [6.0, 7.0]]
