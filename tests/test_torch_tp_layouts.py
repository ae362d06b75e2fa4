"""Tensor parallelism of the four layouts that split over 'model' in their
own way, on the CPU over worlds of gloo processes, against the JAX package
on one device: rwkv6-7b (its heads, wo split on the layer axis and moved a
layer at a time, or replicated where the layers do not divide the axis),
zamba2-7b (Mamba2's in_proj and conv split in column blocks that cross the
heads, the gated norm over the whole row), whisper-small (encoder,
decoder and cross-attention on heads) and deepseek-v3-671b (MLA on heads,
the latents whole, the experts split).

For each: the sharded forward's logits against the reference's one-device
forward, and two train steps (warmup 1, the second at lr 1e-2) against
``jax_train_reference`` with its gates (``run_train``), on "1x2", and on
"1x4" for rwkv6-7b and zamba2-7b."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JaxRunConfig
from repro.models.model import Model as JaxModel
from repro_torch.configs import MeshConfig, RunConfig
from repro_torch.convert import flatten_tree, params_from_numpy, shard_params
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.model import Model
from repro_torch.sharding import rules
from test_torch_distribution import (RUN, TOL, case_train_step, configs,
                                     jax_train_reference, run_train)
from test_torch_parity import world_factory

WORLDS = {"1x2": MeshConfig((1, 2), ("data", "model")),
          "1x4": MeshConfig((1, 4), ("data", "model"))}
CASES_BY_WORLD = [(arch, "1x2") for arch in
                  ("rwkv6-7b", "zamba2-7b", "whisper-small",
                   "deepseek-v3-671b")] + \
    [("rwkv6-7b", "1x4"), ("zamba2-7b", "1x4")]


def case_forward(mesh, cfg, run, params, batch):
    """This rank's block of the logits of the whole batch's forward (the
    batch cut to this rank's rows), and the shapes of its parameters."""
    model = Model(cfg, run, "cpu", mesh)
    params_from_numpy(shard_params(params, model.specs, mesh), model)
    local = {k: rules.shard_tensor(torch.as_tensor(v), rules.batch_spec(
        mesh, np.ndim(v)), mesh) for k, v in batch.items() if k != "labels"}
    return {"logits": model.forward(local).numpy(),
            "shapes": {k: tuple(v.shape)
                       for k, v in model.state_dict().items()}}


CASES = {"forward": case_forward, "train_step": case_train_step}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    yield from world_factory(tmp_path_factory, WORLDS, __name__)


@pytest.mark.parametrize("arch,world_name", CASES_BY_WORLD)
def test_sharded_forward_matches_the_one_device_reference(worlds, arch,
                                                          world_name):
    """Each rank holds exactly the blocks ``rules.param_specs`` gives it,
    and its block of the logits is the reference's within 1e-4."""
    params, batch, *_ = jax_train_reference(arch)
    jcfg, tcfg = configs(arch)
    want = np.asarray(JaxModel(jcfg, JaxRunConfig(**RUN)).forward(
        params, {k: jnp.asarray(v) for k, v in batch.items()
                 if k != "labels"})[0])
    run = RunConfig(**RUN)
    results = worlds(world_name).run("forward", cfg=tcfg, run=run,
                                     params=params, batch=batch)
    shape = MeshShape(WORLDS[world_name])
    meta = Model(tcfg, run, "meta", shape)
    spec = (rules.batch_spec(shape, 1)[0], None,
            "model" if meta.vocab_split else None)
    for rank, res in enumerate(results):
        coords = shape.coords_of(rank)
        full = flatten_tree(meta.full_shapes)
        want_shapes = {path: rules.local_shape(full[path], s, shape)
                       for path, s in flatten_tree(meta.specs).items()}
        assert res["shapes"] == want_shapes
        ref = rules.shard_tensor(want, spec, shape, coords=coords)
        assert res["logits"].shape == ref.shape
        err = float(np.max(np.abs(res["logits"] - ref)))
        assert err < TOL, (arch, world_name, rank, err)


@pytest.mark.parametrize("arch,world_name", CASES_BY_WORLD)
def test_sharded_train_steps_match_the_one_device_reference(worlds, arch,
                                                            world_name):
    """Two steps: the loss, the parameters where settled and the moments
    of every rank's blocks within 1e-4 of the reference's; the layers'
    collectives ran over 'model'."""
    results = run_train(worlds, world_name, arch)
    stats = results[0]["collectives"]
    assert stats["all_reduce"]["calls"] > 0
    if arch == "zamba2-7b":
        # in_proj's, the conv's and the gated norm's all-gathers
        assert stats["all_gather"]["calls"] > 0
    if arch == "rwkv6-7b" and world_name == "1x2":
        # wo split on its layer axis: each layer's rows moved from the
        # owner by a reduce-scatter
        assert stats["reduce_scatter"]["calls"] > 0
