"""Sharded prefill and decode for every family, on the CPU over worlds of
gloo processes, against the JAX package's one-device ``Model.prefill`` and
``Model.decode_step``.

Each rank loads its blocks of the reference's weights (``shard_params``),
prefills its rows of the prompts into its blocks of the caches
(``Model.init_caches`` of the whole batch, by ``rules.cache_specs``), then
takes 4 decode steps fed the reference's greedy tokens. The parent puts the
ranks' blocks back together (``rules.gather_tensor``,
``convert.gather_caches``) and holds them against the reference: the
prefill's logits and caches within 1e-4, every decode step's logits within
1e-4 and its greedy token equal, the caches after the last step within
1e-4. "1x2" and "2x2" run every family (deepseek-7b, olmoe-1b-7b,
rwkv6-7b, zamba2-7b, llama-3.2-vision-90b, whisper-small, and
deepseek-v3-671b for MLA); "1x4" runs deepseek-7b, whose 2 KV heads do
not divide the axis, and deepseek-v3-671b, whose latents are always split
by positions: both caches are split by positions, 4 a rank of 16, and the
decode steps write positions 6 to 9, across the boundary of ranks 1 and
2 (8 of 16 on "1x2" and "2x2": ranks 0 and 1)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.configs.base import RunConfig as JaxRunConfig
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import Model as JaxModel
from repro_torch.configs import MeshConfig, RunConfig, get_arch
from repro_torch.convert import (flatten_tree, gather_caches,
                                 params_from_numpy, shard_caches,
                                 shard_params, unflatten_tree)
from repro_torch.launch.mesh import Mesh, MeshShape
from repro_torch.models.model import Model
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules
from test_torch_parity import world_factory

WORLDS = {"1x2": MeshConfig((1, 2), ("data", "model")),
          "2x2": MeshConfig((2, 2), ("data", "model")),
          "1x4": MeshConfig((1, 4), ("data", "model"))}
ARCHS = {"deepseek-7b": dict(d_model=64, n_layers=2, vocab_size=256),
         "olmoe-1b-7b": dict(n_layers=2),
         "rwkv6-7b": dict(n_layers=2),
         "zamba2-7b": dict(),
         "llama-3.2-vision-90b": dict(),
         "whisper-small": dict(n_layers=2),
         "deepseek-v3-671b": dict(n_layers=2)}
CASES_BY_WORLD = [(arch, w) for w in ("1x2", "2x2") for arch in ARCHS] + \
    [("deepseek-7b", "1x4"), ("deepseek-v3-671b", "1x4")]
RUN = dict(attn_impl="full", remat="nothing", compute_dtype="float32")
B, PROMPT, MAX_LEN, STEPS = 4, 6, 16, 4
TOL = 1e-4


def configs(arch):
    over = ARCHS[arch]
    jcfg, tcfg = jax_arch(arch).reduced(**over), get_arch(arch).reduced(**over)
    if jcfg.moe is not None:
        # ample capacity: the expert-parallel paths drop nothing, as the
        # reference's one-device moe_dense drops nothing
        cap = float(jcfg.moe.n_experts)
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cap))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cap))
    return jcfg, tcfg


def _rows(mesh, v):
    """This rank's rows of a whole batch leaf (split over the batch
    axes)."""
    t = torch.as_tensor(v)
    return rules.shard_tensor(t, rules.batch_spec(mesh, t.dim()),
                              mesh).contiguous()


def _numpy(tree):
    return {path: t.detach().numpy().copy()
            for path, t in flatten_tree(tree).items()}


def case_serve(mesh, cfg, run, params, prompt, steps, max_len):
    """Prefill this rank's rows of `prompt` into its blocks of the caches,
    then one decode step a batch of `steps`: the logits blocks, the caches
    after the prefill and after the last step, and the collectives' counts
    of the decode steps."""
    model = Model(cfg, run, "cpu", mesh)
    params_from_numpy(shard_params(params, model.specs, mesh), model)
    lg, caches = model.prefill({k: _rows(mesh, v) for k, v in prompt.items()},
                               max_len)
    out = {"prefill": lg.numpy(), "caches_prefill": _numpy(caches),
           "decode": []}
    C.reset_stats()
    for batch in steps:
        lg, caches = model.decode_step(
            {k: _rows(mesh, v) for k, v in batch.items()}, caches)
        out["decode"].append(lg.numpy())
    out["caches"] = _numpy(caches)
    out["collectives"] = C.stats()
    return out


CASES = {"serve": case_serve}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    yield from world_factory(tmp_path_factory, WORLDS, __name__)


_REFS = {}


def jax_serving_reference(arch):
    """(params, prompt, steps, prefill logits, caches, [decode logits],
    caches after the last step) of the reference on one device, numpy
    trees: the vlm's tanh gates set to 0.5 and its media random, whisper's
    frames random and its decode steps fed the encoder's output; each
    decode step fed the greedy token of the logits before it."""
    if arch in _REFS:
        return _REFS[arch]
    jcfg, _ = configs(arch)
    model = JaxModel(jcfg, JaxRunConfig(**RUN))
    params = model.init(jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        cross = params["layers"]["cross"]["attn"]
        cross["gate"] = jnp.full_like(cross["gate"], 0.5)
    rng = np.random.default_rng(1)
    prompt = {"tokens": rng.integers(0, jcfg.vocab_size, (B, PROMPT))
              .astype(np.int32)}
    extra = {}
    if jcfg.family == "vlm":
        extra["media"] = rng.standard_normal(
            (B, jcfg.cross_attn.n_media_tokens, jcfg.d_model),
            dtype=np.float32)
        prompt["media"] = extra["media"]
    if jcfg.family == "audio":
        prompt["frames"] = rng.standard_normal(
            (B, jcfg.encdec.enc_len, jcfg.d_model), dtype=np.float32)
        frames = jnp.asarray(prompt["frames"])
        enc = frames + JT._sinusoid(frames.shape[1], jcfg.d_model,
                                    frames.dtype)
        enc, _ = JT.stack(params["layers"]["enc"], enc, jcfg, model.run,
                          kind="dense", positions=jnp.arange(enc.shape[1]),
                          causal=False)
        extra["enc_out"] = np.asarray(JL.rms_norm(
            enc, params["layers"]["enc_ln"], jcfg.norm_eps))
    lg, caches = model.prefill(params, {k: jnp.asarray(v) for k, v in
                                        prompt.items()}, MAX_LEN)
    prefill = np.asarray(lg)
    caches0 = flatten_tree(jax.tree.map(np.asarray, caches))
    steps, logits = [], []
    for _ in range(STEPS):
        tok = np.argmax(np.asarray(lg)[:, -1, :jcfg.vocab_size], -1)
        batch = {"tokens": tok[:, None].astype(np.int32), **extra}
        steps.append(batch)
        lg, caches = model.decode_step(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, caches)
        logits.append(np.asarray(lg))
    _REFS[arch] = (jax.tree.map(np.asarray, params), prompt, steps, prefill,
                   caches0, logits,
                   flatten_tree(jax.tree.map(np.asarray, caches)))
    return _REFS[arch]


def _assert_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err < TOL, (what, err)


@pytest.mark.parametrize("arch,world_name", CASES_BY_WORLD)
def test_sharded_prefill_and_decode_match_the_one_device_reference(
        worlds, arch, world_name):
    params, prompt, steps, prefill, caches0, logits, caches = \
        jax_serving_reference(arch)
    _, tcfg = configs(arch)
    run = RunConfig(**RUN)
    results = worlds(world_name).run("serve", cfg=tcfg, run=run,
                                     params=params, prompt=prompt,
                                     steps=steps, max_len=MAX_LEN)
    shape = MeshShape(WORLDS[world_name])
    meta = Model(tcfg, run, "meta", shape)
    specs = meta.cache_specs(B, MAX_LEN)
    lspec = (rules.batch_spec(shape, 1)[0], None,
             "model" if meta.vocab_split else None)

    def gathered(key, i=None):
        blocks = [r[key] if i is None else r[key][i] for r in results]
        return rules.gather_tensor(blocks, lspec, shape)

    # each rank holds exactly the blocks the cache specs give it
    whole = flatten_tree(Model(tcfg, run, "meta").init_caches(B, MAX_LEN))
    for res in results:
        for path, block in res["caches"].items():
            want = rules.local_shape(whole[path].shape,
                                     flatten_tree(specs)[path], shape)
            assert block.shape == want, (path, block.shape, want)
    _assert_close(gathered("prefill"), prefill, "prefill logits")
    for when, ref in (("caches_prefill", caches0), ("caches", caches)):
        got = flatten_tree(gather_caches(
            [unflatten_tree(r[when]) for r in results], specs, shape))
        assert set(got) == set(ref)
        for path, want in ref.items():
            _assert_close(got[path], want, f"{when} {path}")
    V = tcfg.vocab_size
    for i, want in enumerate(logits):
        got = gathered("decode", i)
        _assert_close(got, want, f"decode step {i}")
        np.testing.assert_array_equal(np.argmax(got[:, -1, :V], -1),
                                      np.argmax(want[:, -1, :V], -1))
    stats = results[0]["collectives"]
    assert stats["all_reduce"]["calls"] > 0
    if world_name == "1x4":
        # flash decoding over the mesh: the partial maxima and the sums
        assert stats["all_gather"]["calls"] > 0


def test_a_rank_alone_serves_with_the_shapes_of_its_peers():
    """Rank 0 of "1x4" run alone (its collectives return zeros) builds the
    same blocks of the caches, and its prefill and decode step run with
    them and hand back logits of the shape its peers' have."""
    _, tcfg = configs("deepseek-v3-671b")
    run = RunConfig(**RUN)
    mesh = Mesh.alone(WORLDS["1x4"], 0, "cpu")
    model = Model(tcfg, run, "cpu", mesh).init(seed=0)
    prompt = {"tokens": np.zeros((B, PROMPT), np.int32)}
    lg, caches = model.prefill(prompt, MAX_LEN)
    want = flatten_tree(model.init_caches(B, MAX_LEN))
    assert {k: tuple(v.shape) for k, v in flatten_tree(caches).items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    lg2, _ = model.decode_step({"tokens": np.zeros((B, 1), np.int32)},
                               caches)
    assert lg.shape == lg2.shape == (B, 1, model.padded_vocab // 4)


@pytest.mark.parametrize("world_name", ["1x2", "2x2", "1x4"])
def test_shard_and_gather_caches_are_inverses(world_name):
    """``convert.shard_caches`` cuts a whole cache tree into each rank's
    blocks and ``convert.gather_caches`` puts them back, bit for bit."""
    _, tcfg = configs("deepseek-v3-671b")
    shape = MeshShape(WORLDS[world_name])
    model = Model(tcfg, RunConfig(**RUN), "meta", shape)
    specs = model.cache_specs(B, MAX_LEN)
    whole = Model(tcfg, RunConfig(**RUN), "meta").init_caches(B, MAX_LEN)
    rng = np.random.default_rng(0)
    whole = {k: {n: rng.standard_normal(t.shape).astype(np.float32)
                 for n, t in v.items()} for k, v in whole.items()}
    blocks = [shard_caches(whole, specs, Mesh.alone(WORLDS[world_name], r,
                                                    "cpu"))
              for r in range(shape.config.n_devices)]
    back = gather_caches(blocks, specs, shape)
    for path, want in flatten_tree(whole).items():
        np.testing.assert_array_equal(flatten_tree(back)[path], want)


@pytest.mark.parametrize("max_len", [6, 14])
def test_a_cache_split_by_positions_must_divide(max_len):
    """Over "1x4", deepseek-7b's caches are split by positions (its 2 KV
    heads do not divide the axis): a length that does not divide by 4
    raises, as the rules would leave the cache whole."""
    _, tcfg = configs("deepseek-7b")
    model = Model(tcfg, RunConfig(**RUN), "meta",
                  MeshShape(WORLDS["1x4"]))
    with pytest.raises(ValueError, match="positions"):
        model.cache_specs(B, max_len)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-7b"])
def test_the_planner_profiles_one_rank_of_a_serving_job(monkeypatch, arch,
                                                        mode):
    """plan(..., profile_mesh=) of a prefill or decode shape profiles each
    depth as rank 0 of the mesh run alone and multiplies the per-rank
    prediction by the mesh's devices; build_step runs that rank's step, on
    its blocks of the weights and of the caches of the whole batch."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import hbm_planner as H
    from repro_torch.launch import dryrun
    _, cfg = configs(arch)
    shape = ShapeConfig(f"{mode}_16", 16, 4, mode)
    mesh_cfg = WORLDS["2x2"]
    seen = []

    def fake_build_step(cfg_, shape_, run_, device_, mesh=None):
        seen.append((shape_.mode, mesh))
        return lambda: None

    class FakeProfiler:
        def profile(self, job, size, device=None):
            job()
            from repro_torch.core.profiler import ProfileResult
            return ProfileResult(size, 1e9 + 3e8 * size, 0.0, 0.0)

    monkeypatch.setattr(H, "build_step", fake_build_step)
    monkeypatch.setattr(H, "CUDAMemoryProfiler", FakeProfiler)
    rep = H.HBMPlanner().plan(cfg, shape, device="cpu", profile_mesh=mesh_cfg)
    assert all(m == mode and mesh.transport == "alone" and mesh.rank == 0 and
               mesh.config == mesh_cfg for m, mesh in seen)
    assert rep.profile_mesh_devices == 4
    assert abs(rep.requirement_gib - 4 * rep.predicted_per_dev_gib) < 1e-9
    mesh = Mesh.alone(mesh_cfg, 0, "cpu")
    lg, caches = dryrun.build_step(cfg, shape, RunConfig(**RUN), "cpu",
                                   mesh=mesh)()
    model = Model(cfg, RunConfig(**RUN), "meta", mesh)
    assert lg.shape[0] == 2                     # the rank's rows of 4
    assert {k: tuple(v.shape) for k, v in flatten_tree(caches).items()} == \
        {k: tuple(v.shape) for k, v in
         flatten_tree(model.init_caches(4, 16)).items()}
