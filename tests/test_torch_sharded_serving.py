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
2 (8 of 16 on "1x2" and "2x2": ranks 0 and 1).

The layouts beside those: an int8 cache (deepseek-7b on "1x4", split by
positions, and on "2x2", by KV heads), the prefill's caches quantized by
each package's ``quantize_kv`` before the decode steps, held to
``tests/test_torch_int8_kv.py``'s bound on the logits; caches of 6 and 14
positions over "1x4", which divide neither by the KV heads nor by the
positions and stay whole on every rank (deepseek-7b's KV cache and
deepseek-v3-671b's latents); and olmoe-1b-7b with MoE impl "dense" over
"1x2" and "2x2", whose experts split over 'model'."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.configs.base import RunConfig as JaxRunConfig
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import Model as JaxModel
from repro.sharding import rules as jax_rules
from repro_torch.configs import MeshConfig, RunConfig, get_arch
from repro_torch.convert import (flatten_tree, gather_caches,
                                 params_from_numpy, shard_caches,
                                 shard_params, unflatten_tree)
from repro_torch.launch.mesh import Mesh, MeshShape
from repro_torch.models import attention as A
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
# a variant of an arch: (arch, fields of its MoEConfig)
VARIANTS = {"olmoe-1b-7b-dense": ("olmoe-1b-7b", dict(impl="dense"))}
CASES_BY_WORLD = [(arch, w) for w in ("1x2", "2x2") for arch in ARCHS] + \
    [("deepseek-7b", "1x4"), ("deepseek-v3-671b", "1x4")] + \
    [("olmoe-1b-7b-dense", w) for w in ("1x2", "2x2")]
RUN = dict(attn_impl="full", remat="nothing", compute_dtype="float32")
B, PROMPT, MAX_LEN, STEPS = 4, 6, 16, 4
TOL = 1e-4
WHOLE_TOL = 1e-5                # a cache whole on every rank, float32
LOGITS_INT8 = dict(atol=1e-3, rtol=1e-3)     # tests/test_torch_int8_kv.py's


def configs(arch):
    arch, moe_over = VARIANTS.get(arch, (arch, {}))
    over = ARCHS[arch]
    jcfg, tcfg = jax_arch(arch).reduced(**over), get_arch(arch).reduced(**over)
    if moe_over:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe_over))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, **moe_over))
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
    """The leaves as numpy arrays; bfloat16 (an int8 cache's scales) as
    float32."""
    return {path: (t.float() if t.dtype == torch.bfloat16 else t)
            .detach().numpy().copy() for path, t in flatten_tree(tree).items()}


def case_serve(mesh, cfg, run, params, prompt, steps, max_len, quant=False):
    """Prefill this rank's rows of `prompt` into its blocks of the caches
    (`quant`: then quantized to int8, ``quantize_caches``), then one decode
    step a batch of `steps`: the logits blocks, the caches after the
    prefill and after the last step, and the collectives' counts of the
    decode steps."""
    model = Model(cfg, run, "cpu", mesh)
    params_from_numpy(shard_params(params, model.specs, mesh), model)
    lg, caches = model.prefill({k: _rows(mesh, v) for k, v in prompt.items()},
                               max_len)
    out = {"prefill": lg.numpy(), "caches_prefill": _numpy(caches),
           "decode": []}
    if quant:
        caches = A.quantize_caches(caches)
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


def jax_quantized(caches):
    """The reference's cache tree with each k and v quantized by its
    quantize_kv (``attention.quantize_caches``'s counterpart)."""
    if "k" not in caches:
        return {name: jax_quantized(t) if isinstance(t, dict) else t
                for name, t in caches.items()}
    out = dict(caches)
    for name in ("k", "v"):
        out[name], out[name + "_scale"] = JA.quantize_kv(caches[name])
    return out


def jax_serving_reference(arch, max_len=MAX_LEN, prompt_len=PROMPT,
                          quant=False):
    """(params, prompt, steps, prefill logits, caches, [decode logits],
    caches after the last step) of the reference on one device, numpy
    trees: the vlm's tanh gates set to 0.5 and its media random, whisper's
    frames random and its decode steps fed the encoder's output; each
    decode step fed the greedy token of the logits before it. With
    `quant`, the prefill's caches are quantized to int8 (``jax_quantized``)
    and the decode steps take the int8 branch."""
    key = (arch, max_len, prompt_len, quant)
    if key in _REFS:
        return _REFS[key]
    jcfg, _ = configs(arch)
    model = JaxModel(jcfg, JaxRunConfig(**RUN))
    params = model.init(jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        cross = params["layers"]["cross"]["attn"]
        cross["gate"] = jnp.full_like(cross["gate"], 0.5)
    rng = np.random.default_rng(1)
    prompt = {"tokens": rng.integers(0, jcfg.vocab_size, (B, prompt_len))
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
                                        prompt.items()}, max_len)
    prefill = np.asarray(lg)
    caches0 = flatten_tree(jax.tree.map(np.asarray, caches))
    if quant:
        caches = jax_quantized(caches)
    steps, logits = [], []
    for _ in range(STEPS):
        tok = np.argmax(np.asarray(lg)[:, -1, :jcfg.vocab_size], -1)
        batch = {"tokens": tok[:, None].astype(np.int32), **extra}
        steps.append(batch)
        lg, caches = model.decode_step(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, caches)
        logits.append(np.asarray(lg))
    _REFS[key] = (jax.tree.map(np.asarray, params), prompt, steps, prefill,
                  caches0, logits,
                  flatten_tree(jax.tree.map(np.asarray, caches)))
    return _REFS[key]


def _assert_close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err < tol, (what, err)


def _assert_int8_close(got, want, what):
    """int8 values at most one step apart, scales one bfloat16 step (where
    the two packages' float32 k or v differ in their last bit at a
    rounding boundary), the rest to TOL."""
    if want.dtype == np.int8:
        assert got.dtype == np.int8, what
        assert int(np.abs(got.astype(np.int32) - want.astype(np.int32))
                   .max()) <= 1, what
    elif what.endswith("_scale"):
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32), atol=0,
                                   rtol=2 ** -7, err_msg=what)
    else:
        _assert_close(got, want, what)


def serve_and_check(worlds, arch, world_name, max_len=MAX_LEN,
                    prompt_len=PROMPT, quant=False, tol=TOL):
    """Run the serve case on `world_name` and hold it against the
    reference's: each rank's blocks shaped as the cache specs give them,
    the gathered prefill logits and caches, every decode step's logits
    and greedy token, the caches after the last step (within `tol`; an
    int8 cache's decode logits within LOGITS_INT8). Returns (the ranks'
    results, the cache specs)."""
    params, prompt, steps, prefill, caches0, logits, caches = \
        jax_serving_reference(arch, max_len, prompt_len, quant)
    _, tcfg = configs(arch)
    run = RunConfig(**RUN)
    results = worlds(world_name).run("serve", cfg=tcfg, run=run,
                                     params=params, prompt=prompt,
                                     steps=steps, max_len=max_len,
                                     quant=quant)
    shape = MeshShape(WORLDS[world_name])
    meta = Model(tcfg, run, "meta", shape)
    specs = meta.cache_specs(B, max_len, quant)
    lspec = (rules.batch_spec(shape, 1)[0], None,
             "model" if meta.vocab_split else None)

    def gathered(key, i=None):
        blocks = [r[key] if i is None else r[key][i] for r in results]
        return rules.gather_tensor(blocks, lspec, shape)

    # each rank holds exactly the blocks the cache specs give it
    whole = flatten_tree(Model(tcfg, run, "meta").init_caches(B, max_len,
                                                              quant=quant))
    for res in results:
        for path, block in res["caches"].items():
            want = rules.local_shape(whole[path].shape,
                                     flatten_tree(specs)[path], shape)
            assert block.shape == want, (path, block.shape, want)
    _assert_close(gathered("prefill"), prefill, "prefill logits", tol)
    pspecs = meta.cache_specs(B, max_len, False)
    for when, ref, sp in (("caches_prefill", caches0, pspecs),
                          ("caches", caches, specs)):
        got = flatten_tree(gather_caches(
            [unflatten_tree(r[when]) for r in results], sp, shape))
        assert set(got) == set(ref)
        for path, want in ref.items():
            if quant:
                _assert_int8_close(got[path], want, f"{when} {path}")
            else:
                _assert_close(got[path], want, f"{when} {path}", tol)
    V = tcfg.vocab_size
    for i, want in enumerate(logits):
        got = gathered("decode", i)
        if quant:
            np.testing.assert_allclose(got, want, **LOGITS_INT8)
        else:
            _assert_close(got, want, f"decode step {i}", tol)
        np.testing.assert_array_equal(np.argmax(got[:, -1, :V], -1),
                                      np.argmax(want[:, -1, :V], -1))
    return results, specs


@pytest.mark.parametrize("arch,world_name", CASES_BY_WORLD)
def test_sharded_prefill_and_decode_match_the_one_device_reference(
        worlds, arch, world_name):
    results, _ = serve_and_check(worlds, arch, world_name)
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


def _assert_whole_on_every_rank(results, specs, max_len):
    """Every KV or latent cache of the ranks holds all `max_len` positions
    (the specs name no axis for them), and the ranks' copies are equal."""
    for path, spec in flatten_tree(specs).items():
        name = path.rsplit(".", 1)[-1]
        if name not in ("k", "v", "ckv", "kr"):
            continue
        assert "model" not in rules.spec_axes(spec), (path, spec)
        blocks = [r["caches"][path] for r in results]
        assert all(b.shape[-3 if name in ("k", "v") else -2] == max_len
                   for b in blocks), path
        for b in blocks[1:]:
            np.testing.assert_array_equal(b, blocks[0], err_msg=path)


def _cache_specs_equal_the_references(arch, world_name, max_len):
    """``Model.cache_specs`` equal to the reference's ``cache_specs`` on
    the same caches and mesh."""
    jcfg, tcfg = configs(arch)
    cfg = WORLDS[world_name]
    duck = SimpleNamespace(shape=dict(zip(cfg.axes, cfg.shape)),
                           axis_names=tuple(cfg.axes))
    jrun = JaxRunConfig(**RUN)
    jcache = jax.eval_shape(lambda: JaxModel(jcfg, jrun).init_caches(
        B, max_len))
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    want = {".".join(str(p.key) for p in path): tuple(spec)
            for path, spec in jax.tree_util.tree_leaves_with_path(
                jax_rules.cache_specs(jcache, duck, jrun, B),
                is_leaf=is_spec)}
    got = Model(tcfg, RunConfig(**RUN), "meta",
                MeshShape(cfg)).cache_specs(B, max_len)
    assert {k: tuple(v) for k, v in flatten_tree(got).items()} == want


@pytest.mark.parametrize("max_len", [6, 14])
def test_a_cache_split_by_positions_must_divide(worlds, max_len):
    """Over "1x4", deepseek-7b's 2 KV heads do not divide the axis, and
    caches of 6 or 14 positions do not either: the rules leave the cache
    whole on every rank, as the reference's do (``Model.cache_specs``
    equal to its ``cache_specs``). Each rank writes every KV head at every
    position and decodes its own query heads against the KV heads they
    read, with no collective in the attention: the prefill's and every
    decode step's logits within 1e-5 of the reference's, greedy tokens
    equal, the caches whole on every rank and equal across them."""
    _cache_specs_equal_the_references("deepseek-7b", "1x4", max_len)
    prompt_len = min(PROMPT, max_len - STEPS)
    results, specs = serve_and_check(worlds, "deepseek-7b", "1x4", max_len,
                                     prompt_len, tol=WHOLE_TOL)
    _assert_whole_on_every_rank(results, specs, max_len)


@pytest.mark.parametrize("max_len", [6, 14])
def test_mla_latents_whose_positions_do_not_divide_stay_whole(worlds,
                                                               max_len):
    """deepseek-v3-671b's latents over "1x4" at 6 or 14 positions: whole
    on every rank, as the reference's rules leave them; the prefill and
    the decode steps against the reference's, the caches equal across the
    ranks."""
    _cache_specs_equal_the_references("deepseek-v3-671b", "1x4", max_len)
    prompt_len = min(PROMPT, max_len - STEPS)
    results, specs = serve_and_check(worlds, "deepseek-v3-671b", "1x4",
                                     max_len, prompt_len, tol=WHOLE_TOL)
    _assert_whole_on_every_rank(results, specs, max_len)


@pytest.mark.parametrize("world_name", ["1x4", "2x2"])
def test_an_int8_cache_serves_over_the_mesh(worlds, world_name):
    """deepseek-7b's prefill caches quantized to int8 in both packages,
    then the decode steps: on "1x4" the cache is split by positions (its 2
    KV heads do not divide the axis) and each rank dequantizes its block
    and combines the partial softmaxes; on "2x2" it is split by KV heads.
    Logits within the one-device int8 path's bound, greedy tokens equal,
    the int8 values within one step and the scales within one bfloat16
    step of the reference's."""
    results, specs = serve_and_check(worlds, "deepseek-7b", world_name,
                                     quant=True)
    assert all(results[0]["caches"][name].dtype == np.int8
               for name in ("k", "v"))
    assert specs["k_scale"] == specs["k"]
    # (L, B, S, K, D): split by positions on "1x4", by KV heads on "2x2"
    assert specs["k"][2 if world_name == "1x4" else 3] == "model"


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
