"""The port's multi-device machinery on the CPU, over worlds of gloo
processes, against the JAX package on one device: sharded train steps
(tensor, data and expert parallelism, ZeRO-1), the replicated KV heads of
the divisibility fallback, moe_ep and moe_ep_a2a, the GPipe pipeline, the
elastic restore, global_norm over a mesh, the rank-alone transport, and
MoE impl "dense" over a 'model' axis (the reference's ``moe_dense`` over
each rank's block of the experts).

Each world (``test_torch_parity.World``) is started once for the module
and given several cases."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.configs.base import RunConfig as JaxRunConfig
from repro.models import moe as JM
from repro.models.model import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_adamw as jax_init_adamw
from repro.train.step import TrainState as JaxTrainState
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import ckpt
from repro_torch.configs import MeshConfig, RunConfig, get_arch
from repro_torch.convert import flatten_tree, params_from_numpy, shard_params
from repro_torch.launch.mesh import Mesh, MeshShape
from repro_torch.models import moe as M
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import global_norm, leaves
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules
from repro_torch.sharding.pipeline import pipeline_apply
from repro_torch.train.step import (init_train_state, make_train_step,
                                    state_specs)
from test_torch_parity import world_factory

WORLDS = {"1x2": MeshConfig((1, 2), ("data", "model")),
          "2x1": MeshConfig((2, 1), ("data", "model")),
          "2x2": MeshConfig((2, 2), ("data", "model")),
          "1x4": MeshConfig((1, 4), ("data", "model")),
          "pipe4": MeshConfig((4,), ("pipe",))}
RUN = dict(attn_impl="full", remat="nothing", compute_dtype="float32")
LR = 1e-2
# Two steps on one batch, the schedule's warmup 1 step: the first runs at
# lr 0 (the warmup's scale at step 0) and fills the moments; the second
# moves the parameters by about LR, so that a step that moves none, or a
# block that the ZeRO-1 all-gather never writes, misses TOL by far. Its
# move is LR g / (|g| + eps): where |g| is near AdamW's eps a float32
# difference in g moves it by up to LR dg / eps, so the parameters are
# compared where |g| is 0 or at least SETTLED x eps (all but a few in a
# thousand entries).
STEPS, WARMUP, SETTLED = 2, 1, 10.0
TOL = 1e-4                      # tests/test_distribution.py's bound


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    yield from world_factory(tmp_path_factory, WORLDS, __name__)


def rank_block(world_name, rank, t, spec):
    """Rank `rank`'s block of `t` under `spec`, as the parent sees it: from
    the rank's coordinates alone."""
    shape = MeshShape(WORLDS[world_name])
    return rules.shard_tensor(t, spec, shape, coords=shape.coords_of(rank))


# ---------------------------------------------------------------------------
# cases, run on every rank of a world
# ---------------------------------------------------------------------------


def _numpy_blocks(tree):
    return {path: t.detach().numpy().copy()
            for path, t in flatten_tree(tree).items()}


def case_train_step(mesh, cfg, run, params, batch, acfg):
    model = Model(cfg, run, "cpu", mesh)
    params_from_numpy(shard_params(params, model.specs, mesh), model)
    state = init_train_state(model, None, acfg)
    local = {k: rules.shard_tensor(torch.as_tensor(v),
                                   rules.batch_spec(mesh, np.ndim(v)), mesh)
             for k, v in batch.items()}
    step = make_train_step(model, acfg, warmup=WARMUP)
    for _ in range(STEPS):
        state, metrics = step(state, local)
    state_bytes = sum(t.numel() * t.element_size() for t in
                      leaves(state.params) + leaves(state.opt.m) +
                      leaves(state.opt.v))
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": _numpy_blocks(state.params),
            "m": _numpy_blocks(state.opt.m), "bytes": state_bytes,
            "residual": (None if state.residual is None
                         else _numpy_blocks(state.residual)),
            "collectives": C.stats()}


def case_moe(mesh, cfg, params, x):
    run = RunConfig(compute_dtype="float32")
    specs = rules.param_specs(params, mesh, run)
    local = {k: torch.tensor(v, requires_grad=True)
             for k, v in shard_params(params, specs, mesh).items()}
    xl = rules.shard_tensor(torch.as_tensor(x), rules.batch_spec(mesh, 3),
                            mesh)
    out, aux = M.moe(local, xl, cfg, run, mesh)
    out.sum().backward()
    return {"out": out.detach().numpy(),
            "grad_w_gate": float(local["w_gate"].grad.abs().sum()),
            "aux": float(aux), "collectives": C.stats()}


def case_moe_grads(mesh, cfg, params, x, r):
    """``moe`` on this rank's rows of x and blocks of the weights, then the
    gradients of sum(out * r) over them: out, aux, x's gradient and each
    leaf's."""
    run = RunConfig(compute_dtype="float32")
    specs = rules.param_specs(params, mesh, run)
    local = {k: torch.tensor(v, requires_grad=True)
             for k, v in shard_params(params, specs, mesh).items()}
    spec = rules.batch_spec(mesh, 3)
    xl = rules.shard_tensor(torch.as_tensor(x), spec, mesh).clone()
    xl.requires_grad_(True)
    out, aux = M.moe(local, xl, cfg, run, mesh)
    (out * rules.shard_tensor(torch.as_tensor(r), spec, mesh)).sum() \
        .backward()
    return {"out": out.detach().numpy(), "aux": float(aux),
            "grad_x": xl.grad.numpy(),
            "grads": {k: t.grad.numpy() for k, t in local.items()},
            "collectives": C.stats()}


def case_pipeline(mesh, W, x, n_micro):
    n, i = C.axis_size(mesh, "pipe"), C.axis_index(mesh, "pipe")
    per = W.shape[0] // n
    wb = torch.tensor(W[i * per:(i + 1) * per], requires_grad=True)

    def stage_fn(stage_w, h):
        for w in stage_w:
            h = torch.tanh(h @ w)
        return h

    out = pipeline_apply(stage_fn, wb, torch.as_tensor(x), mesh,
                         n_micro=n_micro)
    out.sum().backward()
    return {"out": out.detach().numpy(), "grad": wb.grad.numpy(),
            "collectives": C.stats()}


def case_global_norm(mesh, rep, full):
    spec = (None, "model")
    tree = {"rep": torch.as_tensor(rep),
            "split": rules.shard_tensor(torch.as_tensor(full), spec, mesh)}
    return float(global_norm(tree, mesh, {"rep": (), "split": spec}))


def case_local_mesh(mesh, model):
    from repro_torch.launch.mesh import make_local_mesh
    local = make_local_mesh(model=model, device="cpu")
    return local.config, local.coords == mesh.coords


def case_save(mesh, full, spec, directory):
    block = rules.shard_tensor(torch.as_tensor(full), spec, mesh)
    ckpt.save_checkpoint(directory, 3, {"x": block}, specs={"x": spec},
                         mesh=mesh)
    return True


CASES = {"train_step": case_train_step, "moe": case_moe,
         "moe_grads": case_moe_grads,
         "local_mesh": case_local_mesh,
         "pipeline": case_pipeline, "global_norm": case_global_norm,
         "save": case_save}


# ---------------------------------------------------------------------------
# the JAX package's references
# ---------------------------------------------------------------------------

TRAIN_ARCHS = {
    "deepseek-7b": dict(d_model=64, n_layers=2, vocab_size=256),
    "rwkv6-7b": dict(n_layers=2),
    "whisper-small": dict(n_layers=2),
    "olmoe-1b-7b": dict(n_layers=2),
    "llama-3.2-vision-90b": dict(),
    "chatglm3-6b": dict(n_layers=2),
    "zamba2-7b": dict(),
    "deepseek-v3-671b": dict(n_layers=2),
}
# a variant of an arch: (arch, fields of its MoEConfig)
VARIANTS = {"olmoe-1b-7b-dense": ("olmoe-1b-7b", dict(impl="dense"))}


def configs(arch):
    arch, moe_over = VARIANTS.get(arch, (arch, {}))
    over = TRAIN_ARCHS[arch]
    jcfg, tcfg = jax_arch(arch).reduced(**over), get_arch(arch).reduced(**over)
    if moe_over:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe_over))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, **moe_over))
    if jcfg.moe is not None:
        # ample capacity: nothing drops, as moe_dense drops nothing
        cap = float(jcfg.moe.n_experts)
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cap))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cap))
    return jcfg, tcfg


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32)
                        if np.asarray(a).dtype.kind == "f" else np.asarray(a),
                        tree)


_REFS = {}


def jax_train_reference(arch, **flags):
    """(params, batch, loss, new params, new m, new residual, settled) of
    STEPS JAX steps on one device, as numpy trees (the residual None
    without grad_compression; settled, a leaf's entries whose |g| is 0
    or at least SETTLED x eps, read from the second moment); the vlm's tanh gates set to 0.5 (at 0 they hide
    the cross path) and its media random. `flags`: RunConfig fields (the
    one-device step reads microbatches; the FSDP flags lay out nothing
    there)."""
    key = (arch, tuple(sorted(flags.items())))
    if key in _REFS:
        return _REFS[key]
    jcfg, _ = configs(arch)
    model = JaxModel(jcfg, JaxRunConfig(**RUN, **flags))
    params = model.init(jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        cross = params["layers"]["cross"]["attn"]
        cross["gate"] = jnp.full_like(cross["gate"], 0.5)
    acfg = JaxAdamWConfig(lr=LR)
    state = JaxTrainState(params, jax_init_adamw(params, acfg), None)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (8, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if jcfg.family == "vlm":
        batch["media"] = rng.standard_normal(
            (8, jcfg.cross_attn.n_media_tokens, jcfg.d_model),
            dtype=np.float32)
    if jcfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (8, jcfg.encdec.enc_len, jcfg.d_model), dtype=np.float32)
    step = jax.jit(jax_make_train_step(model, acfg, None, warmup=WARMUP))
    new = state
    for _ in range(STEPS):
        new, metrics = step(new, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    moved = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                for a, b in zip(jax.tree.leaves(new.params),
                                jax.tree.leaves(params)))
    assert moved > 0.5 * LR, moved      # the parameters' gate sees a step
    g_abs = {path: np.sqrt(v / (1.0 - acfg.b2 ** STEPS)) for path, v in
             flatten_tree(to_numpy(new.opt.v)).items()}
    settled = {path: (g == 0) | (g >= SETTLED * acfg.eps)
               for path, g in g_abs.items()}
    _REFS[key] = (to_numpy(params), batch, float(metrics["loss"]),
                  flatten_tree(to_numpy(new.params)),
                  flatten_tree(to_numpy(new.opt.m)),
                  None if new.residual is None
                  else flatten_tree(to_numpy(new.residual)), settled)
    return _REFS[key]


def assert_blocks(world_name, results, key, want, specs, where=None):
    """Each rank's blocks of `key` within TOL of `want`'s, at the entries
    `where` holds (a tree of masks; None: all)."""
    for rank, res in enumerate(results):
        for path, block in res[key].items():
            ref = rank_block(world_name, rank, want[path], specs[path])
            assert block.shape == ref.shape, (path, block.shape, ref.shape)
            err = np.abs(block - ref)
            if where is not None:
                err = err[rank_block(world_name, rank, where[path],
                                     specs[path])]
            err = float(np.max(err, initial=0.0))
            assert err < TOL, (world_name, rank, key, path, err)


def run_train(worlds, world_name, arch, **flags):
    params, batch, loss, new_params, new_m, _, settled = \
        jax_train_reference(arch, **flags)
    assert sum(int(m.sum()) for m in settled.values()) >= 0.99 * sum(
        m.size for m in settled.values())
    _, tcfg = configs(arch)
    run = RunConfig(**RUN, **flags)
    results = worlds(world_name).run(
        "train_step", cfg=tcfg, run=run, params=params, batch=batch,
        acfg=AdamWConfig(lr=LR))
    model = Model(tcfg, run, "meta", MeshShape(WORLDS[world_name]))
    pspecs, sspecs = state_specs(model)
    for res in results:
        assert abs(res["loss"] - loss) < TOL, (res["loss"], loss)
    assert_blocks(world_name, results, "params", new_params,
                  flatten_tree(pspecs), settled)
    assert_blocks(world_name, results, "m", new_m, flatten_tree(sspecs))
    return results


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world_name", ["1x2", "2x1", "2x2"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "olmoe-1b-7b",
                                  "llama-3.2-vision-90b"])
def test_sharded_train_step_matches_the_one_device_reference(worlds, arch,
                                                             world_name):
    results = run_train(worlds, world_name, arch)
    stats = results[0]["collectives"]
    mesh = WORLDS[world_name]
    if dict(zip(mesh.axes, mesh.shape))["model"] > 1:
        assert stats["all_reduce"]["calls"] > 0
    if arch == "olmoe-1b-7b":
        # the expert-parallel path: its combine is all-reduced over model
        assert stats["all_reduce"]["bytes"] > 0


@pytest.mark.parametrize("arch,micro", [("deepseek-7b", 2),
                                        ("olmoe-1b-7b", 1)])
def test_fsdp_and_microbatches_match_the_one_device_reference(worlds, arch,
                                                              micro):
    """fsdp_params (every ruled leaf also split over 'data', gathered once
    a forward), fsdp_experts (the experts' ff over 'data', gathered a
    layer) and, for the dense model, two microbatches reduced once, on
    (2, 2). (A rank cuts its own rows into microbatches, where the
    reference's one-device step cuts the whole batch: the MoE's aux, a
    product of means over a microbatch's tokens, differs between the two
    groupings, so the MoE model takes one.)"""
    results = run_train(worlds, "2x2", arch, fsdp_params=True,
                        fsdp_experts=True, microbatches=micro)
    stats = results[0]["collectives"]
    assert stats["all_gather"]["calls"] > 0
    assert stats["reduce_scatter"]["calls"] > 0


@pytest.mark.parametrize("arch", ["rwkv6-7b", "whisper-small"])
def test_data_parallel_alone_runs_every_family(worlds, arch):
    """Under 'data' alone the families without a tensor-parallel form
    train, and match the one-device step."""
    run_train(worlds, "2x1", arch)


def test_replicated_kv_heads_follow_their_query_heads(worlds):
    """chatglm3-6b reduced: 4 query heads over a 4-way model axis, 2 KV
    heads replicated (they do not divide it): each rank reads the KV head
    of its query head, by global head index."""
    _, tcfg = configs("chatglm3-6b")
    model = Model(tcfg, RunConfig(), "meta", MeshShape(WORLDS["1x4"]))
    assert model.specs["layers"]["attn"]["wk"] == (None, None, None, None)
    assert model.specs["layers"]["attn"]["wq"] == (None, None, "model", None)
    run_train(worlds, "1x4", "chatglm3-6b")


@pytest.mark.parametrize("impl", ["ep_tp", "ep_a2a"])
def test_moe_expert_parallel_matches_moe_dense(worlds, impl):
    jcfg = jax_arch("olmoe-1b-7b").reduced()
    cap = float(jcfg.moe.n_experts * (4 if impl == "ep_a2a" else 1))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cap, impl=impl))
    tcfg = get_arch("olmoe-1b-7b").reduced()
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=cap, impl=impl))
    params = to_numpy(JM.init_moe(jax.random.PRNGKey(0), jcfg))
    x = 0.5 * np.random.default_rng(1).standard_normal(
        (4, 16, jcfg.d_model), dtype=np.float32)
    want, _ = JM.moe_dense(params, jnp.asarray(x), jcfg)
    want = np.asarray(want)
    results = worlds("2x2").run("moe", cfg=tcfg, params=params, x=x)
    for rank, res in enumerate(results):
        ref = rank_block("2x2", rank, want,
                         rules.batch_spec(MeshShape(WORLDS["2x2"]), 3))
        assert float(np.max(np.abs(res["out"] - ref))) < TOL
        assert res["grad_w_gate"] > 0
    kind = "all_to_all" if impl == "ep_a2a" else "all_reduce"
    # every path over 'model' all-reduces its combine
    assert results[0]["collectives"][kind]["calls"] > 0


def test_dense_moe_impl_is_refused_over_a_model_axis(worlds):
    """impl "dense" (the config's default) over a 'model' axis: the model
    builds with the experts split over 'model', and on "2x2" ``moe`` runs
    the dropless dispatch over each rank's block of the experts and
    all-reduces the combine: out and aux within TOL of JAX ``moe_dense``'s,
    and the gradients of sum(out * r) as ``jax.grad`` gives them (x's on
    each rank's rows; each weight block's summed over the data ranks that
    hold it). Over a 'model' axis of 1 ``moe`` is the local dispatch on
    the rank's tokens."""
    jcfg, tcfg = configs("olmoe-1b-7b-dense")
    tp = Mesh.alone(WORLDS["1x2"], 0, "cpu")
    model = Model(tcfg, RunConfig(), "meta", tp)
    assert model.specs["layers"]["moe"]["w_gate"] == (None, "model", None,
                                                      None)
    params = to_numpy(JM.init_moe(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    x = 0.5 * rng.standard_normal((4, 16, jcfg.d_model), dtype=np.float32)
    r = rng.standard_normal(x.shape, dtype=np.float32)

    def loss(p, xx):
        out, _ = JM.moe_dense(p, xx, jcfg)
        return jnp.sum(out * r)

    want, want_aux = JM.moe_dense(params, jnp.asarray(x), jcfg)
    gp, gx = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    gp = to_numpy(gp)
    results = worlds("2x2").run("moe_grads", cfg=tcfg, params=params, x=x,
                                r=r)
    shape = MeshShape(WORLDS["2x2"])
    bspec = rules.batch_spec(shape, 3)
    pspecs = rules.param_specs(params, shape, RunConfig())
    for rank, res in enumerate(results):
        for key, ref in (("out", np.asarray(want)), ("grad_x", np.asarray(gx))):
            err = np.abs(res[key] - rank_block("2x2", rank, ref, bspec))
            assert float(err.max()) < TOL, (rank, key, float(err.max()))
        assert abs(res["aux"] - float(want_aux)) < TOL
        m = shape.coords_of(rank)["model"]
        for leaf, ref in gp.items():
            got = sum(other["grads"][leaf] for other_rank, other in
                      enumerate(results)
                      if shape.coords_of(other_rank)["model"] == m)
            err = np.abs(got - rank_block("2x2", rank, ref, pspecs[leaf]))
            assert float(err.max()) < TOL, (rank, leaf, float(err.max()))
    assert results[0]["collectives"]["all_reduce"]["calls"] > 0
    mp = M.init_moe(torch.Generator().manual_seed(0), tcfg)
    xt = torch.randn(2, 4, tcfg.d_model, generator=torch.Generator()
                     .manual_seed(1))
    dp = Mesh.alone(WORLDS["2x1"], 0, "cpu")
    out, _ = M.moe(mp, xt, tcfg, RunConfig(), dp)
    local, _ = M.moe_local(mp, xt, tcfg)
    torch.testing.assert_close(out, local, rtol=0, atol=0)


@pytest.mark.parametrize("world_name", ["1x2", "2x2"])
def test_dense_moe_impl_trains_over_a_model_axis(worlds, world_name):
    """The reduced olmoe-1b-7b with impl "dense": two sharded train steps
    against the reference's one-device steps (its moe is ``moe_dense``):
    the loss (the whole batch's aux), the parameters and the first
    moments of every block within TOL."""
    results = run_train(worlds, world_name, "olmoe-1b-7b-dense")
    assert results[0]["collectives"]["all_reduce"]["calls"] > 0


def test_pipeline_matches_the_sequential_stack(worlds):
    """GPipe over 4 stages == the sequential stack: forward within 1e-5,
    the gradient within 1e-4 (tests/test_distribution.py's bounds)."""
    L, d = 8, 16
    W = 0.3 * np.asarray(jax.random.normal(jax.random.PRNGKey(0), (L, d, d)))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 4, d)))

    def stage_fn(stage_w, h):
        return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), h,
                            stage_w)[0]

    ref = np.asarray(stage_fn(W, x))
    gref = np.asarray(jax.grad(lambda w: stage_fn(w, x).sum())(W))
    results = worlds("pipe4").run("pipeline", W=W, x=x, n_micro=4)
    for stage, res in enumerate(results):
        assert float(np.max(np.abs(res["out"] - ref))) < 1e-5
        per = L // 4
        got = res["grad"]
        assert float(np.max(np.abs(got - gref[stage * per:(stage + 1) *
                                               per]))) < 1e-4
        # ticks - 1 shifts forward (n_micro + stages - 2), as many back
        assert res["collectives"]["ppermute"]["calls"] == 2 * (4 + 4 - 2)


def test_global_norm_counts_a_replicated_leaf_once(worlds):
    rng = np.random.default_rng(0)
    rep = rng.standard_normal((3, 4)).astype(np.float32)
    full = rng.standard_normal((5, 6)).astype(np.float32)
    want = float(np.sqrt((rep.astype(np.float64) ** 2).sum() +
                         (full.astype(np.float64) ** 2).sum()))
    for got in worlds("1x2").run("global_norm", rep=rep, full=full):
        assert abs(got - want) < 1e-5 * want


def test_make_local_mesh_over_the_running_world(worlds):
    for cfg, same in worlds("1x2").run("local_mesh", model=2):
        assert cfg == WORLDS["1x2"] and same


def test_sharded_save_and_elastic_restore(worlds, tmp_path):
    """A leaf saved from a (1, 2) world is written whole; restored onto a
    (4, 2) and a (2, 4) mesh, each rank reads exactly its block (no world
    needed: a rank's block follows from its coordinates)."""
    full = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    worlds("1x2").run("save", full=full, spec=(None, "model"),
                      directory=str(tmp_path))
    for shape, spec in (((4, 2), ("data", "model")),
                        ((2, 4), ("model", "data"))):
        cfg = MeshConfig(shape, ("data", "model"))
        blocks = []
        for rank in range(cfg.n_devices):
            mesh = Mesh.alone(cfg, rank, "cpu")
            like = {"x": torch.empty(rules.local_shape((8, 8), spec, mesh))}
            got, _ = ckpt.restore_checkpoint(str(tmp_path), 3, like,
                                             shardings={"x": spec},
                                             mesh=mesh)
            np.testing.assert_array_equal(
                got["x"].numpy(), rules.shard_tensor(full, spec, mesh))
            blocks.append(got["x"].numpy())
        np.testing.assert_array_equal(
            rules.gather_tensor(blocks, spec, MeshShape(cfg)), full)


def test_a_rank_alone_allocates_what_rank_0_does_among_peers(worlds):
    """deepseek-7b reduced on (2, 2): rank 0 run alone (its collectives
    return zeros) holds the same parameter and state bytes as rank 0 of
    the gloo world, and its step runs."""
    results = run_train(worlds, "2x2", "deepseek-7b")
    _, tcfg = configs("deepseek-7b")
    params, batch, *_ = jax_train_reference("deepseek-7b")
    mesh = Mesh.alone(WORLDS["2x2"], rank=0, device="cpu")
    C.reset_stats()
    out = case_train_step(mesh, tcfg, RunConfig(**RUN), params, batch,
                          AdamWConfig(lr=LR))
    assert out["bytes"] == results[0]["bytes"]
    assert {k: v.shape for k, v in out["params"].items()} == \
        {k: v.shape for k, v in results[0]["params"].items()}
    assert out["collectives"]["all_reduce"]["calls"] == \
        results[0]["collectives"]["all_reduce"]["calls"]


def test_rank_alone_is_only_chosen_by_mesh_alone():
    assert Mesh.alone(WORLDS["2x2"], 3, "cpu").transport == "alone"
    with pytest.raises(ValueError):
        Mesh.alone(WORLDS["2x2"], 4, "cpu")
    import inspect
    import pathlib
    from repro_torch.launch import mesh as mesh_module
    assert inspect.signature(mesh_module.make_mesh).parameters[
        "backend"].default is None
    assert "alone" not in inspect.getsource(mesh_module.make_mesh)
    # a Mesh has no default transport, and takes none but the two
    with pytest.raises(TypeError):
        Mesh(WORLDS["2x2"], rank=1)
    with pytest.raises(ValueError):
        Mesh(WORLDS["2x2"], 1, torch.device("cpu"), "none")
    # a mesh of shapes only runs no collective
    shape = MeshShape(WORLDS["2x2"])
    x = torch.ones(2, 4)
    for run in (lambda: C.all_reduce(x, shape, "model"),
                lambda: C.reduce_(x, shape, "data"),
                lambda: C.all_gather(x, shape, "model", 1),
                lambda: C.all_to_all(x, shape, "data"),
                lambda: C.ppermute(x, shape, "model"),
                lambda: C.barrier(shape)):
        with pytest.raises(RuntimeError, match="make_mesh or Mesh.alone"):
            run()
    assert torch.equal(x, torch.ones(2, 4))
    # and the port's source names the rank-alone transport in one
    # constructor
    src = pathlib.Path(mesh_module.__file__).parents[1]
    setters = [str(p.relative_to(src)) for p in sorted(src.rglob("*.py"))
               if 'transport="alone"' in p.read_text()]
    assert setters == ["launch/mesh.py"]
    assert 'transport="alone"' in inspect.getsource(Mesh.alone)
    assert inspect.getsource(mesh_module).count('transport="alone"') == 1


def test_the_planner_profiles_one_rank_of_a_profile_mesh(monkeypatch):
    """plan(..., profile_mesh=) profiles each depth as rank 0 of the mesh
    run alone and multiplies the per-rank prediction by the mesh's
    devices, as the reference does; build_step runs that rank's step."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import hbm_planner as H
    from repro_torch.launch import dryrun
    cfg = get_arch("deepseek-7b").reduced(d_model=64, vocab_size=256)
    shape = ShapeConfig("train_16", 16, 4, "train")
    mesh_cfg = MeshConfig((2, 2), ("data", "model"))
    seen = []

    def fake_build_step(cfg_, shape_, run_, device_, mesh=None):
        seen.append(mesh)
        return lambda: None

    class FakeProfiler:
        def profile(self, job, size, device=None):
            job()
            from repro_torch.core.profiler import ProfileResult
            return ProfileResult(size, 1e9 + 3e8 * size, 0.0, 0.0)

    monkeypatch.setattr(H, "build_step", fake_build_step)
    monkeypatch.setattr(H, "CUDAMemoryProfiler", FakeProfiler)
    rep = H.HBMPlanner().plan(cfg, shape, device="cpu", profile_mesh=mesh_cfg)
    assert all(m.transport == "alone" and m.rank == 0 and
               m.config == mesh_cfg for m in seen)
    assert rep.profile_mesh_devices == 4
    assert abs(rep.requirement_gib - 4 * rep.predicted_per_dev_gib) < 1e-9
    # and the rank's step itself, on the CPU
    mesh = Mesh.alone(mesh_cfg, 0, "cpu")
    out = dryrun.build_step(cfg, shape, RunConfig(**RUN), "cpu", mesh=mesh)()
    assert set(out) >= {"loss", "grad_norm"}


def jax_local_grads(arch, n):
    """The gradients of the JAX reference's loss over each of n equal
    row blocks of its batch, each scaled by 1/n: a data rank's share of
    the whole batch's gradient, before any reduction."""
    params, batch, *_ = jax_train_reference(arch)
    jcfg, _ = configs(arch)
    model = JaxModel(jcfg, JaxRunConfig(**RUN))
    grad = jax.jit(jax.grad(lambda p, b: model.loss_fn(p, b)[0]))
    rows = len(batch["tokens"]) // n
    return [flatten_tree(to_numpy(jax.tree.map(lambda g: g / n, grad(
        params, {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                 for k, v in batch.items()})))) for i in range(n)]


def test_grad_compression_under_data_parallelism(worlds):
    """grad_compression over 'data', against the JAX step with it. Each
    rank rounds its own share of the gradient to bfloat16 and keeps what
    the rounding dropped (its residual); the ranks sum the bfloat16
    shares. That sum differs from the reference's one rounding of the
    whole gradient by bfloat16 roundings (BF16, its spacing at 1), so:
    the loss within TOL; each leaf's m within 4 BF16 of its largest
    entry (a missing reduction is off by half of it); the parameters
    within TOL wherever m is outside that band (the step's sign is
    sure); and each rank's residual equal to what bfloat16 drops, over
    the two steps, from the JAX gradient of its share of the batch (the
    same gradient twice: the first step moves nothing): within 1e-5 of
    the leaf's largest gradient (float32 rounding) for at least 99 % of
    the entries, and within one spacing everywhere (where the two
    gradients round to different bfloat16 values). A lost residual would
    leave about a quarter of the entries that close."""
    BF16 = 2.0 ** -7
    params, batch, loss, new_params, new_m, *_ = jax_train_reference(
        "deepseek-7b", grad_compression=True)
    _, tcfg = configs("deepseek-7b")
    run = RunConfig(**RUN, grad_compression=True)
    results = worlds("2x1").run(
        "train_step", cfg=tcfg, run=run, params=params, batch=batch,
        acfg=AdamWConfig(lr=LR))
    for res in results:
        assert abs(res["loss"] - loss) < TOL, (res["loss"], loss)
    assert results[0]["loss"] == results[1]["loss"]
    for path in results[0]["params"]:
        np.testing.assert_array_equal(results[0]["params"][path],
                                      results[1]["params"][path])
    _, sspecs = state_specs(Model(tcfg, run, "meta",
                                  MeshShape(WORLDS["2x1"])))
    sspecs = flatten_tree(sspecs)
    for rank, res in enumerate(results):
        for path, m in res["m"].items():
            want = rank_block("2x1", rank, new_m[path], sspecs[path])
            band = 4 * BF16 * float(np.max(np.abs(new_m[path])))
            assert float(np.max(np.abs(m - want))) <= band, (rank, path)
            sure = np.abs(rank_block("2x1", rank, new_m[path],
                                     sspecs[path])) > band
            got_p = rank_block("2x1", rank, res["params"][path],
                               sspecs[path])
            want_p = rank_block("2x1", rank, new_params[path],
                                sspecs[path])
            assert float(np.max(np.abs(got_p - want_p)[sure],
                                initial=0.0)) < TOL, (rank, path)
    close = total = 0
    for res, share in zip(results, jax_local_grads("deepseek-7b", 2)):
        assert max(float(np.max(np.abs(r))) for r in
                   res["residual"].values()) > 0
        for path, r in res["residual"].items():
            g = share[path]
            want = np.zeros_like(g)
            for _ in range(STEPS):
                tot = g + want
                want = tot - np.asarray(jnp.asarray(tot, jnp.bfloat16),
                                        np.float32)
            err = np.abs(r - want)
            f32 = 1e-5 * float(np.max(np.abs(g)))
            assert np.all(err <= BF16 * np.abs(tot) + f32), path
            close += int(np.sum(err <= f32))
            total += err.size
    assert close >= 0.99 * total, (close, total)
