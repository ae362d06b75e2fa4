"""``fsdp_params`` gathered a layer at a time, in every entry point, on the
CPU over worlds of gloo processes, against the JAX package's one-device
path.

Under ``fsdp_params`` the rules split every ruled leaf over 'data' too,
the embedding included. Each rank loads its blocks of the reference's
weights (``shard_params``) and:

* prefills its rows of the prompts and takes 4 decode steps fed the
  reference's greedy tokens: the logits within 1e-4 of the one-device
  prefill and decode chain, every greedy token equal;
* computes ``loss_and_grads`` and sums each gradient over the batch axes
  (``step._reduce_grads``): the loss and this rank's blocks of every
  gradient within 1e-4 of ``jax.value_and_grad`` of the reference's loss;
* counts the all-gathers of a forward: one a layer for each FSDP leaf of
  that layer, one for each top-level leaf (the embedding, the head), and
  for deepseek-v3-671b three a MoE layer (``fsdp_experts``' expert ff),
  none larger than one layer's largest leaf. Under the ``ep_a2a`` MoE
  without ``fsdp_experts`` (``launch.perf``'s dsv3 variants), 'data' lands
  on w_down's ff and the layer's gather takes it;
* under remat "boundaries", keeps no gathered layer leaf for the backward:
  no tensor that autograd saves outside the checkpointed layers is one,
  and none is alive once the forward has ended (the head's gather is).

mistral-large-123b's two reduced layers put 'data' on the stacked layer
axis (a layer lives on one data rank and is handed to the others);
three layers (`mistral-large-123b-3`) put it inside each layer. rwkv6-7b,
zamba2-7b and whisper-small serve and train under fsdp_params on (2, 2)
against the same references.
"""
import dataclasses
import gc
import weakref

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
from repro_torch.convert import flatten_tree, params_from_numpy, shard_params
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules
from repro_torch.train import step as S
from test_torch_parity import world_factory

WORLDS = {"2x1": MeshConfig((2, 1), ("data", "model")),
          "2x2": MeshConfig((2, 2), ("data", "model"))}
# a vocabulary of 512: no block of the embedding has a layer leaf's shape
ARCHS = {"mistral-large-123b": ("mistral-large-123b",
                                dict(d_model=64, n_layers=2, vocab_size=512)),
         "mistral-large-123b-3": ("mistral-large-123b",
                                  dict(d_model=64, n_layers=3,
                                       vocab_size=512)),
         "llama-3.2-vision-90b": ("llama-3.2-vision-90b", dict()),
         "deepseek-v3-671b": ("deepseek-v3-671b", dict(n_layers=2)),
         # the ep_a2a MoE, its expert leaves left to fsdp_params
         "deepseek-v3-671b-a2a": ("deepseek-v3-671b", dict(n_layers=2)),
         # the MTP block, gathered whole where the loss reads it, left out
         "deepseek-v3-671b-no-mtp": ("deepseek-v3-671b",
                                     dict(n_layers=2, mtp_depth=0,
                                          vocab_size=512))}
# the other three families (``test_fsdp_serves_and_trains_the_other_
# families``)
OTHER_FAMILIES = {"rwkv6-7b": ("rwkv6-7b", dict(n_layers=2)),
                  "zamba2-7b": ("zamba2-7b", dict()),
                  "whisper-small": ("whisper-small", dict(n_layers=2))}
CASES_BY_WORLD = [(arch, w) for w in WORLDS for arch in ARCHS
                  if arch != "deepseek-v3-671b-no-mtp"]
ARCHS.update(OTHER_FAMILIES)
RUN = dict(attn_impl="full", remat="nothing", compute_dtype="float32")
B, PROMPT, MAX_LEN, STEPS = 4, 6, 16, 4
TRAIN_B, TRAIN_S = 8, 16
TOL = 1e-4      # tests/test_torch_sharded_serving.py's and the train tests'


def configs(name):
    arch, over = ARCHS[name]
    jcfg, tcfg = jax_arch(arch).reduced(**over), get_arch(arch).reduced(**over)
    if jcfg.moe is not None:
        # ample capacity: the expert-parallel paths drop nothing, as the
        # reference's one-device moe_dense drops nothing
        cap = float(jcfg.moe.n_experts)
        impl = "ep_a2a" if name.endswith("-a2a") else tcfg.moe.impl
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cap))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cap, impl=impl))
    return jcfg, tcfg


def torch_run(tcfg, **over):
    """fsdp_params, and fsdp_experts for a MoE but the ep_a2a one (as
    ``launch.perf``'s dsv3 ep_a2a variants run it)."""
    return RunConfig(**{**RUN, **over}, fsdp_params=True,
                     fsdp_experts=tcfg.moe is not None and
                     tcfg.moe.impl != "ep_a2a")


# ---------------------------------------------------------------------------
# cases, run on every rank of a world
# ---------------------------------------------------------------------------


def _rows(mesh, v):
    t = torch.as_tensor(v)
    return rules.shard_tensor(t, rules.batch_spec(mesh, t.dim()),
                              mesh).contiguous()


def _model(mesh, cfg, run, params):
    model = Model(cfg, run, "cpu", mesh)
    params_from_numpy(shard_params(params, model.specs, mesh), model)
    return model


def case_serve(mesh, cfg, run, params, prompt, steps, max_len):
    """Prefill and decode steps of this rank's rows; the forward's
    all-gathers."""
    model = _model(mesh, cfg, run, params)
    local = {k: _rows(mesh, v) for k, v in prompt.items()}
    C.reset_stats()
    model.forward(local)
    forward = C.stats()["all_gather"]
    lg, caches = model.prefill(local, max_len)
    out = {"prefill": lg.numpy(), "decode": [], "forward": forward}
    for batch in steps:
        lg, caches = model.decode_step(
            {k: _rows(mesh, v) for k, v in batch.items()}, caches)
        out["decode"].append(lg.numpy())
    return out


def case_grads(mesh, cfg, run, params, batch):
    """The loss and this rank's blocks of the gradients, summed over the
    batch axes as the train step sums them."""
    model = _model(mesh, cfg, run, params).trainable()
    local = {k: _rows(mesh, v) for k, v in batch.items()}
    loss, _, grads = S.loss_and_grads(model, model.params, local)
    S._reduce_grads(model, grads)
    return {"loss": float(loss),
            "grads": {p: t.numpy().copy()
                      for p, t in flatten_tree(grads).items()}}


def case_remat(mesh, cfg, run, params, batch):
    """Under remat "boundaries": the shapes of the gathered leaves that
    autograd saves for the backward outside the checkpointed layers, and
    of those still alive when the forward has ended."""
    model = _model(mesh, cfg, run, params).trainable()
    local = {k: _rows(mesh, v) for k, v in batch.items()}
    made, by_storage, saved = [], {}, []
    gather = T._gather_leaf

    def spy(*args):
        y = gather(*args)
        if y is not args[0]:                    # a leaf gathered
            made.append(weakref.ref(y))
            by_storage[y.untyped_storage().data_ptr()] = made[-1]
        return y

    def pack(t):
        # a gathered leaf, or a view of it, still alive (a freed one's
        # address may be another tensor's now)
        y = by_storage.get(t.untyped_storage().data_ptr(), lambda: None)()
        if y is not None:
            saved.append(tuple(y.shape))
        return t

    T._gather_leaf = spy
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = model.loss_fn(local)
    finally:
        T._gather_leaf = gather
    gc.collect()
    alive = [tuple(r().shape) for r in made if r() is not None]
    loss.backward()
    return {"saved": saved, "alive": alive, "gathers": len(made)}


CASES = {"serve": case_serve, "grads": case_grads, "remat": case_remat}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    yield from world_factory(tmp_path_factory, WORLDS, __name__)


# ---------------------------------------------------------------------------
# the JAX package's one-device references
# ---------------------------------------------------------------------------

_REFS = {}


def _jax_model(name):
    jcfg, _ = configs(name)
    model = JaxModel(jcfg, JaxRunConfig(**RUN))
    params = model.init(jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        cross = params["layers"]["cross"]["attn"]
        cross["gate"] = jnp.full_like(cross["gate"], 0.5)
    return jcfg, model, params


def _media(jcfg, rng, n):
    """The VLM's random media, whisper's random frames."""
    if jcfg.family == "vlm":
        return {"media": rng.standard_normal(
            (n, jcfg.cross_attn.n_media_tokens, jcfg.d_model),
            dtype=np.float32)}
    if jcfg.family == "audio":
        return {"frames": rng.standard_normal(
            (n, jcfg.encdec.enc_len, jcfg.d_model), dtype=np.float32)}
    return {}


def _encoded(jcfg, model, params, frames):
    """Whisper's encoder output of `frames`, which its decode steps read."""
    enc = jnp.asarray(frames)
    enc = enc + JT._sinusoid(enc.shape[1], jcfg.d_model, enc.dtype)
    enc, _ = JT.stack(params["layers"]["enc"], enc, jcfg, model.run,
                      kind="dense", positions=jnp.arange(enc.shape[1]),
                      causal=False)
    return np.asarray(JL.rms_norm(enc, params["layers"]["enc_ln"],
                                  jcfg.norm_eps))


def serving_reference(name):
    """(params, prompt, steps, prefill logits, [decode logits]) of the
    one-device prefill and decode chain, each step fed the greedy token of
    the logits before it."""
    key = ("serve", name)
    if key in _REFS:
        return _REFS[key]
    jcfg, model, params = _jax_model(name)
    rng = np.random.default_rng(1)
    prompt = {"tokens": rng.integers(0, jcfg.vocab_size, (B, PROMPT))
              .astype(np.int32), **_media(jcfg, rng, B)}
    extra = {k: v for k, v in prompt.items() if k != "tokens"}
    if jcfg.family == "audio":
        extra = {"enc_out": _encoded(jcfg, model, params, prompt["frames"])}
    decode = jax.jit(model.decode_step)
    lg, caches = jax.jit(model.prefill, static_argnums=2)(
        params, {k: jnp.asarray(v) for k, v in prompt.items()}, MAX_LEN)
    prefill, steps, logits = np.asarray(lg), [], []
    for _ in range(STEPS):
        tok = np.argmax(np.asarray(lg)[:, -1, :jcfg.vocab_size], -1)
        batch = {"tokens": tok[:, None].astype(np.int32), **extra}
        steps.append(batch)
        lg, caches = decode(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, caches)
        logits.append(np.asarray(lg))
    _REFS[key] = (jax.tree.map(np.asarray, params), prompt, steps, prefill,
                  logits)
    return _REFS[key]


def grads_reference(name):
    """(params, batch, loss, flat gradients) of ``jax.value_and_grad`` of
    the reference's loss over the whole batch."""
    key = ("grads", name)
    if key in _REFS:
        return _REFS[key]
    jcfg, model, params = _jax_model(name)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (TRAIN_B, TRAIN_S)) \
        .astype(np.int32)
    batch = {"tokens": toks, "labels": toks, **_media(jcfg, rng, TRAIN_B)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, jbatch), has_aux=True))(params)
    _REFS[key] = (jax.tree.map(np.asarray, params), batch, float(loss),
                  flatten_tree(jax.tree.map(np.asarray, grads)))
    return _REFS[key]


_RUNS = {}


def served(worlds, name, world_name):
    """The ranks' results of the serve case (run once a world)."""
    key = (name, world_name)
    if key not in _RUNS:
        params, prompt, steps, _, _ = serving_reference(name)
        _, tcfg = configs(name)
        _RUNS[key] = worlds(world_name).run(
            "serve", cfg=tcfg, run=torch_run(tcfg), params=params,
            prompt=prompt, steps=steps, max_len=MAX_LEN)
    return _RUNS[key]


def _rank_block(world_name, rank, t, spec):
    shape = MeshShape(WORLDS[world_name])
    return rules.shard_tensor(torch.as_tensor(np.array(t)), spec, shape,
                              coords=shape.coords_of(rank)).numpy()


def _max_err(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err < TOL, (what, err)


# ---------------------------------------------------------------------------
# what a forward should gather, from the specs
# ---------------------------------------------------------------------------

# (path of a stack in the parameter tree, its leading layer axes)
STACKS = {"dense": [("layers", 1)],
          "moe": [("dense_layers", 1), ("layers", 1)],
          "vlm": [("layers.self", 2), ("layers.cross", 1)]}
EXPERTS = ("w_gate", "w_up", "w_down")


def gathered_leaves(tcfg, run, world_name):
    """[(layers, layer leaf shape)] of every stacked leaf 'data' splits
    (the experts' ff left to the MoE), this rank's blocks of the top-level
    leaves 'data' splits that a forward reads, the MoE layers' count whose
    expert ff it splits, and the largest layer leaf's elements (the
    experts' too)."""
    mesh = MeshShape(WORLDS[world_name])
    meta = Model(tcfg, run, "meta", mesh)
    specs = flatten_tree(meta.specs)
    full = flatten_tree(meta.full_shapes)
    layers, top, moe_layers, largest = [], [], 0, 0
    for path, spec in specs.items():
        if "data" not in spec or path.startswith("mtp."):
            continue                # the MTP block: the loss reads it
        name = path.rsplit(".", 1)[-1]
        if name in EXPERTS and run.fsdp_experts:
            moe_layers = full[path][0]
            largest = max(largest, int(np.prod(full[path][1:])))
            continue
        stack = [(s, lead) for s, lead in STACKS[tcfg.family]
                 if path.startswith(s + ".")]
        if not stack:
            top.append(rules.local_shape(full[path], spec, mesh))
            continue
        lead = stack[0][1]
        count = int(np.prod(full[path][:lead]))
        layers.append((count, full[path][lead:]))
        largest = max(largest, int(np.prod(full[path][lead:])))
    return layers, top, moe_layers, largest


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def check_serving(worlds, name, world_name):
    """Every rank's prefill and decode logits against the one-device
    chain's, and every greedy token equal."""
    _, _, _, prefill, logits = serving_reference(name)
    _, tcfg = configs(name)
    run = torch_run(tcfg)
    results = served(worlds, name, world_name)
    shape = MeshShape(WORLDS[world_name])
    meta = Model(tcfg, run, "meta", shape)
    lspec = (rules.batch_spec(shape, 1)[0], None,
             "model" if meta.vocab_split else None)

    def gathered(key, i=None):
        blocks = [r[key] if i is None else r[key][i] for r in results]
        return rules.gather_tensor(blocks, lspec, shape)

    _max_err(gathered("prefill"), prefill, "prefill logits")
    V = tcfg.vocab_size
    for i, want in enumerate(logits):
        got = gathered("decode", i)
        _max_err(got, want, f"decode step {i}")
        np.testing.assert_array_equal(np.argmax(got[:, -1, :V], -1),
                                      np.argmax(want[:, -1, :V], -1))


def check_grads(worlds, name, world_name):
    """Every rank's loss and blocks of the reduced gradients against
    ``jax.value_and_grad``."""
    params, batch, loss, grads = grads_reference(name)
    _, tcfg = configs(name)
    run = torch_run(tcfg)
    results = worlds(world_name).run("grads", cfg=tcfg, run=run,
                                     params=params, batch=batch)
    specs = flatten_tree(Model(tcfg, run, "meta",
                               MeshShape(WORLDS[world_name])).specs)
    for rank, res in enumerate(results):
        assert abs(res["loss"] - loss) < TOL, (res["loss"], loss)
        assert set(res["grads"]) == set(grads)
        for path, want in grads.items():
            _max_err(res["grads"][path],
                     _rank_block(world_name, rank, want, specs[path]),
                     f"rank {rank} grad {path}")


@pytest.mark.parametrize("name,world_name", CASES_BY_WORLD)
def test_fsdp_prefill_and_decode_match_the_one_device_reference(
        worlds, name, world_name):
    check_serving(worlds, name, world_name)


@pytest.mark.parametrize("name,world_name", CASES_BY_WORLD)
def test_fsdp_gathers_each_leaf_once_a_layer(worlds, name, world_name):
    """A forward all-gathers each FSDP leaf once for each layer that reads
    it and each top-level leaf once where it is read, and no call sends
    more than one layer's largest leaf or a top-level leaf's block (the
    embedding's block of a reduced vocabulary outgrows a reduced layer's
    leaves; at full width it is the other way round)."""
    _, tcfg = configs(name)
    run = torch_run(tcfg)
    layers, top, moe_layers, largest = gathered_leaves(tcfg, run,
                                                       world_name)
    assert layers and top
    want = sum(n for n, _ in layers) + len(top) + 3 * moe_layers
    largest = 4 * max([largest] + [int(np.prod(s)) for s in top])
    for res in served(worlds, name, world_name):
        assert res["forward"]["calls"] == want, (res["forward"], want)
        assert 0 < res["forward"]["max_bytes"] <= largest, \
            (res["forward"]["max_bytes"], largest)
        assert res["forward"]["groups"] == {2: {
            "calls": want, "bytes": res["forward"]["bytes"]}}


@pytest.mark.parametrize("name,world_name", CASES_BY_WORLD)
def test_fsdp_loss_and_grads_match_jax(worlds, name, world_name):
    check_grads(worlds, name, world_name)


@pytest.mark.parametrize("name", ["mistral-large-123b",
                                  "mistral-large-123b-3",
                                  "deepseek-v3-671b-no-mtp"])
def test_remat_keeps_no_gathered_layer_for_the_backward(worlds, name):
    params, batch, _, _ = grads_reference(name)
    _, tcfg = configs(name)
    run = torch_run(tcfg, remat="boundaries")
    layers, top, _, _ = gathered_leaves(tcfg, run, "2x2")
    shapes = {tuple(s) for _, s in layers}
    results = worlds("2x2").run("remat", cfg=tcfg, run=run, params=params,
                                batch=batch)
    for res in results:
        assert res["gathers"] > 0
        assert not shapes & set(res["saved"]), res["saved"]
        # the head's gather, which the logits' product keeps, and nothing
        # of a layer
        assert not shapes & set(res["alive"]), res["alive"]
        assert len(res["alive"]) <= len(top), res["alive"]


@pytest.mark.parametrize("arch", sorted(OTHER_FAMILIES))
def test_fsdp_serves_and_trains_the_other_families(worlds, arch):
    """rwkv6-7b, zamba2-7b (Mamba2 blocks stacked on groups and layers in
    a group) and whisper-small (the encoder and decoder stacks) under
    fsdp_params on (2, 2): the prefill, 4 decode steps and the reduced
    gradients of each rank against the JAX package's one-device path on
    the same weights, within 1e-4."""
    check_serving(worlds, arch, "2x2")
    check_grads(worlds, arch, "2x2")
