"""Training of the ssm (rwkv6-7b), hybrid (zamba2-7b), vlm
(llama-3.2-vision-90b) and audio (whisper-small) families in the port
against the JAX package, float32 on the CPU, at the reduced configs: one
step's loss and every leaf's gradient against ``jax.value_and_grad`` of the
reference's ``loss_fn``, the remat policies, one AdamW step against the
reference's ``train_step``, the one leaf that no forward reads (whisper's
cross-attention gate), microbatches that carry media and frames, the
stacks' gradient path (one unbind a stacked leaf, remat of the bodies the
reference wraps), the train launcher, ``build_step``'s train mode and the
planner's train ladders.

The weights are the JAX package's init carried across; the vlm's tanh gates
are set nonzero (they start at 0, which hides the cross path) and the media
and frames drawn with numpy from a seed (constant ones make the cross
softmax uniform); labels hold masked (< 0) positions. Tolerances: atol =
rtol = 2e-5 for the vlm and whisper (as ``tests/test_torch_train.py``),
1e-4 for rwkv6-7b and zamba2-7b, the reference's own for the chunked
recurrences (``tests/test_models.py``); 1e-6 on an AdamW step where the
first moment is clear of 0.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import RunConfig as JRunConfig
from repro.core import hbm_planner as jplan
from repro.models import build_model as jax_build_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step

from repro_torch.configs import RunConfig, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import (flatten_tree, params_from_numpy,
                                 train_state_from_numpy, train_state_to_numpy)
from repro_torch.core import hbm_planner as tplan
from repro_torch.launch import train as train_cli
from repro_torch.launch.dryrun import build_step
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import leaves
from repro_torch.train.step import (_microbatches, init_train_state,
                                    loss_and_grads, make_train_step)
from test_torch_parity import (as_f32, assert_stepped_params_close,
                               numpy_tree, two_train_steps)

ARCHS = ("rwkv6-7b", "zamba2-7b", "llama-3.2-vision-90b", "whisper-small")
TOL = {"rwkv6-7b": 1e-4, "zamba2-7b": 1e-4, "llama-3.2-vision-90b": 2e-5,
       "whisper-small": 2e-5}
ADAM_TOL = dict(atol=1e-6, rtol=1e-6)
B, S = 2, 16
VLM_GATES = (0.5, -0.7)          # one a group of the reduced config
UNUSED = {"whisper-small": {"layers.dec.cross.gate"}}


def jax_run(impl="full", **kw):
    return JRunConfig(attn_impl=impl, remat="nothing", compute_dtype="float32",
                      attn_block_q=8, attn_block_kv=8, **kw)


def torch_run(impl="full", **kw):
    kw = {"remat": "nothing", **kw}
    return RunConfig(attn_impl=impl, compute_dtype="float32", attn_block_q=8,
                     attn_block_kv=8, **kw)


def open_gates(params):
    """The vlm's tanh gates set nonzero in a JAX parameter tree, in place."""
    if "cross" in params["layers"]:
        params["layers"]["cross"]["attn"]["gate"] = jnp.asarray(
            VLM_GATES, jnp.float32)


def make_batch(cfg, batch=B, seq=S, seed=1, masked=True):
    """Tokens and labels (two positions masked unless `masked` is false),
    and the family's media or frames, drawn with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq + 1)).astype(
        np.int32)
    out = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if masked:
        out["labels"][0, :2] = -1
    for name, zeros in train_cli.family_inputs(cfg, batch).items():
        out[name] = rng.standard_normal(zeros.shape, dtype=np.float32)
    return out


def flat_np(tree):
    """A tree of torch tensors or JAX arrays as {path: float32 numpy}."""
    return {k: as_f32(v) for k, v in flatten_tree(tree).items()}


def pair(arch, impl="full"):
    """(jax model, jax params with the gates open, torch model on the CPU
    with the same weights, made trainable)."""
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    jm = jax_build_model(jcfg, jax_run(impl))
    jp = jm.init(jax.random.PRNGKey(0))
    open_gates(jp)
    tm = params_from_numpy(numpy_tree(jp),
                           Model(cfg, torch_run(impl), device="cpu"))
    return jm, jp, tm.trainable()


def torch_model(arch, seed=3, **run):
    m = Model(get_arch(arch).reduced(), torch_run(**run), device="cpu")
    m.init(seed=seed)
    if m.cfg.family == "vlm":
        m.params["layers"]["cross"]["attn"]["gate"].copy_(
            torch.tensor(VLM_GATES))
    return m.trainable()


def assert_trees_close(got, want, tol):
    got, want = flat_np(got), flat_np(want)
    assert set(got) == set(want)
    for path, w in want.items():
        assert np.isfinite(got[path]).all(), path
        np.testing.assert_allclose(got[path], w, atol=tol, rtol=tol,
                                   err_msg=path)


# ---------------------------------------------------------------------------
# one step against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["full", "blocked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, impl):
    """The loss and every leaf's gradient against jax.value_and_grad of the
    reference's loss_fn, on converted weights, masked labels and random
    media or frames; blocks of 8 over 16 tokens."""
    jm, jp, tm = pair(arch, impl)
    batch = make_batch(tm.cfg)
    (want, _), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    loss, metrics, grads = loss_and_grads(tm, tm.params, batch)
    tol = TOL[arch]
    np.testing.assert_allclose(float(loss), float(want), atol=tol, rtol=tol)
    assert float(metrics["ce"]) == float(loss)
    assert_trees_close(grads, jg, tol)


@pytest.mark.parametrize("remat", ["boundaries", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_gradients_of_nothing(arch, remat):
    batch = make_batch(get_arch(arch).reduced(), seed=2)
    out = []
    for policy in ("nothing", remat):
        m = torch_model(arch, impl="blocked", remat=policy)
        out.append(loss_and_grads(m, m.params, batch))
    assert float(out[1][0]) == pytest.approx(float(out[0][0]), rel=1e-6)
    assert_trees_close(out[1][2], out[0][2], TOL[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches_the_reference(arch):
    """A reference train state (gates open) converted to the port's, two
    train steps in each package under a warmup of 1 step. After the first
    (at lr 0): the loss, the gradient norm, the first moments, and the
    parameters where the first moment is clear of 0. After the second (at
    1e-2), which moves every parameter with a gradient: the parameters
    where the reference's |g| is settled
    (``test_torch_parity.assert_stepped_params_close``)."""
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    jm = jax_build_model(jcfg, jax_run())
    acfg = dict(lr=1e-2)
    js = jax_init_train_state(jm, jax.random.PRNGKey(0), JAdamWConfig(**acfg))
    open_gates(js.params)
    tm = Model(cfg, torch_run(), device="cpu")
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), tm)
    batch = make_batch(cfg, seed=6)
    tol = TOL[arch]

    def first(js, jmet, ts, tmet):
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=tol)
        port = train_state_to_numpy(ts)
        got, m = flatten_tree(port["params"]), flatten_tree(port["opt"]["m"])
        want_m = flatten_tree(numpy_tree(js.opt.m))
        for path, w in flatten_tree(numpy_tree(js.params)).items():
            clear = np.abs(want_m[path]) > 1e-5
            np.testing.assert_allclose(got[path][clear], w[clear],
                                       err_msg=path, **ADAM_TOL)
            # m after one step is (1 - b1) x the clipped gradient: the
            # gradient's tolerance, scaled alike
            np.testing.assert_allclose(m[path], want_m[path], err_msg=path,
                                       atol=0.1 * tol, rtol=tol)

    before = js.params
    js, jmet, ts, tmet = two_train_steps(jm, js, JAdamWConfig(**acfg), tm,
                                         ts, AdamWConfig(**acfg), batch,
                                         first)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               atol=tol, rtol=tol)
    assert_stepped_params_close(before, js, ts, JAdamWConfig(**acfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_only_whispers_cross_gate_goes_unused(arch):
    """Whisper's ungated cross-attention never reads the gate that its
    decoder layers hold: it gets a zero gradient of its shape and dtype, as
    under jax.value_and_grad, and the AdamW step treats it as any other
    leaf. No other leaf of any family goes unused."""
    m = torch_model(arch)
    batch = make_batch(m.cfg)
    names = sorted(flatten_tree(m.params))
    loss, _ = m.loss_fn(batch, m.params)
    raw = torch.autograd.grad(loss, leaves(m.params), allow_unused=True)
    unused = {n for n, g in zip(names, raw) if g is None}
    assert unused == UNUSED.get(arch, set())
    _, _, grads = loss_and_grads(m, m.params, batch)
    flat = flatten_tree(grads)
    for name in unused:
        p = flatten_tree(m.params)[name]
        assert flat[name].shape == p.shape and flat[name].dtype == p.dtype
        assert float(flat[name].abs().max()) == 0.0
    acfg = AdamWConfig(lr=1e-2)
    state = init_train_state(m, None, acfg)
    before = {n: flatten_tree(state.params)[n].detach().clone()
              for n in unused}
    state, met = make_train_step(m, acfg)(state, batch)
    assert np.isfinite(float(met["loss"]))
    for name in unused:       # a zero gate with a zero gradient stays 0
        for moment in (state.opt.m, state.opt.v):
            assert float(flatten_tree(moment)[name].abs().max()) == 0.0
        assert float(before[name].abs().max()) == 0.0
        assert torch.equal(flatten_tree(state.params)[name], before[name])


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-small"])
def test_microbatches_carry_media_and_frames(arch):
    """_microbatches splits media or frames with the tokens, and a step of
    two microbatches gives the single step's gradients (its first moments)
    and loss. No label is masked: the step's loss is the mean of the
    microbatches' token means, as the reference's."""
    cfg = get_arch(arch).reduced()
    batch = make_batch(cfg, batch=4, seed=8, masked=False)
    name = "media" if cfg.family == "vlm" else "frames"
    parts = _microbatches(batch, 2)
    assert [set(p) for p in parts] == [set(batch)] * 2
    np.testing.assert_array_equal(parts[1][name], batch[name][2:])
    np.testing.assert_array_equal(parts[1]["tokens"], batch["tokens"][2:])
    acfg = AdamWConfig(lr=1e-3)
    moments, losses = [], []
    for n in (1, 2):
        m = Model(cfg, torch_run(microbatches=n), device="cpu")
        s, met = make_train_step(m, acfg)(init_train_state(m, 0, acfg), batch)
        moments.append(s.opt.m)
        losses.append(float(met["loss"]))
    assert_trees_close(moments[1], moments[0], 0.1 * TOL[arch])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)


def test_loss_fn_takes_labels_and_extras_as_numpy():
    """loss_fn puts the labels and the media on the model's device, the
    media in the compute dtype: numpy in, the loss of torch tensors in."""
    m = torch_model("llama-3.2-vision-90b")
    batch = make_batch(m.cfg)
    as_tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        a, _ = m.loss_fn(batch)
        b, _ = m.loss_fn(as_tensors)
    assert float(a) == float(b)


def test_ssd_chunked_gradient_stays_finite_where_a_chunk_decays_past_exp():
    """Within a chunk, exp(cum_i - cum_j) for j > i (masked out) overflows
    once the chunk's decay passes ~88 in log; masked after the exp, its
    backward is 0 * inf = NaN, as the reference's is. Masked before it, the
    forward is the same and the gradient that of the step recurrence
    (float64)."""
    from repro.models.ssm import ssd_chunked as jax_ssd_chunked
    from repro_torch.kernels.ssd import ssd_chunked
    from repro_torch.models.ssm import ssd_recurrent
    rng = np.random.default_rng(21)
    Bt, St, H, P, N = 1, 32, 2, 4, 4
    xs, Bm, Cm = (rng.standard_normal((Bt, St, H, n), dtype=np.float32)
                  for n in (P, N, N))
    dt = np.full((Bt, St, H), 0.5, np.float32)
    A = np.array([-16.0, -0.5], np.float32)   # 32 x 0.5 x 16 = 256 a chunk
    grads = []
    for fn, dtype in ((ssd_chunked, torch.float32),
                      (ssd_recurrent, torch.float64)):
        ins = [torch.from_numpy(a).to(dtype).requires_grad_()
               for a in (xs, dt, A, Bm, Cm)]
        y = fn(*ins, chunk=16)[0] if fn is ssd_chunked else fn(*ins)[0]
        grads.append(torch.autograd.grad(y.sum(), ins))
    for got, want in zip(*grads):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                                   rtol=1e-4)
    jx = [jnp.asarray(a) for a in (xs, dt, A, Bm, Cm)]
    y_ref = jax_ssd_chunked(*jx, chunk=16)[0]
    with torch.no_grad():
        y = ssd_chunked(*(torch.from_numpy(a) for a in (xs, dt, A, Bm, Cm)),
                        chunk=16)[0]
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=2e-5,
                               rtol=2e-5)
    ref_grad = jax.grad(lambda d: jax_ssd_chunked(jx[0], d, *jx[2:],
                                                  chunk=16)[0].sum())(jx[1])
    assert not np.isfinite(np.asarray(ref_grad)).all()   # the reference's


# ---------------------------------------------------------------------------
# the stacks' gradient path
# ---------------------------------------------------------------------------


def reads_of_stacked_leaves(loss, params):
    """Nodes of the loss's autograd graph that select or index straight
    into a stacked parameter leaf (one under params["layers"])."""
    stacked = {id(p) for p in leaves(params["layers"])}
    found, seen, todo = [], set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            if node.name() in ("SelectBackward0", "IndexBackward0") and \
                    id(getattr(nxt, "variable", None)) in stacked:
                found.append(node.name())
            todo.append(nxt)
    return found


@pytest.mark.parametrize("arch", ARCHS)
def test_layers_come_out_of_one_unbind_a_leaf(arch):
    """Under grad mode no layer indexes a stacked leaf (each would give its
    backward a zero tensor the size of the whole leaf): the graph reaches
    every stacked leaf through unbind."""
    m = torch_model(arch)
    loss, _ = m.loss_fn(make_batch(m.cfg), m.params)
    assert reads_of_stacked_leaves(loss, m.params) == []


def saved_tensors(fn):
    """How many tensors autograd saves for the backward while `fn` runs
    (checkpointed regions keep theirs to themselves)."""
    count = [0]

    def pack(t):
        count[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return count[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_boundaries_remat_saves_fewer_tensors(arch):
    """remat="boundaries" wraps the bodies the reference wraps, so fewer
    tensors are saved for the backward than under "nothing". For whisper the
    encoder's share (its blocks go through ``stack``, wrapped already) is
    taken out, so that the decoder's layers are what is counted."""
    counts = {}
    for policy in ("nothing", "boundaries"):
        m = torch_model(arch, impl="blocked", remat=policy)
        batch = make_batch(m.cfg)
        n = saved_tensors(lambda: m.loss_fn(batch, m.params))
        if m.cfg.family == "audio":
            frames = torch.from_numpy(batch["frames"])
            n -= saved_tensors(lambda: T.encdec_encode(
                m.params["layers"], frames, m.cfg, m.run))
        counts[policy] = n
    assert counts["boundaries"] < counts["nothing"], counts


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_under_grad_matches_the_no_grad_forward(arch):
    """The grad-mode forward (unbind, remat) is the serving forward's
    function, which reads the layers as views."""
    m = torch_model(arch, impl="blocked", remat="boundaries")
    batch = make_batch(m.cfg)
    del batch["labels"]
    lg = m._forward(m.params, batch)
    assert lg.requires_grad
    torch.testing.assert_close(lg.detach(), m.forward(batch), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the launcher, build_step and the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_each_family_on_the_cpu(arch, capsys):
    state, report = train_cli.main(
        ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "12",
         "--batch", "4", "--seq", "32", "--lr", "1e-2"])
    assert report.final_step == 12 and report.losses[-1] < report.losses[0]
    launch = next(line for line in capsys.readouterr().out.splitlines()
                  if line.startswith("[launch]"))
    extra = {"llama-3.2-vision-90b": "media (4, 16, 64) zeros",
             "whisper-small": "frames (4, 16, 64) zeros"}.get(arch)
    assert (extra in launch) if extra else ("zeros" not in launch), launch


def test_family_inputs_are_the_reference_launchers_zeros():
    vlm, audio = (get_arch(a) for a in ("llama-3.2-vision-90b",
                                        "whisper-small"))
    got = train_cli.family_inputs(vlm, 2)["media"]
    assert got.shape == (2, 1601, 8192) and got.dtype == np.float32
    assert not got.any()
    got = train_cli.family_inputs(audio, 3)["frames"]
    assert got.shape == (3, 1500, 768) and not got.any()
    assert train_cli.family_inputs(get_arch("rwkv6-7b"), 2) == {}


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-small"])
def test_build_step_train_feeds_media_and_frames(arch, monkeypatch):
    """build_step's train mode carries media or frames drawn from the
    step's generator in the compute dtype, as the reference's
    input_specs."""
    cfg = replace(get_arch(arch).reduced(), vocab_size=128)
    seen = {}
    loss_fn = Model.loss_fn

    def spy(self, batch, params=None):
        seen.update(batch)
        return loss_fn(self, batch, params)

    monkeypatch.setattr(Model, "loss_fn", spy)
    out = build_step(cfg, ShapeConfig("t", 8, 2, "train"), torch_run(),
                     device="cpu")()
    assert np.isfinite(float(out["loss"]))
    name, rows = ("media", cfg.cross_attn.n_media_tokens) \
        if cfg.family == "vlm" else ("frames", cfg.encdec.enc_len)
    assert tuple(seen[name].shape) == (2, rows, cfg.d_model)
    assert seen[name].dtype == torch.float32 and float(seen[name].std()) > 0.5
    assert tuple(seen["labels"].shape) == (2, 8)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "zamba2-7b"])
@pytest.mark.parametrize("anchor", [None, 7, 13])
def test_planner_train_ladders_are_whole_groups(arch, anchor):
    """The depths the planner profiles a train job at hold whole groups
    (a cross-attention layer with its self-attention layers; Mamba2 blocks
    with their shared block), as the reference's."""
    cfg = get_arch(arch)
    period = (cfg.cross_attn or cfg.hybrid).period
    ladder = tplan.HBMPlanner.depth_ladder(cfg, anchor)
    depths = [tplan._reduced_depth(cfg, L).n_layers for L in ladder]
    assert all(d % period == 0 and d >= period for d in depths), depths
    assert depths == [jplan._reduced_depth(jax_get_arch(arch), L).n_layers
                      for L in ladder]
