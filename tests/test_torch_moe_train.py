"""The MoE family's training path in the port against the JAX package,
float32 on the CPU, reduced olmoe-1b-7b (GQA) and deepseek-v3-671b (MLA, a
leading dense layer, a shared expert and the MTP block): the loss with the
router's aux term and the MTP loss, every leaf's gradient, one train step,
train states and checkpoints across the packages, the train CLI and the
planner's train step; and the chunked in-place AdamW update against the
whole-leaf arithmetic it replaced, bit for bit.

Tolerances: the MoE models' own (tests/test_torch_moe.py, from the
reference's ``test_moe_dense_vs_ep_capacity``): 1e-4 on the loss, its terms
and the gradients; the port's dispatch runs the chosen experts only where
the reference's dense path weights all of them, so sums are taken in
another order. The inputs are seeded so that no router top-k is a near tie:
every test that compares the two packages' routing asserts that the k-th
and (k+1)-th probabilities of every token in every MoE layer (the MTP
block's included) are at least TIE_GAP apart, far above float32 rounding,
so both packages choose the same experts."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import RunConfig as JRunConfig
from repro.models import build_model as jax_build_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import RunConfig, ShapeConfig, get_arch
from repro_torch.convert import (flatten_tree, params_from_numpy,
                                 train_state_from_numpy, train_state_to_numpy)
from repro_torch.launch import train as train_cli
from repro_torch.launch.dryrun import build_step
from repro_torch.models import moe as TM
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, adamw_update, init_adamw
from repro_torch.optim import adamw as adamw_module
from repro_torch.optim.adamw import leaves
from repro_torch.train.step import (init_train_state, loss_and_grads,
                                    make_train_step)
from test_torch_parity import as_f32, numpy_tree

MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v3-671b")
TOL = dict(atol=1e-4, rtol=1e-4)
TIE_GAP = 1e-4
B, S = 2, 16


def jax_run(attn_impl="full", **kw):
    return JRunConfig(attn_impl=attn_impl, remat="nothing",
                      compute_dtype="float32", attn_block_q=8,
                      attn_block_kv=8, **kw)


def torch_run(attn_impl="full", **kw):
    kw = {"remat": "nothing", **kw}
    return RunConfig(attn_impl=attn_impl, compute_dtype="float32",
                     attn_block_q=8, attn_block_kv=8, **kw)


def tokens_batch(cfg, seed, batch=B, seq=S):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, seq + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def flat_np(tree):
    """A tree of torch tensors or JAX arrays as {path: float32 numpy}."""
    return {k: as_f32(v) for k, v in flatten_tree(tree).items()}


def jax_pair(arch, impl="full", seed=0, **jax_kw):
    """(jax model, jax params, port model on the CPU with the same
    weights) of the reduced arch."""
    jm = jax_build_model(jax_get_arch(arch).reduced(), jax_run(impl, **jax_kw))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = params_from_numpy(numpy_tree(jp), Model(
        get_arch(arch).reduced(), torch_run(impl), device="cpu"))
    return jm, jp, tm


@pytest.fixture
def tie_gaps(monkeypatch):
    """The gap between the k-th and (k+1)-th router probability of every
    token, one entry a call of ``route`` (a MoE layer)."""
    gaps = []
    route = TM.route

    def recording(router_w, x, m):
        with torch.no_grad():
            probs = torch.softmax((x @ router_w.to(x.dtype)).float(), -1)
            top = torch.topk(probs, m.top_k + 1, dim=-1).values
            gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return route(router_w, x, m)

    monkeypatch.setattr(TM, "route", recording)
    return gaps


def assert_no_near_tie(gaps, n_layers):
    assert len(gaps) == n_layers, gaps
    assert min(gaps) > TIE_GAP, f"a router top-k is a near tie: {gaps}"


def n_moe_layers(cfg):
    return cfg.n_layers - cfg.moe.first_dense_layers + \
        (1 if cfg.mtp_depth else 0)


# ---------------------------------------------------------------------------
# the loss and its gradients against jax.value_and_grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["full", "blocked"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_terms_and_grads_match_jax(arch, impl, tie_gaps):
    """The loss (ce + router_aux_weight x aux [+ 0.3 x mtp]), ce, aux, the
    MTP term and every leaf's gradient against jax.value_and_grad of the
    reference's loss_fn, labels with masked (< 0) positions, blocks of 8
    over 16 tokens."""
    jm, jp, tm = jax_pair(arch, impl)
    cfg = tm.cfg
    batch = tokens_batch(cfg, seed=10)
    batch["labels"][1, :2] = -1
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jbatch), has_aux=True)(jp)
    loss, metrics, grads = loss_and_grads(tm.trainable(), tm.params, batch)
    assert_no_near_tie(tie_gaps, n_moe_layers(cfg))
    np.testing.assert_allclose(float(loss), float(want), **TOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmet["ce"]), **TOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmet["aux"]),
                               **TOL)
    if cfg.mtp_depth:
        _, (_, h) = jm.forward(jp, jbatch)
        want_mtp = jm._mtp_loss(jp, h, jbatch, None)
        np.testing.assert_allclose(float(metrics["mtp"]), float(want_mtp),
                                   **TOL)
        np.testing.assert_allclose(
            float(loss), float(metrics["ce"]) + cfg.moe.router_aux_weight *
            float(metrics["aux"]) + 0.3 * float(metrics["mtp"]), rtol=1e-6)
    else:
        assert "mtp" not in metrics
    got, ref = flat_np(grads), flat_np(jg)
    assert set(got) == set(ref)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], err_msg=path, **TOL)
    if cfg.mtp_depth:
        mtp = [p for p in got if p.startswith("mtp.")]
        assert "mtp.proj" in mtp and "mtp.block.moe.w_gate" in mtp
        assert all(np.abs(got[p]).max() > 0 for p in mtp)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_gradient_flows_through_the_mean_probabilities_only(arch):
    """With the cross entropy's and the MTP term's gradients out of the
    way (every label masked), the router's gradient is the aux term's
    alone: JAX's, where one_hot of the argmax has none."""
    jm, jp, tm = jax_pair(arch)
    batch = tokens_batch(tm.cfg, seed=3)
    batch["labels"][:] = -1
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jbatch), has_aux=True)(jp)
    loss, metrics, grads = loss_and_grads(tm.trainable(), tm.params, batch)
    assert float(metrics["ce"]) == 0.0
    got, ref = flat_np(grads), flat_np(jg)
    router = "layers.moe.router"
    top = np.abs(ref[router]).max()
    assert top > 0
    np.testing.assert_allclose(got[router], ref[router], **TOL)
    # the router's gradient is 0.01 times aux's: held to its own largest
    # entry too, so that a zero or wrong one cannot pass under atol
    assert np.abs(got[router] - ref[router]).max() / top < 1e-4
    np.testing.assert_allclose(
        float(loss), tm.cfg.moe.router_aux_weight * float(jmet["aux"]),
        **TOL)


@pytest.mark.parametrize("remat", ["boundaries", "dots"])
def test_remat_recomputes_the_same_routing(remat):
    """Under remat each MoE layer runs again in the backward and waits for
    its expert counts again: the same counts, the plain stack's gradients."""
    cfg = get_arch("deepseek-v3-671b").reduced()
    batch = tokens_batch(cfg, seed=4)
    out = []
    for policy in ("nothing", remat):
        m = Model(cfg, torch_run("blocked", remat=policy), device="cpu")
        m.init(seed=5).trainable()
        out.append(loss_and_grads(m, m.params, batch))
    assert float(out[0][0]) == pytest.approx(float(out[1][0]), rel=1e-6)
    for path, g in flat_np(out[0][2]).items():
        np.testing.assert_allclose(flat_np(out[1][2])[path], g,
                                   err_msg=path, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the dispatch under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [1, 2 ** 15, 2 ** 30])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gradients_are_moe_dense_gradients(arch, budget, monkeypatch):
    """The dispatch's backward (one expert a group, a few, or all) gives
    the gradients of the dropless plain version with respect to the input
    and every expert leaf, and the same bits on two backward passes."""
    cfg = get_arch(arch).reduced()
    gen = torch.Generator().manual_seed(1)
    p = TM.init_moe(gen, cfg)
    for t in leaves(p):
        t.requires_grad_(True)
    x = (0.5 * torch.randn((3, 7, cfg.d_model), generator=gen)
         ).requires_grad_(True)
    w = torch.randn((3, 7, cfg.d_model), generator=gen)

    def grads(fn):
        out, aux = fn(p, x, cfg)
        return torch.autograd.grad((out * w).sum() + aux, [x, *leaves(p)])

    want = grads(TM.moe_dense)
    monkeypatch.setattr(TM, "GROUP_BYTES", budget)
    a, b = grads(TM.moe), grads(TM.moe)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    for got, ref in zip(a, want):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("budget", [1, 2 ** 30])
def test_padded_slots_read_elsewhere_under_autograd_and_change_no_bit(
        budget, monkeypatch):
    """A padded slot reads no token, with autograd or without: the
    forward under autograd is the same bits as the one without."""
    cfg = get_arch("deepseek-v3-671b").reduced()
    gen = torch.Generator().manual_seed(3)
    p = TM.init_moe(gen, cfg)
    x = torch.randn((2, 11, cfg.d_model), generator=gen)
    monkeypatch.setattr(TM, "GROUP_BYTES", budget)
    with torch.no_grad():
        want, aux = TM.moe(p, x, cfg)
    got, got_aux = TM.moe(p, x.clone().requires_grad_(True), cfg)
    assert got.requires_grad
    assert torch.equal(got.detach(), want) and torch.equal(got_aux, aux)


@pytest.mark.parametrize("budget", [2 ** 15, 2 ** 30])
def test_padded_slots_read_token_0_and_add_nothing_to_its_gradient(
        budget, monkeypatch):
    """Each expert buffer holds its choices' token rows in token order,
    then copies of token 0 up to the group's capacity; the gather's
    backward sums into each token the gradients of its own slots only, even
    where a padded slot's gradient is not 0."""
    cfg = get_arch("olmoe-1b-7b").reduced()
    gen = torch.Generator().manual_seed(5)
    p = TM.init_moe(gen, cfg)
    x = torch.randn((2, 9, cfg.d_model), generator=gen)
    seen = []
    ffn = TM._local_expert_ffn

    def spy(w_gate, w_up, w_down, xb):
        seen.append(xb)
        return ffn(w_gate, w_up, w_down, xb)

    monkeypatch.setattr(TM, "GROUP_BYTES", budget)
    monkeypatch.setattr(TM, "_local_expert_ffn", spy)
    TM.moe(p, x.requires_grad_(True), cfg)
    xt = x.detach().reshape(-1, cfg.d_model)
    _, idx, _ = TM.route(p["router"], xt, cfg.moe)
    chosen = [sorted({t for t, row in enumerate(idx.tolist()) if e in row})
              for e in range(cfg.moe.n_experts)]
    assert all(chosen)          # the seed leaves no expert out of a group
    bufs = [b for xb in seen for b in xb.detach()]     # one (C, d) an expert
    assert len(bufs) == cfg.moe.n_experts
    assert sum(len(buf) - len(toks) for toks, buf in zip(chosen, bufs)) > 0
    for toks, buf in zip(chosen, bufs):
        assert torch.equal(buf[:len(toks)], xt[toks])
        assert torch.equal(buf[len(toks):], xt[:1].expand_as(buf[len(toks):]))
    # a gradient of 1 on every slot: each token gets one a choice of it
    (gx,) = torch.autograd.grad([xb.sum() for xb in seen], [x])
    want = torch.tensor([sum(t in toks for toks in chosen)
                         for t in range(len(xt))], dtype=gx.dtype)
    assert torch.equal(gx.reshape(len(xt), -1),
                       want[:, None].expand(-1, cfg.d_model))


# ---------------------------------------------------------------------------
# the train step, train states and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_one_train_step_matches_the_reference(arch, tie_gaps):
    """A reference MoE train state converted to the port's; one train step
    in each package from it: the same loss, each leaf's first moment to
    1e-4 of its largest, and the parameters where the moment is clear of
    0 (a gradient near 0 whose sign differs moves a weight 2 lr apart)."""
    jcfg = jax_get_arch(arch).reduced()
    jm = jax_build_model(jcfg, jax_run())
    acfg = JAdamWConfig(lr=1e-2)
    js = jax_init_train_state(jm, jax.random.PRNGKey(0), acfg)
    tm = Model(get_arch(arch).reduced(), torch_run(), device="cpu")
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), tm)
    batch = tokens_batch(tm.cfg, seed=9)
    js, jmet = jax.jit(jax_make_train_step(jm, acfg, None))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts, tmet = make_train_step(tm, AdamWConfig(lr=1e-2))(ts, batch)
    assert_no_near_tie(tie_gaps, n_moe_layers(tm.cfg))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               **TOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), **TOL)
    want_keys = {"loss", "ce", "aux", "grad_norm", "lr"} | \
        ({"mtp"} if tm.cfg.mtp_depth else set())
    assert set(tmet) == want_keys
    got = flatten_tree(train_state_to_numpy(ts)["params"])
    m = flatten_tree(train_state_to_numpy(ts)["opt"]["m"])
    want_m = flatten_tree(numpy_tree(js.opt.m))
    for path, w in flatten_tree(numpy_tree(js.params)).items():
        top = max(np.abs(want_m[path]).max(), 1e-30)
        assert np.abs(m[path] - want_m[path]).max() / top < 1e-4, path
        clear = np.abs(want_m[path]) > 1e-5
        np.testing.assert_allclose(got[path][clear], w[clear], err_msg=path,
                                   atol=1e-5, rtol=1e-5)


def test_microbatched_step_reports_the_mean_terms():
    """Two microbatches: the loss and its terms are the means of each
    half's, the gradients' mean gives the single step's update."""
    cfg = get_arch("deepseek-v3-671b").reduced()
    batch = tokens_batch(cfg, seed=8, batch=4)
    acfg = AdamWConfig(lr=1e-2)
    out = []
    for n in (1, 2):
        m = Model(cfg, torch_run(microbatches=n), device="cpu")
        out.append(make_train_step(m, acfg)(init_train_state(m, 3, acfg),
                                            batch))
    (s1, met1), (s2, met2) = out
    m = Model(cfg, torch_run(), device="cpu").init(seed=3)
    halves = [m.loss_fn({k: v[2 * i:2 * i + 2] for k, v in batch.items()})[1]
              for i in range(2)]
    for name in ("ce", "aux", "mtp"):
        mean = (float(halves[0][name]) + float(halves[1][name])) / 2
        assert float(met2[name]) == pytest.approx(mean, rel=1e-6), name
    assert set(met1) == set(met2)
    for path, p in flat_np(s1.params).items():
        np.testing.assert_allclose(flat_np(s2.params)[path], p,
                                   err_msg=path, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ("deepseek-7b",) + MOE_ARCHS)
def test_a_train_step_leaves_nothing_for_the_garbage_collector(arch):
    """With the garbage collector off, three train steps leave the state's
    12 bytes a parameter (weights, m, v) alive and nothing more: no
    reference cycle holds a step's gradients (one did, in ``like_tree``,
    and every step of the train launcher kept 4 bytes a parameter more
    until the collector ran)."""
    import gc
    cfg = get_arch(arch).reduced()
    m = Model(cfg, torch_run("blocked"), device="cpu")
    acfg = AdamWConfig(lr=1e-2)
    state = init_train_state(m, 0, acfg)
    step = make_train_step(m, acfg)
    batch = tokens_batch(cfg, seed=1)
    n = sum(p.numel() for p in m.tree.parameters())

    def alive_bytes():
        storages = {}
        for o in gc.get_objects():
            if issubclass(type(o), torch.Tensor):
                st = o.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
        return sum(storages.values())

    gc.collect()
    gc.disable()
    try:
        for _ in range(3):
            state, metrics = step(state, batch)
        left = alive_bytes()
    finally:
        gc.enable()
    assert 12 * n <= left < 12 * n + 4 * n // 100, left / n


def jax_moe_state(arch):
    jm = jax_build_model(jax_get_arch(arch).reduced(), jax_run())
    return jax_init_train_state(jm, jax.random.PRNGKey(0),
                                JAdamWConfig(lr=1e-2))


def assert_states_equal(port_state, jax_state):
    got = train_state_to_numpy(port_state)
    for path, w in flatten_tree(numpy_tree(jax_state.params)).items():
        np.testing.assert_array_equal(flatten_tree(got["params"])[path], w,
                                      err_msg=path)
    assert int(got["opt"]["step"]) == int(jax_state.opt.step)
    for name in ("m", "v"):
        want = flatten_tree(numpy_tree(getattr(jax_state.opt, name)))
        for path, w in want.items():
            np.testing.assert_array_equal(flatten_tree(got["opt"][name])[path],
                                          w, err_msg=path)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_state_crosses_both_ways(arch):
    """A reference MoE train state (the dense_layers.*, layers.moe.* and
    mtp.* leaves) into the port and back: the same arrays."""
    js = jax_moe_state(arch)
    tm = Model(get_arch(arch).reduced(), torch_run(), device="cpu")
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), tm)
    assert_states_equal(ts, js)
    back = train_state_to_numpy(ts)
    want = flatten_tree(numpy_tree(js.params))
    assert set(flatten_tree(back["params"])) == set(want)
    if tm.cfg.mtp_depth:
        assert {"dense_layers.attn.wdq", "layers.moe.w_gate",
                "mtp.block.moe.router"} <= set(want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reference_moe_checkpoint_restores_into_the_port(arch, tmp_path):
    js = jax_moe_state(arch)
    jax_save(str(tmp_path), 2, js, extra={"step": 2})
    tm = Model(get_arch(arch).reduced(), torch_run(), device="cpu")
    ts = init_train_state(tm, 7, AdamWConfig(lr=1e-2))
    got, extra = restore_checkpoint(str(tmp_path), latest_step(str(tmp_path)),
                                    ts)
    assert got is ts and extra == {"step": 2}
    assert_states_equal(ts, js)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_port_moe_checkpoint_restores_into_the_reference(arch, tmp_path):
    tm = Model(get_arch(arch).reduced(), torch_run(), device="cpu")
    acfg = AdamWConfig(lr=1e-2)
    ts = init_train_state(tm, 5, acfg)
    ts, _ = make_train_step(tm, acfg)(ts, tokens_batch(tm.cfg, seed=9))
    save_checkpoint(str(tmp_path), 1, ts, extra={"step": 1})
    restored, extra = jax_restore(str(tmp_path), 1, jax_moe_state(arch))
    assert extra == {"step": 1}
    assert_states_equal(ts, restored)


# ---------------------------------------------------------------------------
# the chunked in-place AdamW update
# ---------------------------------------------------------------------------


def whole_leaf_update(params, grads, state, cfg, lr_scale):
    """The update as it was written before it was chunked: each leaf's
    arithmetic on whole-leaf float32 temporaries (the reference for the
    bits)."""
    from repro_torch import resolve_dtype
    from repro_torch.optim.adamw import global_norm
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    t = (state.step + 1).float()
    bc1, bc2 = 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32)
    mdt = resolve_dtype(cfg.moment_dtype)
    flat_p = leaves(params)
    source = leaves(state.master) if state.master is not None else flat_p
    for i, (p, g, m, v) in enumerate(zip(flat_p, leaves(grads),
                                         leaves(state.m), leaves(state.v))):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        p32 = source[i].float()
        new = p32 - lr * (m32 / bc1 / ((v32 / bc2).sqrt() + cfg.eps)
                          + cfg.weight_decay * p32)
        if state.master is not None:
            source[i].copy_(new)
        p.copy_(new.to(flat_p[0].dtype))
        m.copy_(m32.to(mdt))
        v.copy_(v32.to(mdt))
    return params, state


def adam_tree(seed, dtype):
    gen = torch.Generator().manual_seed(seed)
    return {"big": torch.randn((37, 11), generator=gen).to(dtype),
            "b": {"c": torch.randn((7,), generator=gen).to(dtype),
                  "d": torch.randn((2, 3, 4), generator=gen).to(dtype)}}


@pytest.mark.parametrize("chunk", [1, 5, 64, 406])
@pytest.mark.parametrize("param_dtype,moment_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32")])
def test_chunked_adamw_equals_the_whole_leaf_update(chunk, param_dtype,
                                                    moment_dtype):
    """Three steps with the chunk bound lowered below the largest leaf
    (407 elements): parameters, m, v and, for bfloat16 parameters, the
    float32 master are the whole-leaf update's to the bit."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    cfg = AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    pa, pb = adam_tree(0, dt), adam_tree(0, dt)
    sa, sb = init_adamw(pa, cfg), init_adamw(pb, cfg)
    assert (sa.master is not None) == (param_dtype == "bfloat16")
    for step in range(3):
        g = adam_tree(10 + step, torch.float32)
        pa, sa, _ = adamw_update(pa, g, sa, cfg, lr_scale=0.5, chunk=chunk)
        pb, sb = whole_leaf_update(pb, g, sb, cfg, 0.5)
        sb = sb._replace(step=sb.step + 1)
        trees = [(pa, pb), (sa.m, sb.m), (sa.v, sb.v)]
        if sa.master is not None:
            trees.append((sa.master, sb.master))
        for a, b in trees:
            for x, y in zip(leaves(a), leaves(b)):
                assert x.dtype == y.dtype and torch.equal(x, y)


def test_adamw_writes_into_the_state_it_is_given():
    """The chunks are views: the update lands in the given tensors, and
    the default bound is 2^26 elements (256 MiB of float32)."""
    assert adamw_module.CHUNK == 1 << 26
    cfg = AdamWConfig(lr=1e-2)
    p = adam_tree(1, torch.float32)
    s = init_adamw(p, cfg)
    before = [t.data_ptr() for t in leaves(p) + leaves(s.m) + leaves(s.v)]
    p0 = [t.clone() for t in leaves(p)]
    p2, s2, _ = adamw_update(p, adam_tree(2, torch.float32), s, cfg, chunk=3)
    assert p2 is p and s2.m is s.m and s2.v is s.v
    assert before == [t.data_ptr() for t in
                      leaves(p2) + leaves(s2.m) + leaves(s2.v)]
    assert all(not torch.equal(a, b) for a, b in zip(p0, leaves(p2)))


# ---------------------------------------------------------------------------
# the train CLI and the planner's train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_cli_runs_the_moe_family_cut_in_depth(arch, capsys, tmp_path):
    cfg = get_arch(arch).reduced()
    n = cfg.moe.first_dense_layers + 1
    state, report = train_cli.main([
        "--arch", arch, "--reduced", "--layers", str(n), "--device", "cpu",
        "--steps", "12", "--batch", "4", "--seq", "16", "--lr", "1e-2",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "6"])
    out = capsys.readouterr().out
    assert f"{n} layers" in out and "active a token" in out
    assert "router aux" in out
    assert len(report.losses) == 12 == len(report.aux)
    assert all(np.isfinite(report.losses)) and all(np.isfinite(report.aux))
    assert report.losses[-1] < report.losses[0]
    assert int(state.opt.step) == 12 and latest_step(str(tmp_path)) == 12
    assert state.params["layers"]["moe"]["w_gate"].shape[0] == \
        n - cfg.moe.first_dense_layers


def test_train_cli_refuses_a_depth_with_no_moe_layer():
    with pytest.raises(ValueError, match="dense layers"):
        train_cli.main(["--arch", "deepseek-v3-671b", "--layers", "3",
                        "--device", "cpu"])
    with pytest.raises(ValueError, match="dense layers"):
        train_cli.main(["--arch", "olmoe-1b-7b", "--reduced", "--layers",
                        "0", "--device", "cpu"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_build_step_runs_a_moe_train_step_on_the_cpu(arch):
    cfg = get_arch(arch).reduced()
    cfg = replace(cfg, n_layers=cfg.moe.first_dense_layers + 2)
    shape = ShapeConfig("train", 16, 2, "train")
    step = build_step(cfg, shape, device="cpu", seed=3)
    out, again = step(), step()
    assert np.isfinite(float(out["loss"])) and float(out["aux"]) > 0
    assert float(out["loss"]) == float(again["loss"])
    assert ("mtp" in out) == bool(cfg.mtp_depth)
