"""The port's training path against the reference's, on the CPU, reduced
deepseek-7b in float32: loss and gradients of one step, the AdamW step, the
schedule, gradient compression, cross entropy, checkpoints across the two
packages, and torch analogues of tests/test_system.py and
tests/test_checkpoint.py. Tolerances: 2e-5 on the loss and gradients (the
same float32 arithmetic, sums over the width taken in another order), 1e-6
on an AdamW step (elementwise float32, the same order of operations)."""
import os
import time

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
from repro.models.layers import cross_entropy as jax_cross_entropy
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import compress_grads_bf16 as jax_compress
from repro.optim import cosine_warmup as jax_cosine_warmup
from repro.optim import init_adamw as jax_init_adamw
from repro.train.step import init_train_state as jax_init_train_state

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    leaf_paths, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import RunConfig, get_arch
from repro_torch.convert import (flatten_tree, params_from_numpy,
                                 train_state_from_numpy, train_state_to_numpy,
                                 unflatten_tree)
from repro_torch.data.pipeline import (LoaderState, ShardedLoader,
                                       SyntheticLMDataset, make_batch_fn)
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.optim import (AdamWConfig, OptState, adamw_update,
                               compress_grads_bf16, cosine_warmup,
                               global_norm, init_adamw)
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import (init_train_state, loss_and_grads,
                                    make_eval_step, make_train_step)
from test_torch_parity import as_f32, numpy_tree, to_jax, to_torch

TOL = dict(atol=2e-5, rtol=2e-5)
ADAM_TOL = dict(atol=1e-6, rtol=1e-6)
ARCH = "deepseek-7b"


def jax_run(attn_impl="full", **kw):
    return JRunConfig(attn_impl=attn_impl, remat="nothing",
                      compute_dtype="float32", attn_block_q=8,
                      attn_block_kv=8, **kw)


def torch_run(attn_impl="full", **kw):
    kw = {"remat": "nothing", **kw}
    return RunConfig(attn_impl=attn_impl, compute_dtype="float32",
                     attn_block_q=8, attn_block_kv=8, **kw)


def tokens_batch(cfg, B=4, S=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def flat_np(tree):
    """A tree of torch tensors or JAX arrays as {path: float32 numpy}."""
    return {k: as_f32(v) if isinstance(v, torch.Tensor)
            else np.asarray(jnp.asarray(v).astype(jnp.float32))
            for k, v in flatten_tree(tree).items()}


# ---------------------------------------------------------------------------
# one step against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["full", "blocked", "zigzag"])
def test_loss_and_grads_match_jax(impl):
    """One step's loss and every leaf's gradient against jax.value_and_grad
    of the reference's loss_fn, on converted params, labels with masked
    (< 0) positions; blocks of 8 over 16 tokens."""
    jcfg, cfg = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jm = jax_build_model(jcfg, jax_run(impl))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = params_from_numpy(numpy_tree(jp),
                           Model(cfg, torch_run(impl), device="cpu"))
    batch = tokens_batch(cfg)
    batch["labels"][0, :3] = -1
    (want, _), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    loss, metrics, grads = loss_and_grads(tm.trainable(), tm.params, batch)
    np.testing.assert_allclose(float(loss), float(want), **TOL)
    assert float(metrics["ce"]) == float(loss)
    got, ref = flat_np(grads), flat_np(jg)
    assert set(got) == set(ref)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], err_msg=path, **TOL)


@pytest.mark.parametrize("remat", ["boundaries", "dots"])
def test_remat_policies_give_the_same_gradients(remat):
    """Checkpointed layers (every activation recomputed, or all but the
    products with weights) give the gradients of the plain stack."""
    cfg = get_arch(ARCH).reduced()
    batch = tokens_batch(cfg, seed=2)
    out = []
    for policy in ("nothing", remat):
        m = Model(cfg, torch_run("blocked", remat=policy), device="cpu")
        m.init(seed=3).trainable()
        out.append(loss_and_grads(m, m.params, batch))
    assert float(out[0][0]) == pytest.approx(float(out[1][0]), rel=1e-6)
    for path, g in flat_np(out[0][2]).items():
        np.testing.assert_allclose(flat_np(out[1][2])[path], g,
                                   err_msg=path, **TOL)


def test_forward_under_grad_matches_the_no_grad_forward():
    """The grad-enabled forward (layers taken out by unbind) is the serving
    forward's function."""
    cfg = get_arch(ARCH).reduced()
    m = Model(cfg, torch_run("blocked"), device="cpu").init(seed=4)
    toks = tokens_batch(cfg)["tokens"]
    lg = m.trainable()._forward(m.params, {"tokens": toks})
    assert lg.requires_grad
    torch.testing.assert_close(lg.detach(), m.forward({"tokens": toks}),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_matches_jax(z_loss):
    """Value and gradient, labels < 0 masked, padded vocabulary columns at
    -1e30 that no label points at."""
    rng = np.random.default_rng(5)
    lg = rng.standard_normal((2, 6, 40), dtype=np.float32) * 3
    lg[..., 33:] = -1e30
    labels = rng.integers(0, 33, size=(2, 6)).astype(np.int32)
    labels[1, 2:4] = -1
    want, jg = jax.value_and_grad(
        lambda x: jax_cross_entropy(x, jnp.asarray(labels), z_loss))(
            jnp.asarray(lg))
    x = to_torch(lg).requires_grad_()
    got = L.cross_entropy(x, torch.from_numpy(labels).long(), z_loss)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(as_f32(x.grad), np.asarray(jg), **TOL)
    assert float(x.grad[..., 33:].abs().max()) == 0.0
    assert float(x.grad[1, 2:4].abs().max()) == 0.0
    none = torch.full((2, 6), -1, dtype=torch.long)
    assert float(L.cross_entropy(to_torch(lg), none)) == 0.0


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def random_tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((6, 5)).astype(dtype),
            "b": {"c": rng.standard_normal((7,)).astype(dtype),
                  "d": rng.standard_normal((2, 3, 4)).astype(dtype)}}


def to_torch_tree(tree, dtype: str):
    return {k: to_torch_tree(v, dtype) if isinstance(v, dict)
            else to_torch(np.asarray(v, np.float32), dtype)
            for k, v in tree.items()}


def to_jax_tree(tree, dtype):
    return jax.tree.map(lambda a: to_jax(np.asarray(a, np.float32), dtype),
                        tree)


@pytest.mark.parametrize("param_dtype,moment_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("float32", "bfloat16")])
def test_adamw_steps_match_jax(param_dtype, moment_dtype):
    """Two AdamW steps from the same params and grads (bias corrections at
    t = 1 and 2, clipping on: the grads' norm is above 1). Float32 leaves at
    1e-6; a leaf stored in bfloat16 may sit one rounding apart where the
    float32 values straddle a rounding boundary, so it is held to 1e-6 plus
    bfloat16's 2^-8 relative."""
    cfg_kw = dict(lr=1e-2, moment_dtype=moment_dtype, weight_decay=0.1)
    jcfg, tcfg = JAdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)
    p0 = random_tree(0)
    jp = to_jax_tree(p0, param_dtype)
    tp = to_torch_tree(p0, param_dtype)
    js, ts = jax_init_adamw(jp, jcfg), init_adamw(tp, tcfg)
    assert (js.master is None) == (ts.master is None) == \
        (param_dtype == "float32")
    for step in range(2):
        g = random_tree(10 + step)
        jp, js, jmet = jax_adamw_update(jp, to_jax_tree(g, "float32"), js,
                                        jcfg, lr_scale=0.5)
        tp, ts, tmet = adamw_update(tp, to_torch_tree(g, "float32"), ts,
                                    tcfg, lr_scale=0.5)
        assert int(ts.step) == int(js.step) == step + 1
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-6)
        pairs = [(tp, jp, param_dtype), (ts.m, js.m, moment_dtype),
                 (ts.v, js.v, moment_dtype)]
        if ts.master is not None:
            pairs.append((ts.master, js.master, "float32"))
        for got, want, dt in pairs:
            tol = ADAM_TOL if dt == "float32" else dict(atol=1e-6,
                                                        rtol=2 ** -8)
            for path, w in flat_np(want).items():
                np.testing.assert_allclose(flat_np(got)[path], w,
                                           err_msg=path, **tol)


def test_global_norm_holds_float32_over_millions_of_elements():
    """The clip's norm over 8e6 elements (a slice of an embedding's
    gradient) within 1e-6 of float64: the fault the card-vs-CPU train
    parity found, where the CPU's vector_norm lost 0.74 % of the norm."""
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        8_000_000, dtype=np.float32) * 1e-3)
    want = float(torch.linalg.vector_norm(x.double()))
    tree = {"a": x[:5_000_000], "b": {"c": x[5_000_000:]}}
    assert abs(float(global_norm(tree)) / want - 1) < 1e-6


def test_cosine_warmup_matches_jax():
    for step in (0, 1, 50, 99, 100, 101, 2500, 9999, 10000, 20000):
        want = jax_cosine_warmup(step, warmup=100, total=10000)
        got = cosine_warmup(torch.tensor(step, dtype=torch.int32),
                            warmup=100, total=10000)
        np.testing.assert_allclose(float(got), float(want), atol=1e-7,
                                   err_msg=str(step))


def test_compress_grads_bf16_matches_jax():
    """bf16(g + r) is the same rounding on both sides (equal bits), and the
    residual the same float32 difference; twice, the second from the first
    residual (updated in place in the port)."""
    g = to_jax_tree(random_tree(20), "float32")
    tg = to_torch_tree(random_tree(20), "float32")
    jr = tr = None
    for _ in range(2):
        jq, jr = jax_compress(g, jr)
        tq, tr = compress_grads_bf16(tg, tr)
        for path, w in flat_np(jq).items():
            assert flatten_tree(tq)[path].dtype == torch.bfloat16
            np.testing.assert_array_equal(flat_np(tq)[path], w)
        for path, w in flat_np(jr).items():
            np.testing.assert_allclose(flat_np(tr)[path], w, atol=1e-7)


# ---------------------------------------------------------------------------
# train states and checkpoints across the packages
# ---------------------------------------------------------------------------


def jax_state(grad_compression=False):
    jcfg = jax_get_arch(ARCH).reduced()
    jm = jax_build_model(jcfg, jax_run(grad_compression=grad_compression))
    return jax_init_train_state(jm, jax.random.PRNGKey(0),
                                JAdamWConfig(lr=1e-2))


def torch_model(**run):
    return Model(get_arch(ARCH).reduced(), torch_run(**run), device="cpu")


def assert_states_equal(port_state, jax_state_):
    got = flatten_tree(train_state_to_numpy(port_state)["params"])
    for path, w in flatten_tree(numpy_tree(jax_state_.params)).items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    opt = train_state_to_numpy(port_state)["opt"]
    assert int(opt["step"]) == int(jax_state_.opt.step)
    for name in ("m", "v"):
        want = flatten_tree(numpy_tree(getattr(jax_state_.opt, name)))
        for path, w in want.items():
            np.testing.assert_array_equal(flatten_tree(opt[name])[path], w)


def test_train_states_cross_and_one_step_matches():
    """A reference train state converted to the port's and back; then one
    train step in each package from it: the same loss, params to 1e-6."""
    jcfg = jax_get_arch(ARCH).reduced()
    jm = jax_build_model(jcfg, jax_run())
    acfg = JAdamWConfig(lr=1e-2)
    js = jax_init_train_state(jm, jax.random.PRNGKey(0), acfg)
    tm = torch_model()
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), tm)
    assert all(p.requires_grad for p in tm.tree.parameters())
    assert ts.opt.master is None and ts.residual is None
    assert_states_equal(ts, js)

    from repro.train.step import make_train_step as jax_make_train_step
    batch = tokens_batch(get_arch(ARCH).reduced(), seed=6)
    js, jmet = jax.jit(jax_make_train_step(jm, acfg, None))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts, tmet = make_train_step(tm, AdamWConfig(lr=1e-2))(ts, batch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               **TOL)
    # after step 1 each weight moves by about lr * sign(g): a gradient
    # near 0 whose sign differs moves it 2 lr apart, so the check is on the
    # moments and on the params where the first moment is clear of 0
    got = flatten_tree(train_state_to_numpy(ts)["params"])
    m = flatten_tree(train_state_to_numpy(ts)["opt"]["m"])
    want_m = flatten_tree(numpy_tree(js.opt.m))
    for path, w in flatten_tree(numpy_tree(js.params)).items():
        clear = np.abs(want_m[path]) > 1e-5
        np.testing.assert_allclose(got[path][clear], w[clear], err_msg=path,
                                   **ADAM_TOL)
        np.testing.assert_allclose(m[path], want_m[path], err_msg=path,
                                   atol=1e-8, rtol=2e-5)


@pytest.mark.parametrize("grad_compression", [False, True])
def test_reference_checkpoint_restores_into_the_port(tmp_path,
                                                     grad_compression):
    js = jax_state(grad_compression)
    jax_save(str(tmp_path), 3, js, extra={"step": 3})
    tm = torch_model(grad_compression=grad_compression)
    ts = init_train_state(tm, 7, AdamWConfig(lr=1e-2))
    assert (ts.residual is None) == (not grad_compression)
    got, extra = restore_checkpoint(str(tmp_path), latest_step(str(tmp_path)),
                                    ts)
    assert got is ts and extra == {"step": 3}
    assert_states_equal(ts, js)
    if grad_compression:
        for path, w in flatten_tree(numpy_tree(js.residual)).items():
            np.testing.assert_array_equal(
                flatten_tree(train_state_to_numpy(ts)["residual"])[path], w)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    tm = torch_model()
    acfg = AdamWConfig(lr=1e-2)
    ts = init_train_state(tm, 5, acfg)
    ts, _ = make_train_step(tm, acfg)(ts, tokens_batch(tm.cfg, seed=7))
    save_checkpoint(str(tmp_path), 1, ts, extra={"step": 1})
    js = jax_state()
    with open(tmp_path / "step_1" / "manifest.json") as f:
        import json
        keys = set(json.load(f)["leaves"])
    want_keys = {jax.tree_util.keystr(p)
                 for p, _ in jax.tree_util.tree_flatten_with_path(js)[0]}
    assert keys == want_keys and ".opt.step" in keys and \
        ".params['layers']['attn']['wq']" in keys
    restored, extra = jax_restore(str(tmp_path), 1, js)
    assert extra == {"step": 1}
    assert_states_equal(ts, restored)


def small_tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "d": torch.tensor(3, dtype=torch.int32),
                  "e": torch.linspace(-2, 2, 6).to(torch.bfloat16)}}


def zeros_like_tree(tree):
    return {k: zeros_like_tree(v) if isinstance(v, dict)
            else torch.zeros_like(v) for k, v in tree.items()}


def test_checkpoint_roundtrip(tmp_path):
    t = small_tree()
    save_checkpoint(str(tmp_path), 7, t, extra={"step": 7, "note": "x"})
    assert latest_step(str(tmp_path)) == 7
    like = zeros_like_tree(t)
    got, extra = restore_checkpoint(str(tmp_path), 7, like)
    assert extra["note"] == "x" and got is like
    for (ka, a), (kb, b) in zip(leaf_paths(t), leaf_paths(got)):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, small_tree())
    bad = zeros_like_tree(small_tree())
    bad["a"] = torch.zeros((2, 2))
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), 1, bad)
    assert float(bad["b"]["c"].abs().sum()) == 0.0    # nothing copied
    del bad["a"]
    bad["z"] = torch.zeros(1)
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), 1, bad)


def test_checkpoint_async_and_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    t = small_tree()
    for s in (10, 20, 30, 40):
        ck.save(s, t, extra={"step": s})
        t["a"].add_(1.0)            # the snapshot is taken at save()
    ck.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path))
    assert steps == [30, 40]
    like = zeros_like_tree(t)
    _, extra = restore_checkpoint(str(tmp_path), 40, like)
    assert extra["step"] == 40
    assert torch.equal(like["a"], t["a"] - 1.0)


def test_checkpoint_tmp_dirs_are_not_latest(tmp_path):
    os.makedirs(tmp_path / "step_99.tmp")
    save_checkpoint(str(tmp_path), 5, small_tree())
    assert latest_step(str(tmp_path)) == 5


# ---------------------------------------------------------------------------
# torch analogues of tests/test_system.py
# ---------------------------------------------------------------------------


def setup(run=None, lr=1e-2, steps=30, seed=0):
    run = run or torch_run()
    model = Model(get_arch(ARCH).reduced(), run, device="cpu")
    acfg = AdamWConfig(lr=lr, moment_dtype=run.moment_dtype)
    state = init_train_state(model, seed, acfg)
    step = make_train_step(model, acfg, total_steps=steps)
    loader = ShardedLoader(SyntheticLMDataset(model.cfg.vocab_size, 0), 8, 32)
    return model, state, step, loader


def quiet(msg):
    pass


def test_training_reduces_loss():
    _, state, step, loader = setup()
    state, report = train_loop(state, step, loader,
                               LoopConfig(total_steps=30, log_every=0),
                               log=quiet)
    assert np.mean(report.losses[-3:]) < np.mean(report.losses[:3]) * 0.8


def test_microbatched_step_matches_single():
    """Gradient accumulation is exact: 4 microbatches == 1 big batch."""
    cfg = get_arch(ARCH).reduced()
    acfg = AdamWConfig(lr=1e-3)
    states, metrics = [], []
    batch = tokens_batch(cfg, B=8, S=32, seed=8)
    for n in (1, 4):
        m = Model(cfg, torch_run(microbatches=n), device="cpu")
        s = init_train_state(m, 0, acfg)
        s, met = make_train_step(m, acfg)(s, batch)
        states.append(flat_np(s.params))
        metrics.append(float(met["loss"]))
    for path, a in states[0].items():
        np.testing.assert_allclose(states[1][path], a, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(metrics[1], metrics[0], rtol=1e-4)


def test_checkpoint_resume_is_exact(tmp_path):
    """Training 30 steps straight == training 15, restarting, training 15."""
    ck = str(tmp_path / "ck")
    _, state, step, loader = setup()
    state_a, _ = train_loop(state, step, loader,
                            LoopConfig(total_steps=30, log_every=0),
                            log=quiet)
    want = flat_np(state_a.params)
    _, state2, step2, loader1 = setup()
    train_loop(state2, step2, loader1,
               LoopConfig(total_steps=15, log_every=0, ckpt_dir=ck,
                          ckpt_every=100), log=quiet)
    _, state3, step3, loader2 = setup(seed=9)   # other weights, overwritten
    msgs = []
    s_res, report = train_loop(
        state3, step3, loader2,
        LoopConfig(total_steps=30, log_every=0, ckpt_dir=ck, ckpt_every=100),
        log=msgs.append)
    assert report.final_step == 30 and len(report.losses) == 15
    assert any("[resume] restored step 15" in m for m in msgs)
    assert loader2.state.step == 30
    for path, a in flat_np(s_res.params).items():
        np.testing.assert_allclose(a, want[path], atol=1e-5, rtol=1e-5)


def test_grad_compression_still_converges():
    _, state, step, loader = setup(run=torch_run(grad_compression=True))
    assert state.residual is not None
    _, report = train_loop(state, step, loader,
                           LoopConfig(total_steps=30, log_every=0), log=quiet)
    assert np.mean(report.losses[-3:]) < np.mean(report.losses[:3]) * 0.85


def test_bf16_moments_still_converge():
    _, state, step, loader = setup(run=torch_run(moment_dtype="bfloat16"))
    assert state.opt.m["embed"].dtype == torch.bfloat16
    _, report = train_loop(state, step, loader,
                           LoopConfig(total_steps=30, log_every=0), log=quiet)
    assert np.mean(report.losses[-3:]) < np.mean(report.losses[:3]) * 0.85


def test_nan_guard_aborts():
    _, state, step, loader = setup()

    def bad_step(state, batch):
        state, _ = step(state, batch)
        return state, {"loss": torch.tensor(float("nan"))}

    with pytest.raises(FloatingPointError):
        train_loop(state, bad_step, loader,
                   LoopConfig(total_steps=5, log_every=0), log=quiet)
    assert loader._stop.is_set()        # the loop closed the loader


def test_straggler_detection():
    """One step slowed by 1.5 s stands out of the steps' EWMA. The steps
    run on one thread: on a host shared with other test workers, a step on
    eight threads can take seconds, which would hide the slow one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model, state, step, loader = setup()
        # one step first, so that the first call's own cost does not set
        # the EWMA, as the reference's test warms up its jit
        state, _ = step(state, tokens_batch(model.cfg, B=8, S=32, seed=12))
        calls = {"n": 0}

        def slow_step(state, batch):
            calls["n"] += 1
            out = step(state, batch)
            if calls["n"] == 10:
                time.sleep(1.5)
            return out

        msgs = []
        _, report = train_loop(
            state, slow_step, loader,
            LoopConfig(total_steps=12, log_every=0, straggler_factor=3.0),
            log=msgs.append)
    finally:
        torch.set_num_threads(threads)
    assert 9 in report.stragglers, (msgs, report.step_times)


def test_eval_step_is_the_loss_without_a_graph():
    model, state, _, _ = setup()
    batch = tokens_batch(model.cfg, seed=10)
    loss = make_eval_step(model)(state.params, batch)
    assert not loss.requires_grad
    want = float(model.loss_fn(batch)[0].detach())
    assert float(loss) == pytest.approx(want, rel=1e-6)


def test_loader_matches_the_batch_function_and_resumes():
    ds = SyntheticLMDataset(1000, 3)
    loader = ShardedLoader(ds, 2, 16)
    first = [next(loader) for _ in range(3)]
    loader.close()
    fn = make_batch_fn(1000, 2, 16, seed=3)
    for step, b in enumerate(first):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k], fn(step)[k])
    again = ShardedLoader(ds, 2, 16, state=LoaderState(2))
    np.testing.assert_array_equal(next(again)["tokens"], first[2]["tokens"])
    again.close()
    assert not again._thread.is_alive()


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    """The command line, reduced, on the CPU: a loss that falls; past 512
    tokens it takes blocked attention; --layers cuts the depth."""
    state, report = train_cli.main(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "12",
         "--batch", "4", "--seq", "32", "--lr", "1e-2", "--ckpt-dir",
         str(tmp_path), "--ckpt-every", "5"])
    assert report.final_step == 12 and report.losses[-1] < report.losses[0]
    assert latest_step(str(tmp_path)) == 12
    _, report = train_cli.main(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "1",
         "--batch", "1", "--seq", "520", "--layers", "1"])
    assert report.final_step == 1 and np.isfinite(report.losses[0])
    out = capsys.readouterr().out
    assert "1 layers" in out and "[done]" in out
