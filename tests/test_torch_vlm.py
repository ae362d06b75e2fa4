"""The VLM family (llama-3.2-vision-90b) in the port against the JAX package,
float32 on the CPU, on the same numpy inputs and on weights carried across:
cross-attention (gated and not, a sequence and a one-row query), the cross
block, the whole model reduced (a period of 2, 16 media tokens): forward,
prefill, decode, caches, conversion, parameter counts, the engine and the
command line. Every parity sets the tanh gates nonzero (they start at 0,
which would hide the cross path) and draws the media from a seed: constant
media make every key equal and the softmax uniform. Tolerances are the
existing model tests' (logits 1e-4, decode against forward 5e-4).
``build_step``'s serving modes for the vlm and audio families are here too;
their training is in ``tests/test_torch_train_families.py``."""
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import analytic_param_count as jax_param_count
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import cut_depth, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import (caches_from_numpy, caches_to_numpy,
                                 params_to_numpy)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.dryrun import build_step
from repro_torch.models import Model, analytic_param_count
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import Request, ServeEngine, _reset_slot
from test_torch_parity import (as_f32, layer_of, model_pair, numpy_tree,
                               torch_run)

ARCH = "llama-3.2-vision-90b"
B, S, MAX_LEN = 2, 10, 16
MODEL = dict(atol=1e-4, rtol=1e-4)
GATES = (0.5, -0.7)          # one a group of the reduced config


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def tokens_for(cfg, seed=0, batch=B, seq=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(batch, seq))


def media_for(cfg, seed=7, batch=B):
    return randn(seed, batch, cfg.cross_attn.n_media_tokens, cfg.d_model)


def set_gates(jp):
    jp["layers"]["cross"]["attn"]["gate"] = jnp.asarray(GATES, jnp.float32)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, torch model) of reduced llama-3.2-vision-90b
    with the gates set nonzero, the kernel switch on in both packages."""
    return model_pair(jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced(),
                      edit=set_gates)


def batches(cfg, toks, media):
    return ({"tokens": jnp.asarray(toks), "media": jnp.asarray(media)},
            {"tokens": toks, "media": media})


# ---------------------------------------------------------------------------
# cross-attention and the cross block, on weights carried across
# ---------------------------------------------------------------------------


def test_config_is_the_references():
    assert asdict(get_arch(ARCH)) == asdict(jax_get_arch(ARCH))
    cfg = get_arch(ARCH).reduced()
    assert (cfg.cross_attn.period, cfg.cross_attn.n_media_tokens) == (2, 16)


@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("gated", [True, False])
def test_cross_attn_kv_and_cross_attn(pair, gated, rows):
    """A sequence of 5 query rows and a decode step's one, both through the
    softmax core of `run.attn_impl` (the plain version here)."""
    jm, jp, tm = pair
    jl, tl = layer_of(jp["layers"]["cross"]["attn"], 1)
    assert float(tl["gate"]) == pytest.approx(GATES[1])
    media = media_for(tm.cfg)
    jkv = JA.cross_attn_kv(jl, jnp.asarray(media))
    tkv = TA.cross_attn_kv(tl, torch.from_numpy(media))
    for got, want in zip(tkv, jkv):
        assert got.is_contiguous()
        np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    x = randn(11, B, rows, tm.cfg.d_model)
    want = JA.cross_attn(jl, jnp.asarray(x), jkv, jm.run, gated=gated)
    got = TA.cross_attn(tl, torch.from_numpy(x), tkv, tm.run, gated=gated)
    assert tuple(got.shape) == (B, rows, tm.cfg.d_model)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    for impl in ("full", "blocked"):
        other = TA.cross_attn(tl, torch.from_numpy(x), tkv, torch_run(impl),
                              gated=gated)
        np.testing.assert_allclose(as_f32(other), as_f32(got), **MODEL)


def test_cross_block(pair):
    jm, jp, tm = pair
    jl, tl = layer_of(jp["layers"]["cross"], 0)
    media = media_for(tm.cfg, seed=12)
    x = randn(13, B, 6, tm.cfg.d_model)
    want, _ = JT.block(jl, jnp.asarray(x), jm.cfg, jm.run, kind="cross",
                       media_kv=JA.cross_attn_kv(jl["attn"],
                                                 jnp.asarray(media)))
    got, aux = TT.block(tl, torch.from_numpy(x), tm.cfg, tm.run, kind="cross",
                        media_kv=TA.cross_attn_kv(tl["attn"],
                                                  torch.from_numpy(media)))
    assert float(aux) == 0.0
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    # the one-token decode through the block: no cache, the same output
    one, cache = TT.block_decode(tl, torch.from_numpy(x[:, :1]), None,
                                 tm.cfg, tm.run, kind="cross",
                                 media_kv=TA.cross_attn_kv(
                                     tl["attn"], torch.from_numpy(media)))
    assert cache is None
    np.testing.assert_allclose(as_f32(one), as_f32(want[:, :1]), **MODEL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward_matches_jax_with_the_kernel_switch_on(pair):
    jm, jp, tm = pair
    assert jm.run.attn_impl == "pallas" and tm.run.attn_impl == "kernel"
    jb, tb = batches(tm.cfg, tokens_for(tm.cfg), media_for(tm.cfg))
    want, _ = jm.forward(jp, jb)
    got = tm.forward(tb)
    assert tuple(got.shape) == (B, S, tm.padded_vocab)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)


def test_the_gates_open_the_cross_path(pair):
    """With the gates at their init (0) the media change nothing; with them
    set, the logits move with the media."""
    _, _, tm = pair
    toks = tokens_for(tm.cfg, seed=4)
    a = tm.forward({"tokens": toks, "media": media_for(tm.cfg, seed=1)})
    b = tm.forward({"tokens": toks, "media": media_for(tm.cfg, seed=2)})
    assert float((a - b).abs().max()) > 1e-2
    closed = Model(tm.cfg, tm.run, device="cpu")
    closed.load_state_dict(tm.state_dict())
    closed.params["layers"]["cross"]["attn"]["gate"].zero_()
    a = closed.forward({"tokens": toks, "media": media_for(tm.cfg, seed=1)})
    b = closed.forward({"tokens": toks, "media": media_for(tm.cfg, seed=2)})
    assert torch.equal(a, b)


def test_prefill_returns_last_logits_and_zeroed_caches(pair):
    """As the reference: forward, then freshly zeroed caches; the logits
    are a copy of the last position."""
    jm, jp, tm = pair
    jb, tb = batches(tm.cfg, tokens_for(tm.cfg, seed=2), media_for(tm.cfg))
    want, wc = jm.prefill(jp, jb, MAX_LEN)
    got, gc = tm.prefill(tb, MAX_LEN)
    assert tuple(got.shape) == (B, 1, tm.padded_vocab)
    assert got.untyped_storage().nbytes() == B * tm.padded_vocab * 4
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    assert sorted(gc) == sorted(wc) == ["k", "pos", "v"]
    for name, leaf in wc.items():
        assert tuple(gc[name].shape) == tuple(leaf.shape)
        assert float(gc[name].abs().max()) == 0.0
    G, P = 2, 1
    assert tuple(gc["k"].shape) == (G, P, B, MAX_LEN, tm.cfg.n_kv_heads,
                                    tm.cfg.d_head)
    assert gc["pos"].dtype == torch.int32


def test_init_caches_are_the_references_tree(pair):
    jm, _, tm = pair
    want = jm.init_caches(3, 12)
    got = tm.init_caches(3, 12)
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == tuple(leaf.shape)
        assert got[name].dtype == {jnp.float32: torch.float32,
                                   jnp.int32: torch.int32}[leaf.dtype.type]
        assert float(got[name].abs().max()) == 0.0


def test_decode_matches_own_forward_and_jax(pair):
    jm, jp, tm = pair
    n = 6
    toks, media = tokens_for(tm.cfg, seed=3, seq=n), media_for(tm.cfg)
    full = tm.forward({"tokens": toks, "media": media})
    caches, jcaches = tm.init_caches(B, n), jm.init_caches(B, n)
    k = caches["k"]
    steps = []
    for t in range(n):
        lg, caches = tm.decode_step({"tokens": toks[:, t:t + 1],
                                     "media": media}, caches)
        jlg, jcaches = jm.decode_step(
            jp, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                 "media": jnp.asarray(media)}, jcaches)
        steps.append(lg[:, 0])
        np.testing.assert_allclose(as_f32(lg), as_f32(jlg), **MODEL)
    assert caches["k"] is k                       # updated in place
    err = float((full - torch.stack(steps, 1)).abs().max())
    assert err < 5e-4, f"decode mismatch {err}"
    for name, leaf in caches.items():
        np.testing.assert_allclose(as_f32(leaf), as_f32(jcaches[name]),
                                   **MODEL)


def test_params_and_caches_round_trip(pair):
    jm, jp, tm = pair
    back = params_to_numpy(tm)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(tm.state_dict())
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert back["layers"]["cross"]["attn"]["gate"].shape == (2,)
    assert back["layers"]["self"]["attn"]["wq"].shape[:2] == (2, 1)
    # caches after two steps of the reference decode on in the port
    toks, media = tokens_for(tm.cfg, seed=6), media_for(tm.cfg)
    jc = jm.init_caches(B, MAX_LEN)
    for t in range(2):
        _, jc = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                    "media": jnp.asarray(media)}, jc)
    tc = caches_from_numpy(numpy_tree(jc), tm)
    assert tuple(tc["k"].shape) == (2, 1, B, MAX_LEN, tm.cfg.n_kv_heads,
                                    tm.cfg.d_head)
    nxt = {"tokens": toks[:, 2:3], "media": media}
    lg, tc = tm.decode_step(nxt, tc)
    jlg, jc2 = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, 2:3]),
                                   "media": jnp.asarray(media)}, jc)
    np.testing.assert_allclose(as_f32(lg), as_f32(jlg), **MODEL)
    out = caches_to_numpy(tc)
    for name, leaf in out.items():
        np.testing.assert_allclose(leaf, np.asarray(jc2[name]), **MODEL)
    with pytest.raises(ValueError, match="k"):
        caches_from_numpy({**out, "k": out["k"][..., :-1]}, tm)
    with pytest.raises(KeyError):
        caches_from_numpy({"k": out["k"], "v": out["v"]}, tm)


def test_param_count_equals_jax_and_init():
    for jcfg, cfg in ((jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()),
                      (jax_get_arch(ARCH), get_arch(ARCH))):
        assert analytic_param_count(cfg) == jax_param_count(jcfg)
    cfg = get_arch(ARCH).reduced()
    model = Model(cfg, device="cpu").init(seed=0)
    assert analytic_param_count(cfg) == sum(
        p.numel() for p in model.tree.parameters())
    assert get_arch(ARCH).param_count() == 87_666_794_516
    # the card's cut: two groups of five layers at full width
    cut = replace(get_arch(ARCH), n_layers=10)
    assert cut.param_count() == 10_657_898_498 == jax_param_count(
        replace(jax_get_arch(ARCH), n_layers=10))


def test_init_is_seeded_and_the_gates_start_closed():
    cfg = get_arch(ARCH).reduced()
    a = Model(cfg, device="cpu").init(seed=3).state_dict()
    b = Model(cfg, device="cpu").init(seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["layers.cross.attn.gate"].abs().max()) == 0.0
    assert not torch.equal(a["layers.cross.attn.wq"][0],
                           a["layers.cross.attn.wq"][1])
    assert not torch.equal(a["layers.self.attn.wq"][0, 0],
                           a["layers.self.attn.wq"][1, 0])


# ---------------------------------------------------------------------------
# the engine and the command line
# ---------------------------------------------------------------------------


def test_same_greedy_tokens_as_the_jax_engine():
    """Both engines feed their all-zero media: the reference's in float32,
    the port's in the compute dtype, which the model takes without a copy."""
    jm, jp, tm = model_pair(jax_get_arch(ARCH).reduced(),
                            get_arch(ARCH).reduced(), jax_attn="full",
                            edit=set_gates)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, tm.cfg.vocab_size, size=n).tolist()
               for n in (3, 5, 2)]
    jeng = JServeEngine(jm, jp, slots=2, max_len=32)
    teng = ServeEngine(tm, slots=2, max_len=32)
    assert teng._extras["media"].shape == (2, 16, tm.cfg.d_model)
    assert float(teng._extras["media"].abs().max()) == 0.0
    assert tm._extra(teng._extras, "media") is teng._extras["media"]
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid, prompt=list(prompt), max_new_tokens=5))
        teng.submit(Request(rid, prompt=list(prompt), max_new_tokens=5))
    want = {r.rid: r.out_tokens for r in jeng.run()}
    got = {r.rid: r.out_tokens for r in teng.run()}
    assert got == want


def test_reset_slot_clears_the_nested_caches(pair):
    _, _, tm = pair
    caches = tm.init_caches(3, 8)
    for leaf in caches.values():
        leaf.fill_(1)
    assert _reset_slot(caches, 1) is caches
    for name, leaf in caches.items():             # batch axis 2
        assert float(leaf.select(2, 1).abs().sum()) == 0.0, name
        assert bool((leaf.select(2, 0) == 1).all()), name
        assert bool((leaf.select(2, 2) == 1).all()), name


def test_layers_are_whole_groups():
    """--layers keeps a cross-attention layer: below one period it is
    refused, above it is rounded down to whole periods."""
    full = get_arch(ARCH)
    with pytest.raises(ValueError, match="cross-attention"):
        cut_depth(full, 4)
    assert cut_depth(full, 5).n_layers == 5
    assert cut_depth(full, 10).n_layers == 10
    assert cut_depth(full, 14).n_layers == 10
    assert cut_depth(full.reduced(), 3).n_layers == 2
    with pytest.raises(ValueError, match="cross-attention"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--layers", "1"])


def test_launcher_runs_reduced_on_the_cpu(capsys):
    done = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--dtype", "float32", "--requests", "3",
                              "--slots", "2", "--max-new", "3",
                              "--prompt-len", "4", "--max-len", "16",
                              "--layers", "3"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    out = capsys.readouterr().out
    assert f"[serve] {ARCH}: 3 requests, 9 tokens" in out
    assert "layers=2," in out


# ---------------------------------------------------------------------------
# build_step's serving modes for the vlm and audio families
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "whisper-small"])
def test_build_step_feeds_the_familys_inputs(arch):
    """build_step's prefill and decode carry media, frames or enc_out, as
    the reference's input_specs does."""
    cfg = replace(get_arch(arch).reduced(), vocab_size=128)
    run = torch_run("full")
    logits, caches = build_step(cfg, ShapeConfig("p", 8, 2, "prefill"), run,
                                device="cpu")()
    assert tuple(logits.shape) == (2, 1, 128)
    logits, _ = build_step(cfg, ShapeConfig("d", 8, 2, "decode"), run,
                           device="cpu")()
    assert tuple(logits.shape) == (2, 1, 128)
    assert bool(torch.isfinite(logits).all())


