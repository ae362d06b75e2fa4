"""The dense decoder of the port against the JAX package, on weights
carried across as numpy arrays, float32 on the CPU. The JAX side runs with
attn_impl="pallas": the Pallas flash-attention body in interpret mode."""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.models import analytic_param_count as jax_param_count

from repro_torch.configs import ARCHS, RunConfig, get_arch
from repro_torch.convert import (caches_from_numpy, caches_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models import Model, analytic_param_count, build_model
from repro_torch.models.model import PORTED_FAMILIES
from test_torch_parity import (DENSE_ARCHS, as_f32, model_pair, numpy_tree,
                               torch_run)

B, S, MAX_LEN = 2, 12, 16


def tokens_for(cfg, seed=0, batch=B, seq=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(batch, seq))


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def pair(request):
    arch = request.param
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    return (arch,) + model_pair(jcfg, cfg)


def test_registry_holds_the_four_dense_archs():
    """The four dense archs and the other six, rwkv6-7b, zamba2-7b,
    olmoe-1b-7b, deepseek-v3-671b, llama-3.2-vision-90b and whisper-small:
    the reference's ten, each its config; an unknown name raises."""
    assert sorted(ARCHS) == sorted(DENSE_ARCHS + (
        "rwkv6-7b", "zamba2-7b", "olmoe-1b-7b", "deepseek-v3-671b",
        "llama-3.2-vision-90b", "whisper-small"))
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name in ARCHS:
        assert get_arch(name) == get_arch(name)
        assert asdict(get_arch(name)) == asdict(jax_get_arch(name))
    assert get_arch("rwkv6-7b").family == "ssm"
    assert get_arch("zamba2-7b").family == "hybrid"
    assert get_arch("olmoe-1b-7b").family == "moe"
    assert get_arch("deepseek-v3-671b").attention_kind == "mla"
    assert get_arch("llama-3.2-vision-90b").family == "vlm"
    assert get_arch("whisper-small").family == "audio"
    with pytest.raises(KeyError):
        get_arch("llama-3.2-vision-11b")


def test_forward_matches_jax_with_the_kernel_switch_on(pair):
    """Model-level run with the kernel switch on in both packages."""
    arch, jm, jp, tm = pair
    assert jm.run.attn_impl == "pallas" and tm.run.attn_impl == "kernel"
    toks = tokens_for(tm.cfg)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward({"tokens": toks})
    assert tuple(got.shape) == (B, S, tm.padded_vocab)
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=1e-4, rtol=1e-4)


def test_forward_kernel_and_full_paths_agree(pair):
    arch, _, _, tm = pair
    full = Model(tm.cfg, torch_run("full"), device="cpu")
    full.load_state_dict(tm.state_dict())
    toks = tokens_for(tm.cfg, seed=1)
    np.testing.assert_allclose(as_f32(full.forward({"tokens": toks})),
                               as_f32(tm.forward({"tokens": toks})),
                               atol=1e-4, rtol=1e-4)


def test_prefill_matches_jax_logits_and_caches(pair):
    arch, jm, jp, tm = pair
    toks = tokens_for(tm.cfg, seed=2)
    want, wc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    got, gc = tm.prefill({"tokens": toks}, MAX_LEN)
    assert tuple(got.shape) == (B, 1, tm.padded_vocab)
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=1e-4, rtol=1e-4)
    cfg = tm.cfg
    assert tuple(gc["k"].shape) == (cfg.n_layers, B, MAX_LEN, cfg.n_kv_heads,
                                    cfg.d_head)
    for name in ("k", "v"):
        np.testing.assert_allclose(as_f32(gc[name]), as_f32(wc[name]),
                                   atol=1e-4, rtol=1e-4)
    assert gc["pos"].dtype == torch.int32
    assert np.array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))
    # the last position of forward is what prefill answers with
    np.testing.assert_allclose(as_f32(got[:, 0]),
                               as_f32(tm.forward({"tokens": toks})[:, -1]),
                               atol=1e-5, rtol=1e-5)


def test_decode_matches_own_forward_and_jax_caches(pair):
    arch, jm, jp, tm = pair
    toks = tokens_for(tm.cfg, seed=3)
    full = tm.forward({"tokens": toks})
    caches = tm.init_caches(B, S)
    jcaches = jm.init_caches(B, S)
    steps = []
    for t in range(S):
        lg, caches = tm.decode_step({"tokens": toks[:, t:t + 1]}, caches)
        jlg, jcaches = jm.decode_step(
            jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jcaches)
        steps.append(lg[:, 0])
        np.testing.assert_allclose(as_f32(lg), as_f32(jlg), atol=1e-4,
                                   rtol=1e-4)
    err = float((full - torch.stack(steps, 1)).abs().max())
    assert err < 5e-4, f"{arch}: decode mismatch {err}"
    for name in ("k", "v"):
        np.testing.assert_allclose(as_f32(caches[name]),
                                   as_f32(jcaches[name]), atol=1e-4, rtol=1e-4)
    assert np.array_equal(caches["pos"].numpy(), np.asarray(jcaches["pos"]))


def test_decode_continues_a_prefill(pair):
    arch, jm, jp, tm = pair
    toks = tokens_for(tm.cfg, seed=4)
    _, caches = tm.prefill({"tokens": toks[:, :8]}, MAX_LEN)
    lg, caches = tm.decode_step({"tokens": toks[:, 8:9]}, caches)
    want = tm.forward({"tokens": toks[:, :9]})[:, -1]
    assert float((lg[:, 0] - want).abs().max()) < 5e-4
    assert caches["pos"].tolist() == [[9] * B] * tm.cfg.n_layers


def test_no_kernel_launch_is_counted_on_the_cpu(pair):
    arch, _, _, tm = pair
    before = (rmsnorm.launches, flash_attention.launches)
    tm.forward({"tokens": tokens_for(tm.cfg)})
    assert (rmsnorm.launches, flash_attention.launches) == before


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_param_count_equals_jax(arch):
    for jcfg, cfg in ((jax_get_arch(arch).reduced(), get_arch(arch).reduced()),
                      (jax_get_arch(arch), get_arch(arch))):
        assert analytic_param_count(cfg) == jax_param_count(jcfg)
        assert cfg.param_count() == cfg.active_param_count() == \
            analytic_param_count(cfg)


def test_deepseek_7b_full_size_is_6_9_billion():
    assert get_arch("deepseek-7b").param_count() == 6_910_365_696


def test_vocab_padding_masks_the_padded_columns():
    jcfg = jax_get_arch("deepseek-7b").reduced(vocab_size=250)
    cfg = get_arch("deepseek-7b").reduced(vocab_size=250)
    jm, jp, tm = model_pair(jcfg, cfg)
    assert tm.padded_vocab == 256
    assert tuple(tm.state_dict()["embed"].shape) == (256, cfg.d_model)
    toks = tokens_for(cfg, seed=5)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward({"tokens": toks})
    assert tuple(got.shape) == (B, S, 256)
    assert float(got[..., 250:].max()) == float(np.float32(-1e30))
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=1e-4, rtol=1e-4)
    assert int(got.argmax(-1).max()) < 250


def test_state_dict_keys_are_the_jax_tree_paths(pair):
    arch, jm, jp, tm = pair
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    paths = {".".join(p.key for p in path): leaf.shape for path, leaf in flat}
    own = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert own == paths


def test_init_is_seeded_and_in_param_dtype():
    cfg = get_arch("nemotron-4-15b").reduced()
    run = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16")
    a = build_model(cfg, run, device="cpu", seed=3)
    b = build_model(cfg, run, device="cpu", seed=3)
    c = build_model(cfg, run, device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(v.dtype == torch.bfloat16 for v in sa.values())
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed"], sc["embed"])
    assert float(sa["layers.ln1"].min()) == 1.0
    # layers differ from each other, and down uses its own fan-in
    assert not torch.equal(sa["layers.mlp.up"][0], sa["layers.mlp.up"][1])
    assert float(sa["layers.mlp.down"].float().abs().max()) <= \
        2.0 / np.sqrt(cfg.d_ff) + 1e-2
    out = a.forward({"tokens": tokens_for(cfg)})
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_arch("deepseek-7b").reduced())


def test_other_families_and_int8_kv_wait():
    """Every family of the ten archs builds, reduced and at full size (on
    the meta device); an unknown family raises; the int8 KV cache, which
    waited until it was ported, builds int8 k and v with bfloat16 scales."""
    from dataclasses import replace
    assert sorted(PORTED_FAMILIES) == sorted(
        {cfg.family for cfg in ARCHS.values()})
    for name, full in ARCHS.items():
        Model(full.reduced(), device="cpu")
        Model(full, device="meta")
    cfg = get_arch("deepseek-7b").reduced()
    with pytest.raises(ValueError, match="unknown family"):
        Model(replace(cfg, family="diffusion"), device="cpu")
    m = Model(cfg, RunConfig(kv_cache_dtype="int8"), device="cpu")
    c = m.init_caches(1, 8)
    assert sorted(c) == ["k", "k_scale", "pos", "v", "v_scale"]
    assert c["k"].dtype == torch.int8 and c["v_scale"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b",
                                  "llama-3.2-vision-90b", "whisper-small"])
def test_prefill_logits_own_their_storage(arch):
    """The families whose prefill hands back zeroed caches put only the last
    position through the head: their logits own B x 1 x V elements, not a
    view that keeps (B, S, V) logits alive, and match forward's last row."""
    cfg = get_arch(arch).reduced()
    model = Model(cfg, RunConfig(compute_dtype="float32"),
                  device="cpu").init(seed=0)
    batch = {"tokens": tokens_for(cfg)}
    if cfg.family == "vlm":
        batch["media"] = np.zeros((B, cfg.cross_attn.n_media_tokens,
                                   cfg.d_model), np.float32)
    if cfg.family == "audio":
        batch["frames"] = np.zeros((B, cfg.encdec.enc_len, cfg.d_model),
                                   np.float32)
    last, _ = model.prefill(batch, 16)
    assert tuple(last.shape) == (B, 1, model.padded_vocab)
    assert last.untyped_storage().nbytes() == \
        B * model.padded_vocab * last.element_size()
    np.testing.assert_allclose(as_f32(last), as_f32(model.forward(batch)[:, -1:]),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# weights and caches across
# ---------------------------------------------------------------------------


def test_params_round_trip(pair):
    arch, jm, jp, tm = pair
    want = numpy_tree(jp)
    got = params_to_numpy(tm)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        assert np.array_equal(w, g)


def test_caches_round_trip(pair):
    arch, jm, jp, tm = pair
    toks = tokens_for(tm.cfg, seed=6)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    tc = caches_from_numpy(numpy_tree(jc), tm)
    # carried-across caches decode like the JAX ones
    nxt = toks[:, :1]
    lg, tc = tm.decode_step({"tokens": nxt}, tc)
    jlg, jc2 = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc)
    np.testing.assert_allclose(as_f32(lg), as_f32(jlg), atol=1e-4, rtol=1e-4)
    back = caches_to_numpy(tc)
    assert sorted(back) == ["k", "pos", "v"]
    np.testing.assert_allclose(back["k"], np.asarray(jc2["k"]), atol=1e-4)
    assert np.array_equal(back["pos"], np.asarray(jc2["pos"]))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_converter_refuses(fault):
    cfg = get_arch("deepseek-7b").reduced()
    m = build_model(cfg, torch_run(), device="cpu")
    tree = params_to_numpy(m)
    if fault == "missing":
        del tree["layers"]["attn"]["wo"]
        err = KeyError
    elif fault == "extra":
        tree["layers"]["attn"]["bias"] = np.zeros(3, np.float32)
        err = KeyError
    else:
        tree["layers"]["mlp"]["up"] = tree["layers"]["mlp"]["up"][:, :, :-1]
        err = ValueError
    with pytest.raises(err, match="wo|bias|up"):
        params_from_numpy(tree, m)
    caches = caches_to_numpy(m.init_caches(2, 8))
    with pytest.raises(ValueError):
        caches_from_numpy({**caches, "k": caches["k"][:, :, :, :, :-1]}, m)
    with pytest.raises(KeyError):
        caches_from_numpy({"k": caches["k"], "v": caches["v"]}, m)
