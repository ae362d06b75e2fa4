"""The mixture-of-experts family in the port against the JAX package, float32
on the CPU, on the same numpy inputs and on weights carried across: the
router, the dropless dense path, the capacity dispatch and its expert FFN,
the single-device ``moe``, and the whole models olmoe-1b-7b (GQA) and
deepseek-v3-671b (MLA, leading dense layers, an MTP block) reduced: forward,
prefill, decode, caches, the engine and the command line. Tolerances are
the reference's own (tests/test_models.py: ``test_moe_dense_vs_ep_capacity``
1e-4, decode against forward 5e-4)."""
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import analytic_param_count as jax_param_count
from repro.models import moe as JM
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import RunConfig, get_arch
from repro_torch.convert import (caches_from_numpy, caches_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model, analytic_param_count, build_model
from repro_torch.models import moe as TM
from repro_torch.serve.engine import Request, ServeEngine, _reset_slot
from test_torch_parity import as_f32, model_pair, numpy_tree, torch_run

MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v3-671b")
B, S, MAX_LEN = 2, 10, 16
MODEL = dict(atol=1e-4, rtol=1e-4)


def randn(seed, *shape, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


def tokens_for(cfg, seed=0, batch=B, seq=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(batch, seq))


def moe_params(arch, seed=0):
    """(jax config, port config, numpy moe tree, the same as tensors) of a
    reduced arch, the JAX package's init."""
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    tree = numpy_tree(JM.init_moe(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, tree, jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_jax(arch):
    jcfg, cfg, p, tp = moe_params(arch)
    x = randn(1, 40, cfg.d_model)
    want = JM.route(jnp.asarray(p["router"]), jnp.asarray(x), jcfg.moe)
    got = TM.route(tp["router"], torch.from_numpy(x), cfg.moe)
    np.testing.assert_allclose(as_f32(got[0]), as_f32(want[0]), atol=1e-6)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-5)
    assert got[0].dtype == torch.float32 and got[2].dtype == torch.float32
    np.testing.assert_allclose(got[0].sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_matches_jax(arch):
    jcfg, cfg, p, tp = moe_params(arch)
    x = randn(2, 2, 16, cfg.d_model, scale=0.5)
    want, aux_w = JM.moe_dense(p, jnp.asarray(x), jcfg)
    got, aux_g = TM.moe_dense(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    np.testing.assert_allclose(float(aux_g), float(aux_w), atol=1e-5)


@pytest.mark.parametrize("e_lo,E_local", [(0, 8), (2, 4), (6, 2)])
def test_dispatch_local_and_expert_ffn_match_jax(e_lo, E_local):
    """At the config's own capacity factor (1.25) some experts get more
    choices than their C slots: the same choices must drop. The tokens
    lean towards expert e_lo (a shared component along its router
    column), as real routing is skewed."""
    jcfg, cfg, p, tp = moe_params("olmoe-1b-7b")
    m = cfg.moe
    col = p["router"][:, e_lo]
    x = randn(3, 96, cfg.d_model) + 2.0 * col / np.linalg.norm(col)
    gates, idx, _ = JM.route(jnp.asarray(p["router"]), jnp.asarray(x), jcfg.moe)
    T = x.shape[0]
    C = max(1, int(T * m.top_k * m.capacity_factor / m.n_experts))
    counts = np.bincount(np.asarray(idx).ravel(), minlength=m.n_experts)
    assert counts[e_lo:e_lo + E_local].max() > C, "no choice drops here"
    want = JM._dispatch_local(jnp.asarray(x), idx, gates, e_lo, E_local, C)
    got = TM._dispatch_local(torch.from_numpy(x),
                             torch.from_numpy(np.array(idx)).long(),
                             torch.from_numpy(np.array(gates)), e_lo,
                             E_local, C)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert (got[1] == -1).any()                      # empty slots are -1
    sl = slice(e_lo, e_lo + E_local)
    yw = JM._local_expert_ffn(*(jnp.asarray(p[n][sl])
                                for n in ("w_gate", "w_up", "w_down")),
                              want[0])
    yg = TM._local_expert_ffn(*(tp[n][sl] for n in ("w_gate", "w_up",
                                                    "w_down")), got[0])
    np.testing.assert_allclose(as_f32(yg), as_f32(yw), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_jax_moe_dense(arch):
    """The single-device ``moe`` (capacity dispatch, C the largest count,
    nothing dropped) computes the reference's dropless function, as
    ``test_moe_dense_vs_ep_capacity`` holds it: atol = rtol = 1e-4."""
    jcfg, cfg, p, tp = moe_params(arch)
    x = randn(4, 2, 16, cfg.d_model, scale=0.5)
    want, aux_w = JM.moe_dense(p, jnp.asarray(x), jcfg)
    got, aux_g = TM.moe(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    np.testing.assert_allclose(float(aux_g), float(aux_w), atol=1e-5)
    plain, _ = TM.moe_dense(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(as_f32(got), as_f32(plain), **MODEL)


def test_dispatch_local_at_the_largest_count_keeps_every_choice():
    """With C the largest expert's count nothing drops: each choice sits in
    its expert's buffer, with its token and its gate."""
    _, cfg, _, tp = moe_params("deepseek-v3-671b")
    xt = torch.from_numpy(randn(5, 21, cfg.d_model))
    gates, idx, _ = TM.route(tp["router"], xt, cfg.moe)
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    C = int(torch.bincount(idx.reshape(-1), minlength=E).max())
    xb, src, w = TM._dispatch_local(xt, idx, gates, 0, E, C)
    assert int((src >= 0).sum()) == idx.numel()
    for t in range(xt.shape[0]):
        experts = sorted(int(e) for e in (src == t).nonzero()[:, 0])
        assert experts == sorted(idx[t].tolist())
        assert torch.equal(torch.sort(w[src == t]).values,
                           torch.sort(gates[t]).values)
    filled = src >= 0
    assert torch.equal(xb[filled], xt[src[filled]])
    assert float(xb[~filled].abs().max()) == 0.0


def test_expert_groups_bound_the_capacity_buffer(monkeypatch):
    """Consecutive experts join a group while n * C rows stay within the
    budget; each group is padded to its own largest count; experts with no
    choice are skipped; the groups' choices tile the sorted order."""
    monkeypatch.setattr(TM, "GROUP_BYTES", 10)
    counts = [3, 0, 5, 1, 0, 0, 2, 9, 4]
    groups = TM._expert_groups(counts, 1)
    assert groups == [(0, 2, 3, 0, 3), (2, 2, 5, 3, 9), (4, 3, 2, 9, 11),
                      (7, 1, 9, 11, 20), (8, 1, 4, 20, 24)]
    assert all(n * C <= 10 for _, n, C, _, _ in groups if n > 1)
    monkeypatch.setattr(TM, "GROUP_BYTES", 1 << 30)
    assert TM._expert_groups(counts, 1) == [(0, 9, 9, 0, 24)]
    assert TM._expert_groups([0, 0], 1) == []


@pytest.mark.parametrize("budget", [1, 2 ** 15, 2 ** 30])
def test_moe_in_groups_of_experts_is_the_same_function(budget, monkeypatch):
    """One expert a group, a few, or all: the same outputs (each expert's
    rows are the same products; the sum over k is in the same order), JAX
    moe_dense's to 1e-4, and the same bits on two runs."""
    jcfg, cfg, p, tp = moe_params("deepseek-v3-671b")
    x = randn(6, 3, 7, cfg.d_model, scale=0.5)
    want, _ = JM.moe_dense(p, jnp.asarray(x), jcfg)
    one, _ = TM.moe(tp, torch.from_numpy(x), cfg)
    monkeypatch.setattr(TM, "GROUP_BYTES", budget)
    a, aux_a = TM.moe(tp, torch.from_numpy(x), cfg)
    b, aux_b = TM.moe(tp, torch.from_numpy(x), cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    np.testing.assert_allclose(as_f32(a), as_f32(one), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(as_f32(a), as_f32(want), **MODEL)


def test_init_moe_draws_each_expert_at_the_references_scale():
    cfg = get_arch("deepseek-v3-671b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = TM.init_moe(gen, cfg)
    jshapes = jax.eval_shape(lambda: JM.init_moe(jax.random.PRNGKey(0),
                                                 jax_get_arch(cfg.name).reduced()))
    assert jax.tree.map(lambda s: tuple(s.shape), jshapes) == \
        jax.tree.map(lambda t: tuple(t.shape), p)
    m = cfg.moe
    # fan-in as the reference's dense_init takes it: the leaf's leading axis
    assert float(p["w_gate"].abs().max()) <= 2 / np.sqrt(m.n_experts) + 1e-6
    assert float(p["w_down"].abs().max()) <= 2 / np.sqrt(m.d_ff_expert) + 1e-6
    assert not torch.equal(p["w_up"][0], p["w_up"][1])
    meta = TM.init_moe(None, cfg, device="meta")
    assert all(t.device.type == "meta" for t in jax.tree.leaves(meta))


# ---------------------------------------------------------------------------
# the slice: Model, prefill, decode, caches, engine, CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=MOE_ARCHS)
def pair(request):
    arch = request.param
    return model_pair(jax_get_arch(arch).reduced(), get_arch(arch).reduced())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_config_is_the_references(arch):
    assert asdict(get_arch(arch)) == asdict(jax_get_arch(arch))
    assert get_arch(arch).family == "moe"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_count_equals_jax(arch):
    for jcfg, cfg in ((jax_get_arch(arch).reduced(), get_arch(arch).reduced()),
                      (jax_get_arch(arch), get_arch(arch))):
        for active in (False, True):
            assert analytic_param_count(cfg, active) == \
                jax_param_count(jcfg, active)
    assert get_arch("olmoe-1b-7b").param_count() == 6_919_096_320
    four = replace(get_arch("deepseek-v3-671b"), n_layers=4)
    assert four.param_count() == 26_721_155_072


def test_state_dict_keys_are_the_jax_tree_paths(pair):
    jm, jp, tm = pair
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    paths = {".".join(p.key for p in path): leaf.shape for path, leaf in flat}
    own = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert own == paths


def test_forward_matches_jax_with_the_kernel_switch_on(pair):
    jm, jp, tm = pair
    assert tm.run.attn_impl == "kernel"
    toks = tokens_for(tm.cfg)
    want, (aux_w, _) = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    h, aux_g = tm._hidden(tm.params, {"tokens": toks})
    got = tm._logits(tm.params, h)
    assert tuple(got.shape) == (B, S, tm.padded_vocab)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    np.testing.assert_allclose(float(aux_g), float(aux_w), atol=1e-5)
    np.testing.assert_allclose(as_f32(tm.forward({"tokens": toks})),
                               as_f32(got), atol=0, rtol=0)


def test_forward_kernel_and_full_paths_agree(pair):
    _, _, tm = pair
    for impl in ("full", "blocked"):
        other = Model(tm.cfg, torch_run(impl).with_(attn_block_q=4,
                                                    attn_block_kv=4),
                      device="cpu")
        other.load_state_dict(tm.state_dict())
        toks = tokens_for(tm.cfg, seed=1)
        np.testing.assert_allclose(as_f32(other.forward({"tokens": toks})),
                                   as_f32(tm.forward({"tokens": toks})),
                                   **MODEL)


def _cache_names(cfg):
    return ["ckv", "kr", "pos"] if cfg.attention_kind == "mla" \
        else ["k", "pos", "v"]


def test_prefill_matches_jax_logits_and_caches(pair):
    jm, jp, tm = pair
    cfg = tm.cfg
    toks = tokens_for(cfg, seed=2)
    want, wc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    got, gc = tm.prefill({"tokens": toks}, MAX_LEN)
    assert tuple(got.shape) == (B, 1, tm.padded_vocab)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    assert sorted(gc) == sorted(wc)
    n_dense = cfg.moe.first_dense_layers
    assert sorted(gc) == (["dense", "moe"] if n_dense else ["moe"])
    for group in wc:
        assert sorted(gc[group]) == sorted(wc[group]) == _cache_names(cfg)
        for name, leaf in wc[group].items():
            assert tuple(gc[group][name].shape) == tuple(leaf.shape)
            np.testing.assert_allclose(as_f32(gc[group][name]), as_f32(leaf),
                                       **MODEL)
        assert gc[group]["pos"].dtype == torch.int32
    first = gc["moe"]["ckv" if cfg.attention_kind == "mla" else "k"]
    assert first.shape[2] == MAX_LEN and float(first[:, :, S:].abs().max()) == 0
    np.testing.assert_allclose(as_f32(got[:, 0]),
                               as_f32(tm.forward({"tokens": toks})[:, -1]),
                               atol=1e-5, rtol=1e-5)


def test_decode_matches_own_forward_and_jax(pair):
    jm, jp, tm = pair
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
        np.testing.assert_allclose(as_f32(lg), as_f32(jlg), **MODEL)
    err = float((full - torch.stack(steps, 1)).abs().max())
    assert err < 5e-4, f"{tm.cfg.name}: decode mismatch {err}"
    for group in jcaches:
        for name, leaf in jcaches[group].items():
            np.testing.assert_allclose(as_f32(caches[group][name]),
                                       as_f32(leaf), **MODEL)


def test_decode_continues_a_prefill_in_place(pair):
    _, _, tm = pair
    toks = tokens_for(tm.cfg, seed=4)
    _, caches = tm.prefill({"tokens": toks[:, :6]}, MAX_LEN)
    held = {g: dict(c) for g, c in caches.items()}
    for t in range(6, S):
        lg, back = tm.decode_step({"tokens": toks[:, t:t + 1]}, caches)
        assert back is caches
        want = tm.forward({"tokens": toks[:, :t + 1]})[:, -1]
        assert float((lg[:, 0] - want).abs().max()) < 5e-4
    for group, leaves in held.items():
        for name, leaf in leaves.items():
            if name != "pos":          # the cache tensors are written in place
                assert caches[group][name] is leaf
        assert caches[group]["pos"].tolist() == \
            [[S] * B] * leaves["pos"].shape[0]


def test_reset_slot_clears_one_row_of_the_nested_caches(pair):
    _, _, tm = pair
    _, caches = tm.prefill({"tokens": tokens_for(tm.cfg, seed=5)}, MAX_LEN)
    _reset_slot(caches, 1)
    for group in caches.values():
        for name, leaf in group.items():
            assert float(leaf[:, 1].abs().max()) == 0, name
            assert float(leaf[:, 0].abs().max()) > 0, name


def test_no_kernel_launch_is_counted_on_the_cpu(pair):
    _, _, tm = pair
    before = (rmsnorm.launches, flash_attention.launches)
    tm.forward({"tokens": tokens_for(tm.cfg)})
    tm.decode_step({"tokens": tokens_for(tm.cfg, seq=1)},
                   tm.init_caches(B, 4))
    assert (rmsnorm.launches, flash_attention.launches) == before


def test_params_round_trip(pair):
    _, jp, tm = pair
    want = numpy_tree(jp)
    got = params_to_numpy(tm)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        assert np.array_equal(w, g)


def test_caches_round_trip(pair):
    jm, jp, tm = pair
    toks = tokens_for(tm.cfg, seed=6)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    tc = caches_from_numpy(numpy_tree(jc), tm)
    nxt = toks[:, :1]
    lg, tc = tm.decode_step({"tokens": nxt}, tc)
    jlg, jc2 = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc)
    np.testing.assert_allclose(as_f32(lg), as_f32(jlg), **MODEL)
    back = caches_to_numpy(tc)
    assert sorted(back) == sorted(jc2)
    for group in back:
        assert sorted(back[group]) == _cache_names(tm.cfg)
        for name, leaf in back[group].items():
            np.testing.assert_allclose(leaf, np.asarray(jc2[group][name]),
                                       **MODEL)
    first = _cache_names(tm.cfg)[0]
    bad = {**back, "moe": {**back["moe"], first: back["moe"][first][..., :-1]}}
    with pytest.raises(ValueError, match=f"moe.{first}"):
        caches_from_numpy(bad, tm)
    with pytest.raises(KeyError):
        caches_from_numpy({"moe": {k: v for k, v in back["moe"].items()
                                   if k != "pos"}}, tm)


def test_converter_refuses_a_missing_expert_leaf(pair):
    _, _, tm = pair
    tree = params_to_numpy(tm)
    del tree["layers"]["moe"]["w_up"]
    with pytest.raises(KeyError, match="w_up"):
        params_from_numpy(tree, tm)


def test_same_greedy_tokens_as_the_jax_engine(pair):
    jm, jp, tm = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, tm.cfg.vocab_size, size=n).tolist()
               for n in (3, 5, 2)]
    jeng = JServeEngine(jm, jp, slots=2, max_len=16)
    teng = ServeEngine(tm, slots=2, max_len=16)
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid, prompt=list(prompt), max_new_tokens=4))
        teng.submit(Request(rid, prompt=list(prompt), max_new_tokens=4))
    want = {r.rid: r.out_tokens for r in jeng.run()}
    got = {r.rid: r.out_tokens for r in teng.run()}
    assert got == want and all(len(t) == 4 for t in got.values())


def test_init_is_seeded_with_the_mtp_block_and_in_param_dtype():
    cfg = get_arch("deepseek-v3-671b").reduced()
    run = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16")
    a = build_model(cfg, run, device="cpu", seed=3).state_dict()
    b = build_model(cfg, run, device="cpu", seed=3).state_dict()
    assert all(v.dtype == torch.bfloat16 for v in a.values())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert {"mtp.proj", "mtp.norm", "mtp.block.moe.w_gate",
            "dense_layers.attn.wdq", "layers.moe.shared.gate"} <= set(a)
    assert float(a["mtp.norm"].min()) == 1.0 == float(a["layers.attn.q_norm"].min())
    assert not torch.equal(a["layers.moe.w_gate"][0, 0],
                           a["layers.moe.w_gate"][0, 1])
    assert not torch.equal(a["mtp.block.moe.w_gate"][0], a["layers.moe.w_gate"][0])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_cuts_the_depth(arch, capsys):
    cfg = get_arch(arch).reduced()
    n = cfg.moe.first_dense_layers + 1
    done = launch_serve.main(["--arch", arch, "--reduced", "--layers", str(n),
                              "--device", "cpu", "--dtype", "float32",
                              "--requests", "3", "--slots", "2",
                              "--max-new", "4", "--max-len", "16"])
    assert len(done) == 3 and all(len(r.out_tokens) == 4 for r in done)
    assert f"layers={n}," in capsys.readouterr().out
    with pytest.raises(ValueError, match="dense layers"):
        launch_serve.main(["--arch", "deepseek-v3-671b", "--layers", "3",
                           "--device", "cpu"])
