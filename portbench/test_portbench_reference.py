"""The plain references against the port (repro_torch) on the CPU, at a
reduced size: the prefill's caches and logits, and the planner's ladder,
fit, requirement, selection and parameter count."""
import json

import numpy as np
import pytest
import torch

from portbench import weights as W
from portbench.drivers import prefill as P
from portbench.harness import ROOT, port_config
from portbench.drivers import plan as PL
from portbench.reference import planner as R
from portbench.reference import train as T


def small(name, **over):
    cfg = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    cfg.update(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
               d_ff=96, vocab_size=300, **over)
    if cfg.get("moe"):
        cfg["moe"].update(n_experts=8, top_k=2, d_ff_expert=32)
    return cfg


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "deepseek-7b"])
@pytest.mark.parametrize("B, S", [(2, 24), (1, 40)])
def test_reference_prefill_is_the_ports_in_float32(name, B, S):
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model import Model
    cfg = small(name)
    run = RunConfig(attn_impl="kernel", remat="nothing",
                    param_dtype="float32", compute_dtype="float32")
    model = Model(port_config(cfg), run, device="cpu")
    W.fill(dict(model.state_dict()), cfg, 5)
    toks = P.tokens(cfg, 5, 2, 0, B, S, "cpu")
    logits, caches = model.prefill({"tokens": toks}, S)
    kv = caches["moe"] if cfg["family"] == "moe" else caches
    w = P.reference_weights(cfg, 5, torch.float32, "cpu")
    got = P.compare(cfg, w, toks, logits[:, -1], kv)
    assert got["kv_rel.deep_all"] < 1e-5 and got["kv_rel.deep"] < 1e-5
    assert got["kv_rel.layer1"] < 1e-5 and got["clean.tokens"] > 0.5
    assert got["logits_rel"] < 1e-5
    assert got["top_gap"] == 0.0 and got["pos_wrong"] == 0.0


def test_a_wrong_cache_or_logit_shows_in_the_numbers():
    cfg = small("olmoe-1b-7b")
    w = P.reference_weights(cfg, 3, torch.float32, "cpu")
    toks = P.tokens(cfg, 3, 2, 0, 2, 16, "cpu")
    ks, vs = [], []
    from portbench.reference import transformer as ref
    last = ref.prefill(w, cfg, toks, observe=lambda l, k, v: (ks.append(k),
                                                              vs.append(v)))
    kv = {"k": torch.stack(ks), "v": torch.stack(vs),
          "pos": torch.full((3, 2), 16)}
    assert P.compare(cfg, w, toks, last, kv)["kv_rel.deep_all"] == 0.0
    kv["k"][1, 0] = 0
    bad = P.compare(cfg, w, toks, last, kv)
    assert bad["kv_rel.layer1"] > 0.5 and bad["kv_rel.layer0"] == 0.0
    half = {k: t[:, :1] for k, t in kv.items()}
    assert P.compare(cfg, w, toks, last, half)["kv_rel.layer0"] == \
        float("inf")


@pytest.mark.parametrize("n_layers", [8, 16, 30, 60, 88])
def test_reference_ladder_is_the_planners(n_layers):
    from repro_torch.core.hbm_planner import HBMPlanner
    cfg = port_config(dict(small("deepseek-7b"), n_layers=n_layers))
    assert R.ladder(n_layers) == HBMPlanner.depth_ladder(cfg)


def test_reference_fit_and_requirement_are_the_planners():
    from repro_torch.core.memory_model import fit_memory_model
    x = [2, 3, 4, 6, 7]
    y = [21.84e9, 25.08e9, 28.32e9, 34.80e9, 38.04e9 + 1e6]
    mine, line = fit_memory_model(x, y), R.fit(x, y)
    assert line["slope"] == pytest.approx(mine.slope, rel=1e-14)
    assert line["intercept"] == pytest.approx(mine.intercept, rel=1e-14)
    assert line["r2"] == pytest.approx(mine.r2, abs=1e-15)
    assert R.requirement_gib(line, 30) == pytest.approx(
        mine.requirement(30, 0.05) / 2 ** 30, rel=1e-14)
    f32 = R.fit(x, y, np.float32)
    assert abs(f32["slope"] - line["slope"]) / line["slope"] > 1e-9


@pytest.mark.parametrize("req", [0.0, 10.0, 77.4, 77.5, 110.0, 300.0, 5e3,
                                 1e9])
def test_reference_selection_is_the_planners(req):
    from repro_torch.core.hbm_planner import HBMPlanner
    sel = HBMPlanner().select(req, 0.0)
    assert sel.config.scale_out == R.gpus(req)


@pytest.mark.parametrize("n_layers", [2, 7, 30])
def test_reference_state_is_sixteen_bytes_a_parameter_of_the_port(n_layers):
    from repro_torch.models.model import analytic_param_count
    cfg = json.loads((ROOT / "portbench/configs/deepseek-7b.json").read_text())
    outside = 2 * cfg["vocab_size"] * cfg["d_model"] + cfg["d_model"]
    port = analytic_param_count(port_config(dict(cfg, n_layers=n_layers)))
    assert R.layer_params(cfg) * n_layers + outside == port


def test_a_tie_in_routing_leaves_the_token_out_of_the_later_layers():
    cfg = small("olmoe-1b-7b")
    w = P.reference_weights(cfg, 3, torch.float32, "cpu")
    toks = P.tokens(cfg, 3, 2, 0, 2, 16, "cpu")
    from portbench.reference import transformer as ref
    ks, vs, gaps = [], [], []
    last = ref.prefill(w, cfg, toks, observe=lambda l, k, v: (ks.append(k),
                                                              vs.append(v)),
                       route=lambda l, g: gaps.append(g))
    assert len(gaps) == cfg["n_layers"] and gaps[0].shape == (2, 16)
    assert bool((torch.stack(gaps) >= 0).all())
    kv = {"k": torch.stack(ks), "v": torch.stack(vs),
          "pos": torch.full((3, 2), 16)}
    tied = gaps[0] < float(gaps[0].median())
    kv["k"][1][tied] += 1.0              # only tokens tied at layer 0 moved
    margin = float(gaps[0].median())
    got = P.compare(cfg, w, toks, last, kv, margins=(margin, 0.0))
    assert got["kv_rel.layer1"] == 0.0 and got["kv_rel.layer1@0"] > 0.1
    assert got["clean.tokens"] <= 0.5 and got["clean.tokens@0"] == 1.0


OPT = json.loads((ROOT / "portbench/traffic/plan-train.json").read_text()
                 )["optimizer"]


@pytest.mark.parametrize("B, S", [(2, 16), (1, 24)])
def test_reference_train_step_is_the_ports_in_float32(B, S):
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = small("deepseek-7b")
    run = RunConfig(attn_impl="blocked", remat="boundaries",
                    param_dtype="float32", compute_dtype="float32")
    model = Model(port_config(cfg), run, device="cpu")
    acfg = AdamWConfig()
    state = init_train_state(model, 0, acfg)
    W.fill(PL.flat(state.params), cfg, 9)
    toks, labels = PL.step_inputs(cfg, 9, 0, B, S, "cpu")
    _, metrics = make_train_step(model, acfg)(state, {"tokens": toks,
                                                      "labels": labels})
    w = dict(W.draw(cfg, 9, "cpu", torch.float32))
    r = T.first_step(w, cfg, toks, labels, OPT)
    assert abs(float(metrics["loss"]) - r["loss"]) / r["loss"] < 1e-5
    grad = {n: T.norm(t) / (1 - OPT["b1"])
            for n, t in PL.flat(state.opt.m).items()}
    assert T.worst_leaf(grad, r["grad"]) < 1e-4
    moved = {n: T.norm(t - w[n]) for n, t in PL.flat(state.params).items()}
    assert T.worst_leaf(moved, r["change"]) == 0.0      # lr 0 at step 0


def test_reference_adamw_change_is_the_ports_at_a_learning_rate():
    from repro_torch.optim import AdamWConfig, adamw_update, init_adamw
    cfg = small("deepseek-7b")
    w = dict(W.draw(cfg, 4, "cpu", torch.float32))
    toks, labels = PL.step_inputs(cfg, 4, 0, 2, 16, "cpu")
    r = T.first_step(w, cfg, toks, labels, OPT, scale_lr=0.5)
    leaves = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    grads = torch.autograd.grad(T.loss(leaves, cfg, toks, labels),
                                list(leaves.values()))
    params = {n: t.detach().clone() for n, t in w.items()}
    acfg = AdamWConfig()
    adamw_update(params, dict(zip(leaves, grads)), init_adamw(params, acfg),
                 acfg, lr_scale=0.5)
    moved = {n: T.norm(params[n] - w[n]) for n in w}
    assert min(r["change"].values()) > 0
    # the port's change is a difference of float32 parameters: rounding
    # of a weight of order 1 against a change of order 1e-4
    assert T.worst_leaf(moved, r["change"]) < 2e-4
