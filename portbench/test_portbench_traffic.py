"""The traffic generators: the same seed gives the same batches and jobs,
every seed gives the same work in another order, and every length and shape
is one of its mix's."""
import json
from collections import Counter

import pytest
import torch

from portbench.drivers import plan as PL
from portbench.drivers import prefill as P
from portbench.harness import ROOT

SEEDS = [0, 1, 2 ** 31 + 11, 2 ** 33 + 5]


def traffic(name):
    return json.loads((ROOT / f"portbench/traffic/{name}.json").read_text())


@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_schedule_is_the_seeds_and_each_cycle_holds_the_mix(seed):
    t = traffic("prefill-mixed")
    n = sum(c for _, c in t["cycle"])
    order = P.schedule(t, seed, 5 * n)
    assert order == P.schedule(t, seed, 5 * n)
    for c in range(5):
        assert Counter(order[c * n:(c + 1) * n]) == \
            Counter({S: k for S, k in t["cycle"]})
    assert all(1 <= t["tokens_per_batch"] // S for S in order)


def test_prefill_schedules_of_two_seeds_differ_in_order_only():
    t = traffic("prefill-mixed")
    a, b = P.schedule(t, 1, 40), P.schedule(t, 2, 40)
    assert a != b and Counter(a) == Counter(b)


@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_samples_are_one_batch_of_each_length_in_the_first_cycle(seed):
    t = traffic("prefill-mixed")
    n = sum(c for _, c in t["cycle"])
    first = P.schedule(t, seed, n)
    picked = P.samples(t, seed)
    assert picked == P.samples(t, seed)
    assert sorted(first[i] for i in picked) == sorted(S for S, _ in t["cycle"])
    assert all(0 <= i < n for i in picked)


def test_prompt_tokens_are_the_seeds_and_in_the_vocabulary():
    cfg = {"vocab_size": 50304}
    a = P.tokens(cfg, 2 ** 31 + 11, 2, 3, 4, 4096, "cpu")
    assert a.shape == (4, 4096) and a.dtype == torch.int64
    assert torch.equal(a, P.tokens(cfg, 2 ** 31 + 11, 2, 3, 4, 4096, "cpu"))
    assert not torch.equal(a, P.tokens(cfg, 2 ** 31 + 12, 2, 3, 4, 4096,
                                       "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 50304


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_jobs_are_the_seeds_and_each_cycle_asks_every_shape(seed):
    t = traffic("plan-train")
    order = PL.schedule(t, seed, 12)
    assert order == PL.schedule(t, seed, 12)
    shapes = {tuple(s) for s in t["cycle"]}
    for c in range(4):
        assert set(order[3 * c:3 * c + 3]) == shapes
    assert all(B * S == 4096 for B, S in order)


def test_weights_are_the_seeds_and_drawn_again_alike():
    from portbench import weights as W
    cfg = json.loads((ROOT / "portbench/configs/olmoe-1b-7b.json").read_text())
    cfg.update(n_layers=1, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
               vocab_size=256)
    cfg["moe"].update(n_experts=4, d_ff_expert=32)
    a = dict(W.draw(cfg, 7, "cpu", torch.bfloat16))
    b = dict(W.draw(cfg, 7, "cpu", torch.bfloat16))
    c = dict(W.draw(cfg, 8, "cpu", torch.bfloat16))
    assert [n for n, _, _ in W.leaves(cfg)] == list(a)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["layers.moe.w_up"], c["layers.moe.w_up"])
    assert torch.equal(a["norm"], torch.ones(64, dtype=torch.bfloat16))
    w = a["layers.moe.w_down"].float()
    assert abs(float(w.std()) - 32 ** -0.5) < 0.02
