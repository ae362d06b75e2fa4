"""Serving engine of the port: continuous batching, slot reuse, sampling,
and the same greedy tokens as the JAX engine on the same weights."""
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.engine import Request, ServeEngine, _reset_slot
from test_torch_parity import DENSE_ARCHS, model_pair


@pytest.fixture(scope="module")
def small():
    """(jax model, jax params, torch model) of reduced deepseek-7b; the JAX
    side as tests/test_serve.py runs it."""
    return model_pair(jax_get_arch("deepseek-7b").reduced(),
                      get_arch("deepseek-7b").reduced(), jax_attn="full")


def test_engine_serves_all_requests(small):
    _, _, m = small
    eng = ServeEngine(m, slots=2, max_len=32)
    for rid in range(5):
        eng.submit(Request(rid, prompt=[rid + 1, 2, 3], max_new_tokens=4))
    done = eng.run()
    assert len(done) == 5
    assert all(len(r.out_tokens) == 4 and r.done for r in done)
    assert all(r.finished_at >= r.submitted_at for r in done)


def test_slot_reuse_matches_fresh_engine(small):
    """A request served in a recycled slot produces the same tokens as on a
    fresh engine — stale cache state is fully isolated."""
    _, _, m = small
    eng = ServeEngine(m, slots=1, max_len=32)
    eng.submit(Request(0, prompt=[9, 8, 7], max_new_tokens=5))
    eng.submit(Request(1, prompt=[3, 2, 1], max_new_tokens=5))
    done = eng.run()
    r1 = [r for r in done if r.rid == 1][0]

    fresh = ServeEngine(m, slots=1, max_len=32)
    fresh.submit(Request(1, prompt=[3, 2, 1], max_new_tokens=5))
    d2 = fresh.run()
    assert r1.out_tokens == d2[0].out_tokens


def test_greedy_matches_forward_argmax(small):
    """Engine greedy decode == argmax over model.forward logits chain."""
    _, _, m = small
    prompt = [5, 11, 2]
    eng = ServeEngine(m, slots=1, max_len=32)
    eng.submit(Request(0, prompt=prompt, max_new_tokens=3))
    out = eng.run()[0].out_tokens

    toks = list(prompt)
    for _ in range(3):
        lg = m.forward({"tokens": torch.tensor([toks])})
        toks.append(int(torch.argmax(lg[0, -1])))
    assert out == toks[len(prompt):]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_same_greedy_tokens_as_the_jax_engine(arch):
    jm, jp, tm = model_pair(jax_get_arch(arch).reduced(),
                            get_arch(arch).reduced(), jax_attn="full")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, tm.cfg.vocab_size, size=n).tolist()
               for n in (3, 5, 2, 4, 3)]
    jeng = JServeEngine(jm, jp, slots=2, max_len=32)
    teng = ServeEngine(tm, slots=2, max_len=32)
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid, prompt=list(prompt), max_new_tokens=6))
        teng.submit(Request(rid, prompt=list(prompt), max_new_tokens=6))
    want = {r.rid: r.out_tokens for r in jeng.run()}
    got = {r.rid: r.out_tokens for r in teng.run()}
    assert got == want


def test_idle_slot_past_max_len_leaves_the_others_alone(small):
    """One slot goes idle and its pos runs past max_len while another keeps
    serving: its cache writes are dropped, nothing faults, and the long
    request gets the tokens it gets on an engine of its own."""
    jm, jp, m = small
    max_len = 16
    eng = ServeEngine(m, slots=2, max_len=max_len)
    eng.submit(Request(0, prompt=[4, 5], max_new_tokens=2))       # done early
    eng.submit(Request(1, prompt=[7, 8, 9], max_new_tokens=12))
    for _ in range(3):
        eng.tick()
    assert eng.active[0] is None and eng.active[1] is not None
    # stand the idle slot at the end of its cache, as a long idle spell would
    eng.caches["pos"][:, 0] = max_len - 1
    frozen = eng.caches["k"][:, 0].clone()
    done = {r.rid: r for r in eng.run()}
    assert int(eng.caches["pos"][0, 0]) > max_len
    # only position max_len - 1 was still writable
    assert torch.equal(eng.caches["k"][:, 0, :max_len - 1],
                       frozen[:, :max_len - 1])
    assert bool(torch.isfinite(eng.caches["k"]).all())

    alone = ServeEngine(m, slots=1, max_len=max_len)
    alone.submit(Request(1, prompt=[7, 8, 9], max_new_tokens=12))
    assert done[1].out_tokens == alone.run()[0].out_tokens

    # the JAX engine, where the scatter drops the write, agrees
    jeng = JServeEngine(jm, jp, slots=2, max_len=max_len)
    jeng.submit(JRequest(0, prompt=[4, 5], max_new_tokens=2))
    jeng.submit(JRequest(1, prompt=[7, 8, 9], max_new_tokens=12))
    for _ in range(3):
        jeng.tick()
    jeng.caches["pos"] = jeng.caches["pos"].at[:, 0].set(max_len - 1)
    jdone = {r.rid: r for r in jeng.run()}
    assert done[1].out_tokens == jdone[1].out_tokens
    # a new request admitted into the overrun slot starts clean
    eng.submit(Request(2, prompt=[4, 5], max_new_tokens=2))
    assert eng.run()[-1].out_tokens == done[0].out_tokens


def test_temperature_sampling_is_reproducible_from_its_seed(small):
    _, _, m = small

    def sample(seed):
        eng = ServeEngine(m, slots=2, max_len=32, seed=seed)
        for rid in range(3):
            eng.submit(Request(rid, prompt=[rid + 1, 2], max_new_tokens=8,
                               temperature=1.5))
        return {r.rid: r.out_tokens for r in eng.run()}

    a, b, c = sample(0), sample(0), sample(1)
    assert a == b
    assert a != c
    assert all(0 <= t < m.cfg.vocab_size for toks in a.values() for t in toks)


def test_eos_ends_a_request(small):
    _, _, m = small
    eng = ServeEngine(m, slots=1, max_len=32)
    eng.submit(Request(0, prompt=[5, 11, 2], max_new_tokens=6))
    first = eng.run()[0].out_tokens
    stop = ServeEngine(m, slots=1, max_len=32, eos_id=first[1])
    stop.submit(Request(0, prompt=[5, 11, 2], max_new_tokens=6))
    assert stop.run()[0].out_tokens == first[:first.index(first[1]) + 1]


def test_reset_slot_zeroes_one_row_in_place(small):
    _, _, m = small
    caches = m.init_caches(3, 8)
    for leaf in caches.values():
        leaf.fill_(1)
    out = _reset_slot(caches, 1)
    assert out is caches
    assert float(caches["k"][:, 1].abs().sum()) == 0.0
    assert float(caches["v"][:, 1].abs().sum()) == 0.0
    assert caches["pos"][:, 1].tolist() == [0] * m.cfg.n_layers
    assert bool((caches["k"][:, 0] == 1).all() and (caches["pos"][:, 2] == 1).all())


def test_launcher_runs_reduced_on_the_cpu(capsys):
    done = launch_serve.main(["--arch", "chatglm3-6b", "--reduced",
                              "--device", "cpu", "--dtype", "float32",
                              "--requests", "5", "--slots", "2",
                              "--max-new", "4", "--prompt-len", "5",
                              "--max-len", "16"])
    assert len(done) == 5 and all(len(r.out_tokens) == 4 for r in done)
    assert all(len(r.prompt) == 5 for r in done)
    out = capsys.readouterr().out
    assert "[serve] chatglm3-6b: 5 requests, 20 tokens" in out
    assert "device=cpu" in out


def test_launcher_refuses_what_waits(capsys):
    # --int8-kv waited until the int8 KV cache was ported; it now serves
    done = launch_serve.main(["--arch", "deepseek-7b", "--reduced",
                              "--device", "cpu", "--int8-kv",
                              "--requests", "2", "--max-new", "4"])
    assert len(done) == 2 and "kv=int8" in capsys.readouterr().out
    with pytest.raises(ValueError, match="max-len"):
        launch_serve.main(["--arch", "deepseek-7b", "--reduced", "--device",
                           "cpu", "--prompt-len", "60", "--max-new", "16"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_serve.main(["--arch", "deepseek-7b", "--reduced"])
