"""The frozen counts, pinned to the bounds the kernel table holds, and the
metric arithmetic (idle share, roofline shares, MFU) on synthetic device
intervals and counts."""
import json

import pytest

from portbench.counts import kernels as K
from portbench.counts import models as M
from portbench.devicetrace import kernel_seconds, reduce
from portbench.harness import ROOT, Spec


def config(name):
    return json.loads((ROOT / f"portbench/configs/{name}.json").read_text())


def traffic(name):
    return json.loads((ROOT / f"portbench/traffic/{name}.json").read_text())


@pytest.mark.parametrize("got, ms", [
    (lambda: K.rmsnorm(8192, 4096, "bfloat16", "bfloat16"), 0.0401),
    (lambda: K.rmsnorm(8192, 4096, "bfloat16", "float32"), 0.0401),
    (lambda: K.flash_attention(4, 2048, 2048, 32, 32, 128, True,
                               "bfloat16"), 0.139),
    (lambda: K.flash_attention(4, 2048, 2048, 16, 16, 128, True,
                               "bfloat16"), 0.0695),
    (lambda: K.rmsnorm_backward(4096, 4096, "float32", "float32"), 0.0601),
])
def test_kernel_bounds_are_the_kernel_tables(got, ms):
    assert got() * 1e3 == pytest.approx(ms, abs=5e-5)


def test_attention_pairs_count_the_causal_triangle():
    assert K.attention_pairs(4, 4, True) == 10
    assert K.attention_pairs(4, 4, False) == 16
    assert K.attention_pairs(6, 4, True) == 10 + 2 * 4


def test_train_flops_are_six_per_parameter_and_token_plus_attention():
    cfg = config("deepseek-7b")
    d, ff, V, L = 4096, 11008, 102400, 30
    n = L * (4 * d * d + 3 * d * ff) + V * d        # products' weights
    B, S = 2, 2048
    attn = 3 * L * 4.0 * 128 * 32 * B * (S * (S + 1) // 2)
    assert M.train_flops(cfg, B, S) == pytest.approx(6.0 * n * B * S + attn,
                                                      rel=1e-12)


def test_prefill_flops_count_the_chosen_experts_and_the_last_position():
    cfg = config("olmoe-1b-7b")
    d, E, k, ff, V, L = 2048, 64, 8, 1024, 50304, 16
    per_token = 2 * (4 * d * d) + 2 * d * E + k * 6 * d * ff
    B, S = 4, 4096
    attn = L * 4.0 * 128 * 16 * B * (S * (S + 1) // 2)
    want = L * per_token * B * S + attn + 2.0 * B * d * V
    assert M.prefill_flops(cfg, B, S) == pytest.approx(want, rel=1e-12)


def test_busy_time_is_the_union_of_device_intervals_in_the_window():
    dev = [(0, 10, "a"), (5, 20, "b"), (30, 40, "a"), (45, 70, "c")]
    host = [(18, 35, "aten::item"), (19, 31, "cudaStreamSynchronize"),
            (38, 60, "portbench.prefill")]
    s = reduce(dev, host, (0, 50))
    assert s["window_s"] == pytest.approx(50e-9)
    assert s["busy_s"] == pytest.approx(35e-9)          # 0-20, 30-40, 45-50
    assert s["kernel_s"] == pytest.approx({"a": 20e-9, "b": 15e-9,
                                           "c": 5e-9})
    assert s["idle_gaps"] == [["cudaStreamSynchronize", pytest.approx(10e-9)],
                              ["portbench.prefill", pytest.approx(5e-9)]]
    assert s["device_ops"][0] == ["a", pytest.approx(20e-9)]
    assert kernel_seconds(s, "a") == pytest.approx(20e-9)
    assert kernel_seconds(s, "", exclude=("b",)) == pytest.approx(25e-9)


def test_a_window_with_no_device_work_is_idle_throughout():
    s = reduce([], [], (0, 100))
    assert s["busy_s"] == 0 and s["idle_gaps"] == [["host",
                                                    pytest.approx(1e-7)]]


def ctx(kernels, requests, cfg="olmoe-1b-7b", mix="prefill-mixed",
        window=2.0, busy=1.5):
    return {"config": config(cfg), "traffic": traffic(mix),
            "record": {"requests": requests},
            "trace": {"kernel_s": kernels, "window_s": window,
                      "busy_s": busy}}


def read(name, c):
    return Spec(ROOT).reader(name)(c)


def test_prefill_readers_divide_the_traffics_least_time_by_the_kernels():
    reqs = [{"B": 4, "S": 4096}, {"B": 32, "S": 512}]
    c = ctx({"flash_attention_wgmma_kernel": 0.01,
             "void rmsnorm_reg_kernel<bf16>": 0.004,
             "rmsnorm_bwd_rows_kernel": 1.0}, reqs)
    flash = 16 * (K.flash_attention(4, 4096, 4096, 16, 16, 128, True,
                                    "bfloat16") +
                  K.flash_attention(32, 512, 512, 16, 16, 128, True,
                                    "bfloat16"))
    assert read("flash_roofline", c) == pytest.approx(100 * flash / 0.01)
    norm = sum(32 * K.rmsnorm(16384, 2048, "bfloat16", "bfloat16") +
               K.rmsnorm(B, 2048, "bfloat16", "bfloat16") for B in (4, 32))
    assert read("rmsnorm_roofline.prefill", c) == \
        pytest.approx(100 * norm / 0.004)
    flops = M.prefill_flops(c["config"], 4, 4096) + \
        M.prefill_flops(c["config"], 32, 512)
    assert read("mfu.prefill", c) == pytest.approx(100 * flops / 2.0 / 989e12)
    assert read("idle.prefill", c) == pytest.approx(25.0)


def test_plan_readers_count_every_depth_of_every_answer():
    reqs = [{"B": 2, "S": 2048, "ladder": [2, 3]}]
    c = ctx({"rmsnorm_bwd_rows_kernel": 0.002, "rmsnorm_dscale_kernel": 0.001,
             "rmsnorm_reg_kernel": 5.0}, reqs, "deepseek-7b", "plan-train")
    bound = (5 + 7) * K.rmsnorm_backward(4096, 4096, "float32", "float32")
    assert read("rmsnorm_bwd_roofline.plan", c) == \
        pytest.approx(100 * bound / 0.003)
    flops = sum(M.train_flops(dict(c["config"], n_layers=n), 2, 2048)
                for n in (2, 3))
    assert read("mfu.plan", c) == pytest.approx(100 * flops / 2.0 / 67e12)
    assert read("idle.plan", c) == pytest.approx(25.0)


@pytest.mark.parametrize("name", ["flash_roofline", "rmsnorm_roofline.prefill",
                                  "rmsnorm_bwd_roofline.plan", "idle.prefill"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    c = ctx({}, [{"B": 4, "S": 4096, "ladder": [2]}], busy=0.0)
    assert read(name, c) is None
