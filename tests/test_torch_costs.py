"""The dry-run tooling against the JAX package's: ``launch.costs`` against
``repro.launch.hlo_costs``, ``launch.roofline`` against
``repro.launch.roofline``, ``launch.dryrun.run_cell``'s record against the
reference's, ``launch.perf``'s variants against the reference's, and each
kernel's FLOP and byte formula against the count of its plain version.

The FLOPs and float32 bytes of the dot set are held equal, not close: the
port's step and the reference's compiled step run the same products.
(In bfloat16 they differ: XLA's CPU backend runs bf16 dots in float32.)
Attention is "full": the port's blocked attention skips the key blocks
that the reference's masks.
"""
import dataclasses
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_arch
from repro.configs.base import RunConfig as JRunConfig
from repro.launch import roofline as JR
from repro.launch.hlo_costs import HloCosts, analyze
from repro.models.model import Model as JModel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_adamw as jax_init_adamw
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import SHAPES, MeshConfig, RunConfig, get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import build
from repro_torch.launch import costs as K
from repro_torch.launch import roofline as R
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import collectives as C
from repro_torch.train.step import init_train_state, make_train_step

KERNELS = {n: sys.modules[f"repro_torch.kernels.{n}"]
           for n in ("flash_attention", "wkv6", "ssd", "rmsnorm")}
B, S = 2, 16


def _reference_module(name):
    """A module of ``repro.launch`` whose import sets XLA_FLAGS for 512
    host devices: imported after this process's jax has its one device,
    and the variable put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


def _pair(remat="nothing"):
    """The reference's reduced deepseek-7b and the port's, on its weights,
    float32, full attention."""
    kw = dict(attn_impl="full", remat=remat, compute_dtype="float32")
    jcfg = jax_arch("deepseek-7b").reduced()
    jm = JModel(jcfg, JRunConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_arch("deepseek-7b").reduced(), RunConfig(**kw),
               device="cpu")
    params_from_numpy(jax.tree.map(np.asarray, jp), tm)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S)) \
        .astype(np.int32)
    return jm, jp, tm, toks


def _hlo(fn, *args):
    return analyze(jax.jit(fn).lower(*args).compile().as_text(), 1)


def test_forward_flops_and_bytes_equal_the_reference():
    jm, jp, tm, toks = _pair()
    want = _hlo(lambda p, b: jm.forward(p, b), jp, {"tokens": toks})
    _, got = K.count(lambda: tm.forward({"tokens": toks}))
    assert got.dot_flops == want.dot_flops == 11_010_048
    assert got.dot_bytes == want.dot_bytes == 1_384_448
    assert set(got.by_op) == {"mm", "bmm"}
    assert got.by_op["mm"]["flops"] == 10_485_760
    assert got.by_op["bmm"]["flops"] == 524_288


def test_prefill_flops_and_bytes_equal_the_reference():
    jm, jp, tm, toks = _pair()
    want = _hlo(lambda p, b: jm.prefill(p, b, S), jp, {"tokens": toks})
    _, got = K.count(lambda: tm.prefill({"tokens": toks}, S))
    assert (got.dot_flops, got.dot_bytes) == \
        (want.dot_flops, want.dot_bytes)


@pytest.mark.parametrize("remat", ["nothing", "boundaries"])
def test_train_step_flops_and_bytes_equal_the_reference(remat):
    """One AdamW step: the loss, its backward (the recomputed forward under
    "boundaries") and the update, whose products are none."""
    jm, jp, tm, toks = _pair(remat)
    batch = {"tokens": toks, "labels": toks}
    acfg = JAdamWConfig()
    state = JTrainState(jp, jax_init_adamw(jp, acfg), None)
    want = _hlo(jax_make_train_step(jm, acfg, None), state,
                {k: jnp.asarray(v) for k, v in batch.items()})
    tacfg = AdamWConfig()
    tstate = init_train_state(tm, None, tacfg)
    step = make_train_step(tm, tacfg)
    _, got = K.count(lambda: step(tstate, batch))
    assert (got.dot_flops, got.dot_bytes) == \
        (want.dot_flops, want.dot_bytes)
    assert got.dot_flops >= 3 * 11_010_048       # forward + backward


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_model_flops_equal_the_reference(arch):
    for name, shape in SHAPES.items():
        want = JR.model_flops(jax_arch(arch), JAX_SHAPES[name])
        assert R.model_flops(get_arch(arch), shape) == want, (arch, name)


def test_roofline_equals_the_reference_on_the_same_inputs():
    rng = np.random.default_rng(0)
    for _ in range(20):
        c, m, k, f, b, w, mf = (float(x) for x in rng.uniform(0.1, 10, 7))
        want = JR.Roofline(c, m, k, f, b, w, model_flops=mf)
        got = R.Roofline(c, m, k, f, b, w, model_flops=mf,
                         peak_flops=JR.PEAK_FLOPS)
        assert got.dominant == want.dominant
        assert got.bound_s == want.bound_s
        assert got.useful_flops_fraction == want.useful_flops_fraction
        assert got.mfu_bound == want.mfu_bound
    consts = dict(peak_flops=JR.PEAK_FLOPS, hbm_bw=JR.HBM_BW,
                  link_bw=JR.ICI_BW)
    cost = {"flops": 3e12, "bytes accessed": 5e9}
    want = JR.roofline_from(cost, JR.CollectiveStats(wire_bytes=7e8), 4,
                            1e13)
    got = R.roofline_from(cost, 7e8, 4, 1e13, **consts)
    assert dataclasses.astuple(got)[:7] == dataclasses.astuple(want)
    hc = HloCosts(dot_flops=3e12, dot_bytes=5e9, coll_wire_bytes=7e8)
    want = JR.roofline_from_hlo(hc, 4, 1e13, extra_hbm_bytes=2e9)
    got = R.roofline_from_costs(K.Costs(dot_flops=3e12, dot_bytes=5e9,
                                        coll_wire_bytes=7e8), 4, 1e13,
                                extra_hbm_bytes=2e9, **consts)
    assert dataclasses.astuple(got)[:7] == dataclasses.astuple(want)
    assert got.mfu_bound == want.mfu_bound


def test_the_h100_constants():
    from repro_torch.core.catalog import H100_PEAK_FLOPS
    assert R.PEAK_FLOPS == H100_PEAK_FLOPS == 989e12
    assert (R.HBM_BW, R.LINK_BW) == (3.35e12, 450e9)


def test_ring_wire_bytes_equal_the_reference_formula():
    """The port's collectives on a rank alone of (2, 4) (calls counted over
    the groups they span) against the reference's parse of the same calls
    in HLO: an all-gather of a (8, 4) block into (32, 4) over 'model', an
    all-reduce over 'data', a reduce-scatter of (8, 4) into a (2, 4) block
    over 'model', an all-to-all over 'data' and a ppermute over 'model',
    float32. The reference charges each call its result's bytes."""
    mesh = Mesh.alone(MeshConfig((2, 4), ("data", "model")), 0, "cpu")
    x = torch.zeros(8, 4)
    C.reset_stats()
    C.all_gather(x, mesh, "model", 0)
    C.all_reduce(x, mesh, "data")
    C.reduce_scatter(x, mesh, "model", 0)
    C.all_to_all(x.view(2, 4, 4), mesh, "data")
    C.ppermute(x, mesh, "model")
    got = K.add_collectives(K.Costs(), C.stats())
    hlo = "\n".join([
        "HloModule m, entry_computation_layout={()->f32[8,4]}",
        "ENTRY %main (p: f32[8,4]) -> f32[8,4] {",
        "  %p = f32[8,4]{1,0} parameter(0)",
        "  %ag = f32[32,4]{1,0} all-gather(%p), replica_groups=[2,4]<=[8],"
        " dimensions={0}",
        "  %ar = f32[8,4]{1,0} all-reduce(%p), replica_groups=[4,2]<=[4,2]"
        "T(1,0), to_apply=%add",
        "  %rs = f32[2,4]{1,0} reduce-scatter(%p), replica_groups=[2,4]<=[8]"
        ", dimensions={0}, to_apply=%add",
        "  %a2a = f32[8,4]{1,0} all-to-all(%p), replica_groups=[4,2]<=[4,2]"
        "T(1,0), dimensions={0}",
        "  ROOT %cp = f32[8,4]{1,0} collective-permute(%p), "
        "source_target_pairs={{0,1},{1,2},{2,3},{3,0}}",
        "}"])
    want = analyze(hlo, 8)
    assert got.coll_counts == want.coll_counts
    assert got.coll_by_kind == pytest.approx(want.coll_by_kind, rel=1e-12)
    assert got.coll_wire_bytes == pytest.approx(want.coll_wire_bytes,
                                                rel=1e-12)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("shape", [(1, 32, 32, 2, 2, 16), (2, 64, 64, 4, 2, 32),
                                   (1, 96, 48, 4, 1, 64),
                                   (2, 33, 65, 2, 2, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_formula_counts_its_plain_version(shape, causal):
    b, sq, sk, h, hkv, d = shape
    g = _gen(0)
    q = torch.randn(b, sq, h, d, generator=g)
    k = torch.randn(b, sk, hkv, d, generator=g)
    mod = KERNELS["flash_attention"]
    _, got = K.count(lambda: mod.flash_attention_plain(q, k, k,
                                                       causal=causal))
    assert (got.dot_flops, got.dot_bytes) == mod.costs(*shape, 4)[:2]


@pytest.mark.parametrize("shape", [(1, 16, 1, 8, 16), (2, 40, 3, 16, 16),
                                   (1, 33, 2, 32, 8), (4, 1, 2, 8, 16)])
def test_wkv6_formula_counts_its_plain_version(shape):
    b, s, h, k, chunk = shape
    g = _gen(1)
    r = torch.randn(b, s, h, k, generator=g)
    lw = -torch.rand(b, s, h, k, generator=g)
    mod = KERNELS["wkv6"]
    _, got = K.count(lambda: mod.wkv6_plain(
        r, r, r, lw, torch.randn(h, k, generator=g), chunk=chunk))
    assert (got.dot_flops, got.dot_bytes) == \
        mod.costs(b, s, h, k, 4, chunk)[:2]


@pytest.mark.parametrize("shape", [(1, 32, 2, 16, 8, 16), (2, 50, 3, 8, 16, 16),
                                   (1, 16, 1, 32, 4, 4), (2, 1, 2, 8, 4, 16)])
def test_ssd_formula_counts_its_plain_version(shape):
    b, s, h, p, n, chunk = shape
    g = _gen(2)
    mod = KERNELS["ssd"]
    _, got = K.count(lambda: mod.ssd_plain(
        torch.randn(b, s, h, p, generator=g), torch.rand(b, s, h, generator=g),
        -torch.rand(h, generator=g), torch.randn(b, s, h, n, generator=g),
        torch.randn(b, s, h, n, generator=g), chunk=chunk))
    assert (got.dot_flops, got.dot_bytes) == \
        mod.costs(b, s, h, p, n, 4, chunk)[:2]


@pytest.mark.parametrize("shape", [(4, 64), (3, 17, 96), (2, 5, 7, 128)])
def test_rmsnorm_formula_counts_its_plain_version(shape):
    """No product: the dot set holds nothing of a norm, forward or
    backward; the kernel's own bytes are x read and the output written."""
    x = torch.randn(*shape, generator=_gen(3), requires_grad=True)
    scale = torch.ones(shape[-1], requires_grad=True)
    mod = KERNELS["rmsnorm"]
    rows = int(np.prod(shape[:-1]))
    _, got = K.count(lambda: mod.rmsnorm_plain(x, scale).sum().backward())
    assert (got.dot_flops, got.dot_bytes) == \
        mod.costs(rows, shape[-1], 4)[:2] == (0, 0)
    assert mod.costs(rows, shape[-1], 2)[2] == \
        2 * rows * shape[-1] * 2 + shape[-1] * 2


def test_a_kernel_launch_counts_where_a_count_runs():
    """What a wrapper reports on the card reaches every count open on the
    thread, and none after it closes."""
    def formula(*args):
        formula.calls += 1
        return args

    formula.calls = 0
    _, got = K.count(lambda: build.launched("wkv6", formula, 10.0, 20.0,
                                            30.0))
    assert (got.dot_flops, got.dot_bytes) == (10.0, 20.0)
    assert got.kernels == {"wkv6": {"launches": 1, "flops": 10.0,
                                    "bytes": 20.0, "io_bytes": 30.0}}
    build.launched("wkv6", formula, 1.0, 1.0, 1.0)
    assert not build._observers and formula.calls == 1


@pytest.mark.parametrize("module", ["build", "flash_attention", "rmsnorm",
                                    "ssd", "wkv6"])
def test_the_kernels_know_nothing_of_the_tooling_above_them(module):
    """A kernel module reports its launches through ``build.launched`` and
    imports nothing of ``repro_torch.launch``, which observes them."""
    import ast
    import repro_torch.kernels as kernels
    path = os.path.join(os.path.dirname(kernels.__file__), module + ".py")
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names and not [n for n in names
                          if n.startswith("repro_torch.launch")], names


# the reference's record (repro/launch/dryrun.py run_cell), less its
# compile times and cost_analysis_raw, which the port maps or leaves out
RECORD = {"cell", "arch", "shape", "mesh", "axes", "n_devices"}
SECTIONS = {
    "memory": {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_bytes", "per_device_bytes", "per_device_gib"},
    "hlo_costs": {"dot_flops_per_dev", "dot_bytes_per_dev", "n_while",
                  "max_trip_multiplier"},
    "collectives": {"wire_bytes_per_dev", "by_kind", "counts"},
    "roofline": {"compute_s", "memory_s", "collective_s", "dominant",
                 "model_flops_total", "model_flops_per_dev",
                 "hlo_flops_per_dev", "useful_flops_fraction", "mfu_bound"},
    "params": {"total", "active"}}


def test_a_rank_of_an_mla_model_draws_only_its_blocks(monkeypatch):
    """Over a mesh, ``Model.init`` draws each of MLA's leaves' blocks at the
    one-device init's fan-in and never builds the whole model: a whole
    deepseek-v3-671b is 406 GiB in float32, which no card holds beside
    ``run_cell``'s rank of a dsv3 cell."""
    from repro_torch.models import model as MM
    cfg = get_arch("deepseek-v3-671b")
    m = cfg.mla
    want = {"wdq": cfg.d_model, "wdkv": cfg.d_model, "wkr": cfg.d_model,
            "wuq": m.q_lora_rank, "wuk": m.kv_lora_rank,
            "wuv": m.kv_lora_rank}
    full = MM._flat(Model(cfg, RunConfig(), "meta").full_shapes)
    for path, shape in full.items():
        kind = MM._leaf_init(path, shape)
        assert kind is not None, path
        assert kind == want.get(path.rsplit(".", 1)[-1], kind), (path, kind)
    rank = Model(cfg.reduced(n_layers=2), RunConfig(fsdp_params=True), "cpu",
                 Mesh.alone(MeshConfig((2, 2), ("data", "model")), 0, "cpu"))

    def whole(*args, **kwargs):
        raise AssertionError("the whole model was built")

    monkeypatch.setattr(MM, "Model", whole)
    rank.init(seed=0)
    assert all(float(t.abs().max()) > 0 for t in
               MM._flat(rank.params).values() if t.numel() > 1)


def test_run_cell_carries_the_reference_record():
    """Rank 0 alone of (2, 2, 2) (pod, data, model), reduced whisper-small,
    train_4k cut to 8 sequences of 32 tokens: every field of the
    reference's record (``tests/test_distribution.py``'s multi-pod cell),
    counted on the CPU."""
    cfg = get_arch("whisper-small").reduced()
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                global_batch=8)
    mesh = MeshConfig((2, 2, 2), ("pod", "data", "model"))
    rec = run_cell(cfg, shape, mesh, device="cpu")
    assert RECORD | set(SECTIONS) <= set(rec)
    for name, keys in SECTIONS.items():
        assert keys <= set(rec[name]), (name, keys - set(rec[name]))
    assert (rec["cell"], rec["mesh"], rec["n_devices"]) == \
        ("whisper-small:train_4k", [2, 2, 2], 8)
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["hlo_costs"]["dot_flops_per_dev"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["peak_bytes"] is None          # on the CPU
    # data parallelism over (pod, data) and 6 heads over 'model'
    assert rec["collectives"]["counts"]["all-reduce"] > 0
    assert rec["collectives"]["wire_bytes_per_dev"] > 0
    assert rec["params"]["total"] == cfg.param_count()


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_argument_bytes_equal_the_reference(mode):
    """What run_cell builds for a reduced deepseek-7b prefill or decode step
    on (1, 1) is, to the byte, what the reference's compiled step takes as
    its arguments: the weights, the batch and (decode) the caches."""
    dryrun = _reference_module("repro.launch.dryrun")
    from repro.launch.mesh import compat_make_mesh
    run = dict(attn_impl="full", remat="nothing", compute_dtype="float32",
               param_dtype="float32")
    jshape = dataclasses.replace(JAX_SHAPES[f"{mode}_32k"], seq_len=16,
                                 global_batch=2)
    lowered, _ = dryrun.build_lowered(
        jax_arch("deepseek-7b").reduced(), jshape,
        compat_make_mesh((1, 1), ("data", "model")), JRunConfig(**run))
    want = lowered.compile().memory_analysis().argument_size_in_bytes
    shape = dataclasses.replace(SHAPES[f"{mode}_32k"], seq_len=16,
                                global_batch=2)
    rec = run_cell(get_arch("deepseek-7b").reduced(), shape,
                   MeshConfig((1, 1), ("data", "model")), RunConfig(**run),
                   device="cpu")
    assert rec["memory"]["argument_bytes"] == want


def test_perf_variants_equal_the_reference():
    ref = _reference_module("repro.launch.perf")
    from repro_torch.launch import perf
    assert sorted(perf.CELLS) == sorted(ref.CELLS)
    for cell in ref.CELLS:
        base_cfg, _, rows = ref.CELLS[cell]()
        want = [(r[0], r[1], dataclasses.asdict(r[2]),
                 (r[3] if len(r) == 4 else base_cfg).moe)
                for r in rows]
        _, got = perf.variants(cell)
        got = [(name, mshape, dataclasses.asdict(run), cfg.moe)
               for name, mshape, run, cfg in got]
        assert [g[:3] for g in got] == [w[:3] for w in want], cell
        assert [None if g[3] is None else g[3].impl for g in got] == \
            [None if w[3] is None else w[3].impl for w in want]
    assert [len(perf.variants(c)[1]) for c in ("ds7b", "dsv3", "whisper")] \
        == [7, 5, 3]
