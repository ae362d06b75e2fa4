"""Helpers shared by the tests of the PyTorch package: the same numpy data
handed to both packages, models of both built on the same weights, the
two-step train parity, and worlds of gloo processes on the CPU.

``World`` spawns the ranks of a mesh, each joined to the others by a
FileStore in a temporary directory (no port to collide on); every wait on a
rank has a timeout, and a collective that waits for a peer gives up after
WORLD_TIMEOUT_S, so that a hung world fails its test instead of stalling
the suite. A rank runs the cases of the module that started it (its
``CASES``, looked up by name): workers are spawned, never forked, and the
spawned child re-imports that module, so the case functions live at module
level."""
import importlib
import multiprocessing
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.models import build_model as jax_build_model
from repro.train.step import make_train_step as jax_make_train_step

from repro_torch.configs import RunConfig
from repro_torch.convert import (flatten_tree, params_from_numpy,
                                 train_state_to_numpy)
from repro_torch.models.model import Model
from repro_torch.sharding import collectives as C
from repro_torch.train.step import make_train_step

DENSE_ARCHS = ("chatglm3-6b", "deepseek-7b", "mistral-large-123b",
               "nemotron-4-15b")
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_jax(a: np.ndarray, dtype: str = "float32"):
    return jnp.asarray(a).astype(JAX_DTYPES[dtype])


def to_torch(a: np.ndarray, dtype: str = "float32"):
    return torch.from_numpy(np.array(a)).to(TORCH_DTYPES[dtype])


def as_f32(x) -> np.ndarray:
    """A JAX array or a torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def layer_of(tree, *index):
    """One layer of a stacked JAX parameter tree, as (numpy tree, torch
    tree of float32 tensors)."""
    np_tree = jax.tree.map(lambda a: np.asarray(a)[index], tree)
    return np_tree, jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                 np_tree)


def jax_run(attn_impl: str = "pallas") -> JRunConfig:
    return JRunConfig(attn_impl=attn_impl, remat="nothing",
                      compute_dtype="float32", attn_block_q=16,
                      attn_block_kv=16)


def torch_run(attn_impl: str = "kernel") -> RunConfig:
    return RunConfig(attn_impl=attn_impl, remat="nothing",
                     compute_dtype="float32")


def model_pair(jcfg, cfg, *, jax_attn="pallas", torch_attn="kernel", seed=0,
               edit=None):
    """(jax model, jax params, torch model on the CPU with the same
    weights). The weights are the JAX package's init, carried across as
    numpy arrays; `edit(params)`, where given, changes the JAX tree in
    place before it is carried across."""
    jm = jax_build_model(jcfg, jax_run(jax_attn))
    jp = jm.init(jax.random.PRNGKey(seed))
    if edit is not None:
        edit(jp)
    tm = params_from_numpy(numpy_tree(jp),
                           Model(cfg, torch_run(torch_attn), device="cpu"))
    return jm, jp, tm


# ---------------------------------------------------------------------------
# the train parity: two steps, the second at the learning rate
# ---------------------------------------------------------------------------

# The schedule's warmup is 1 step: the first step runs at lr 0 (the warmup's
# scale at step 0) and fills the moments; the second moves every parameter
# that has a gradient by about lr. Its move is lr g / (|g| + eps): where |g|
# is near AdamW's eps a float32 difference in g moves it by up to lr dg /
# eps, so parameters are compared where |g| is 0 or at least SETTLED x eps,
# within STEP_TOL (tests/test_torch_distribution.py's pattern and bound).
TRAIN_STEPS, TRAIN_WARMUP, SETTLED, STEP_TOL = 2, 1, 10.0, 1e-4


def two_train_steps(jm, js, jacfg, tm, ts, tacfg, batch, after_first=None):
    """TRAIN_STEPS steps on `batch` under a warmup of TRAIN_WARMUP in each
    package, from the reference's state `js` and the port's `ts` ->
    (js, jax metrics, ts, port metrics) after the last;
    `after_first(js, jax metrics, ts, port metrics)` is called after the
    first (the step at lr 0)."""
    jstep = jax.jit(jax_make_train_step(jm, jacfg, None, warmup=TRAIN_WARMUP))
    tstep = make_train_step(tm, tacfg, warmup=TRAIN_WARMUP)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(TRAIN_STEPS):
        js, jmet = jstep(js, jbatch)
        ts, tmet = tstep(ts, batch)
        if i == 0 and after_first is not None:
            after_first(js, jmet, ts, tmet)
    return js, jmet, ts, tmet


def settled_mask(v, acfg):
    """Where a leaf's |g| is 0 or at least SETTLED x eps, from the second
    moment `v` after TRAIN_STEPS steps on one batch (the same g twice):
    v = (1 - b2 ** TRAIN_STEPS) g ** 2."""
    g = np.sqrt(np.asarray(v, np.float64) / (1.0 - acfg.b2 ** TRAIN_STEPS))
    return (g == 0) | (g >= SETTLED * acfg.eps)


def assert_stepped_params_close(before, js, ts, acfg):
    """The port's parameters after ``two_train_steps`` (`ts`) against the
    reference's (`js`), from the reference's `before`: each leaf with a
    gradient moved in the reference (a leaf with none at all stays where
    it was), and each leaf matches within STEP_TOL where its |g| is settled
    (``settled_mask``). Returns the count of entries left out, which must
    be under 1 % of all."""
    got = flatten_tree(train_state_to_numpy(ts)["params"])
    want = flatten_tree(numpy_tree(js.params))
    v = flatten_tree(numpy_tree(js.opt.v))
    start = flatten_tree(numpy_tree(before))
    left_out = total = 0
    for path, w in want.items():
        moved = float(np.max(np.abs(np.asarray(w, np.float32) -
                                    np.asarray(start[path], np.float32))))
        if np.any(np.asarray(v[path]) > 0):
            assert moved > 0, f"{path}: the reference's step moved nothing"
        else:
            assert moved == 0, path
        keep = settled_mask(v[path], acfg)
        left_out += int(keep.size - keep.sum())
        total += keep.size
        np.testing.assert_allclose(got[path][keep], np.asarray(w)[keep],
                                   err_msg=path, atol=STEP_TOL, rtol=0)
    assert left_out < 0.01 * total, (left_out, total)
    return left_out


# ---------------------------------------------------------------------------
# worlds of gloo processes
# ---------------------------------------------------------------------------

WORLD_TIMEOUT_S = 60.0          # a collective's wait for a peer
CASE_TIMEOUT_S = 240.0          # the parent's wait for a rank's answer


def _rank_main(rank, cfg, store, conn, cases_module):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_mesh, shutdown
    cases = importlib.import_module(cases_module).CASES
    mesh = make_mesh(cfg, "gloo", "cpu", init_method=f"file://{store}",
                     rank=rank, timeout_s=WORLD_TIMEOUT_S)
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, kw = msg
        C.reset_stats()
        try:
            conn.send(("ok", cases[name](mesh, **kw)))
        except BaseException:           # sent to the parent, which fails
            conn.send(("err", traceback.format_exc()))
    shutdown(mesh)


class World:
    """The ranks of mesh `cfg`, spawned, running the cases of
    `cases_module` (its ``CASES``: name -> fn(mesh, **kw))."""

    def __init__(self, cfg, store: str, cases_module: str):
        ctx = multiprocessing.get_context("spawn")
        self.cfg = cfg
        self.conns, self.procs = [], []
        for rank in range(cfg.n_devices):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_rank_main,
                               args=(rank, cfg, store, child, cases_module),
                               daemon=True)
            proc.start()
            self.conns.append(parent)
            self.procs.append(proc)

    def run(self, name, **kw):
        """Case `name` on every rank -> the ranks' results, by rank."""
        for conn in self.conns:
            conn.send((name, kw))
        out = []
        for rank, conn in enumerate(self.conns):
            if not conn.poll(CASE_TIMEOUT_S):
                self.close()
                pytest.fail(f"{name}: rank {rank} gave no answer in "
                            f"{CASE_TIMEOUT_S} s")
            status, value = conn.recv()
            if status != "ok":
                pytest.fail(f"{name} on rank {rank}:\n{value}")
            out.append(value)
        return out

    def close(self):
        for conn, proc in zip(self.conns, self.procs):
            if proc.is_alive():
                try:
                    conn.send(None)
                except OSError:
                    pass
        for proc in self.procs:
            proc.join(20)
            if proc.is_alive():
                proc.kill()
                proc.join(5)


def world_factory(tmp_path_factory, meshes, cases_module: str):
    """A generator for a module-scoped fixture: get(name) starts the world
    of meshes[name] once, and every world started is closed at the end."""
    started = {}

    def get(name):
        if name not in started:
            store = tmp_path_factory.mktemp(f"store_{name}") / "store"
            started[name] = World(meshes[name], str(store), cases_module)
        return started[name]

    yield get
    for world in started.values():
        world.close()
