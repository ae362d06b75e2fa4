"""Helpers shared by the tests of the PyTorch package: the same numpy data
handed to both packages, and models of both built on the same weights."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.models import build_model as jax_build_model

from repro_torch.configs import RunConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import Model

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
