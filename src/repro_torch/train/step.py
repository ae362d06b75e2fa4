"""Train and eval steps, as the reference's ``repro/train/step.py``.

``make_train_step(model, acfg)`` returns ``(state, batch) -> (state,
metrics)`` with:
  * microbatch gradient accumulation (``RunConfig.microbatches``) in
    ``RunConfig.accum_dtype``: a Python loop where the reference scans, so
    activation memory is bounded by one microbatch;
  * optional bfloat16 gradient compression with a float32 error-feedback
    residual carried in the train state;
  * AdamW (``optim/adamw.py``) under the cosine-warmup schedule.

The step's metrics are the loss, the loss function's own ("ce", "aux" and,
with an MTP block, "mtp"; the means over the microbatches), "grad_norm" and
"lr". The reference's step reports the loss, "grad_norm" and "lr" only.

The state's tensors are updated in place (``adamw_update``): the state
handed back holds the same parameter and moment tensors. Gradients are
``torch.autograd.grad`` of ``Model.loss_fn`` with respect to
``state.params``; on the card every norm's gradient goes through the
rmsnorm backward kernel.

Over the model's mesh (``model.mesh``) the state is this rank's:
the parameters are the model's blocks, and the moments and the master
ZeRO-1's blocks of them (``rules.opt_state_specs``). A step takes this
rank's block of the batch; the gradients of the microbatches are summed
locally and reduced once: all-reduced over the batch axes ('pod', 'data';
in bfloat16 under ``grad_compression``, after the error feedback), except
over 'data' for a leaf ``fsdp_params`` or ``fsdp_experts`` splits there,
whose gather's backward has reduce-scattered it already. The clip takes
the norm over the mesh (``global_norm``), AdamW updates this rank's
blocks, and each parameter's updated blocks are all-gathered over the
ZeRO-1 axes.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_dtype
from repro_torch.models.model import Model
from repro_torch.optim import (AdamWConfig, OptState, adamw_update,
                               compress_grads_bf16, cosine_warmup,
                               init_adamw, init_residual, leaves, like_tree)
from repro_torch.optim.adamw import _spec_leaves, global_norm
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules


class TrainState(NamedTuple):
    params: Dict
    opt: OptState
    residual: Optional[Dict]      # grad-compression error feedback


def init_train_state(model: Model, seed: Optional[int],
                     acfg: AdamWConfig) -> TrainState:
    """The model's weights drawn from `seed` (None: the weights it holds,
    e.g. loaded by ``convert.params_from_numpy``), made trainable, with
    zeroed AdamW moments (and residual, with grad compression) beside
    them. The state's params are the model's own parameter tensors."""
    if seed is not None:
        model.init(seed=seed)
    params = model.trainable().params
    blocks = None
    if model.mesh is not None:
        blocks = like_tree(params, [blk for _, blk, _ in _zero_blocks(
            model, params)])
    opt = init_adamw(params, acfg, blocks)
    res = init_residual(params) if model.run.grad_compression else None
    return TrainState(params, opt, res)


def state_specs(model: Model) -> Tuple[Dict, Dict]:
    """(param specs, state specs) of `model`'s leaves over its mesh:
    ZeRO-1's extension of each param spec."""
    mesh = model.mesh
    return model.specs, rules.map_with_path(
        lambda path, spec, shape: rules.state_spec(spec, shape, mesh,
                                                   model.run),
        model.specs, model.full_shapes)


def _zero_blocks(model: Model, tree) -> List:
    """(leaf, its block under ZeRO-1, the (dim, axis) cut) for each leaf of
    `tree` (laid out like the params), in ``leaves`` order. The block is a
    view where the cut allows one (dim 0), else a contiguous copy."""
    pspecs, sspecs = state_specs(model)
    out = []
    for t, ps, ss in zip(leaves(tree), _spec_leaves(pspecs),
                         _spec_leaves(sspecs)):
        cut = [(i, e) for i, e in enumerate(ss)
               if e is not None and (i >= len(ps) or ps[i] is None)]
        blk = rules.shard_tensor(t, ss, model.mesh, base=ps) if cut else t
        out.append((t, blk if blk.is_contiguous() else blk.contiguous(),
                    cut))
    return out


def _reduce_grads(model: Model, grads: Dict) -> Dict:
    """Sum each gradient over the batch axes, IN PLACE, leaving out 'data'
    for a leaf split over 'data' (its gradient is summed already)."""
    mesh = model.mesh
    batch = mesh.normalise(("pod", "data"))
    for g, spec in zip(leaves(grads), _spec_leaves(model.specs)):
        axes = tuple(a for a in batch if a not in rules.spec_axes(spec))
        C.reduce_(g, mesh, axes)
    return grads


def loss_and_grads(model: Model, params: Dict, batch):
    """(loss, metrics, grads): the loss detached, grads as a nested dict
    like `params`. A leaf that the forward never reads gets a zero gradient
    of its shape and dtype, as under ``jax.value_and_grad``: whisper's
    decoder layers hold a cross-attention gate (``layers.dec.cross.gate``)
    that its ungated cross-attention does not use."""
    loss, metrics = model.loss_fn(batch, params)
    grads = torch.autograd.grad(loss, leaves(params), materialize_grads=True)
    return loss.detach(), metrics, like_tree(params, grads)


def _microbatches(batch, n: int):
    """Split every array of the batch on its first axis into n parts, as
    the reference's reshape to (n, b // n, ...)."""
    def part(x, i):
        b = x.shape[0]
        return x.reshape(n, b // n, *x.shape[1:])[i]

    return [{k: part(v, i) for k, v in batch.items()} for i in range(n)]


def make_train_step(model: Model, acfg: AdamWConfig, *,
                    warmup: int = 100, total_steps: int = 10000):
    """The step over the model's mesh (None on one device)."""
    run = model.run
    mesh = model.mesh
    n_micro = max(1, run.microbatches)
    acc_dt = resolve_dtype(run.accum_dtype)

    def train_step(state: TrainState, batch):
        params = state.params
        if n_micro > 1:
            grads = None
            sums = {}
            for mb in _microbatches(batch, n_micro):
                loss, metrics, g = loss_and_grads(model, params, mb)
                flat = [t.to(acc_dt) for t in leaves(g)]
                if grads is None:
                    grads = flat
                else:
                    for a, t in zip(grads, flat):
                        a.add_(t)
                for name, value in {"loss": loss, **metrics}.items():
                    sums[name] = sums.get(name, 0.0) + value
            grads = like_tree(params, [a / n_micro for a in grads])
            metrics = {name: value / n_micro for name, value in sums.items()}
            loss = metrics.pop("loss")
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch)

        residual = state.residual
        if run.grad_compression:
            grads, residual = compress_grads_bf16(grads, residual)

        lr_scale = cosine_warmup(state.opt.step, warmup=warmup,
                                 total=total_steps)
        if mesh is None:
            new_params, new_opt, opt_metrics = adamw_update(
                params, grads, state.opt, acfg, lr_scale=lr_scale)
        else:
            new_opt, opt_metrics = _sharded_update(model, params, grads,
                                                   state.opt, acfg, lr_scale)
            new_params = params
        return TrainState(new_params, new_opt, residual), \
            {"loss": loss, **metrics, **opt_metrics}

    return train_step


@torch.no_grad()
def _sharded_update(model: Model, params, grads, opt: OptState,
                    acfg: AdamWConfig, lr_scale):
    """The data-parallel reduction, the clip over the mesh, AdamW on this
    rank's ZeRO-1 blocks, and the updated blocks all-gathered into the
    parameters, IN PLACE."""
    mesh = model.mesh
    grads = _reduce_grads(model, grads)
    gnorm = global_norm(grads, mesh, model.specs)
    pblocks = _zero_blocks(model, params)
    gblocks = [blk for _, blk, _ in _zero_blocks(model, grads)]
    _, opt, metrics = adamw_update(
        like_tree(params, [blk for _, blk, _ in pblocks]),
        like_tree(params, gblocks), opt, acfg, lr_scale=lr_scale,
        gnorm=gnorm)
    for p, blk, cut in pblocks:
        cur = blk
        for n, (dim, axis) in enumerate(reversed(cut)):
            last = n == len(cut) - 1
            shape = list(cur.shape)
            shape[dim] *= C.axis_size(mesh, axis)
            out = p if last else cur.new_empty(shape)
            C.gather_into_(out, cur, mesh, axis, dim)
            cur = out
    return opt, metrics


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, _ = model.loss_fn(batch, params)
        return loss

    return eval_step
