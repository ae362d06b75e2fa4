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
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch import resolve_dtype
from repro_torch.models.model import Model
from repro_torch.optim import (AdamWConfig, OptState, adamw_update,
                               compress_grads_bf16, cosine_warmup,
                               init_adamw, init_residual, leaves, like_tree)


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
    opt = init_adamw(params, acfg)
    res = init_residual(params) if model.run.grad_compression else None
    return TrainState(params, opt, res)


def loss_and_grads(model: Model, params: Dict, batch):
    """(loss, metrics, grads): the loss detached, grads as a nested dict
    like `params`."""
    loss, metrics = model.loss_fn(batch, params)
    grads = torch.autograd.grad(loss, leaves(params))
    return loss.detach(), metrics, like_tree(params, grads)


def _microbatches(batch, n: int):
    """Split every array of the batch on its first axis into n parts, as
    the reference's reshape to (n, b // n, ...)."""
    def part(x, i):
        b = x.shape[0]
        return x.reshape(n, b // n, *x.shape[1:])[i]

    return [{k: part(v, i) for k, v in batch.items()} for i in range(n)]


def make_train_step(model: Model, acfg: AdamWConfig, *, warmup: int = 100,
                    total_steps: int = 10000):
    run = model.run
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
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, state.opt, acfg, lr_scale=lr_scale)
        return TrainState(new_params, new_opt, residual), \
            {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, _ = model.loss_fn(batch, params)
        return loss

    return eval_step
