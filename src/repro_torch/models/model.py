"""Model API of the port, over the JAX package's six families and its ten
architectures: the dense decoder-only family (mistral-large-123b,
deepseek-7b, nemotron-4-15b, chatglm3-6b), the mixture of experts
(``family == "moe"``: olmoe-1b-7b with GQA, deepseek-v3-671b with MLA,
leading dense layers and an MTP block), RWKV6 (``"ssm"``: rwkv6-7b), the
Zamba2 hybrid (``"hybrid"``: zamba2-7b), the VLM (``"vlm"``:
llama-3.2-vision-90b, gated cross-attention to media embeddings) and the
encoder-decoder (``"audio"``: whisper-small, over frame embeddings).

  model = build_model(cfg, run, device="cpu", seed=0)   # device=None: the GPU
  logits = model.forward({"tokens": tokens})
  logits, caches = model.prefill({"tokens": tokens}, max_len)
  logits, caches = model.decode_step({"tokens": tokens}, caches)
  loss, metrics = model.trainable().loss_fn({"tokens": t, "labels": l})

The vlm family's batches carry ``media`` (B, n_media_tokens, d_model); the
audio family's ``frames`` (B, enc_len, d_model) for forward and prefill and
``enc_out``, the encoder's output, for decode_step. Each is cast to the
compute dtype.

``Model`` is an ``nn.Module`` that owns its parameters. Their names
(``state_dict()`` keys) are the paths of the JAX package's parameter tree
joined by dots, and their layouts are the same, layers stacked on a leading
axis: ``embed``, ``head``, ``norm``, ``layers.ln1``, ``layers.attn.wq``,
``layers.mlp.gate`` ...; for RWKV6 ``layers.wr``, ``layers.cm_k`` ...; for the
hybrid ``layers.mamba.in_proj`` (groups, then layers in a group) and
``layers.shared.attn.wq`` (weight sets); for the MoE family
``dense_layers.attn.wdq``, ``layers.moe.w_gate`` (experts leading),
``mtp.block.moe.router`` ...; for the VLM ``layers.self.attn.wq`` (groups,
then layers in a group) and ``layers.cross.attn.gate`` (groups); for the
encoder-decoder ``layers.enc.attn.wq``, ``layers.dec.cross.wq``,
``layers.dec.ln_cross`` and ``layers.enc_ln``. The serving entry points run under
``torch.no_grad()``; ``loss_fn`` runs the same forward with grad mode on, and
``trainable()`` makes the parameters require gradients (they are created
frozen). All six families train, on the card and on the CPU (the MoE loss
with the router's aux term and DeepSeek-V3's MTP loss; the vlm's with
``media`` in the batch, the audio family's with ``frames``). The train
launcher sets ``attn_impl`` to ``"full"`` or ``"blocked"``, as the
reference's does, so that a training step on the card takes the plain
chunked recurrences (``wkv_chunked``, ``ssd_chunked``) and plain attention,
and runs only the rmsnorm kernels and their backward: the flash attention,
wkv6 and ssd kernels have no backward and refuse an input that needs one.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from repro_torch import resolve_device, resolve_dtype
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


class ParamTree(nn.Module):
    """A nested dict of tensors as nested modules of parameters, so that
    ``state_dict()`` keys are the dict's paths joined by dots."""

    def __init__(self, tree: Dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def as_dict(self) -> Dict:
        out = {name: p for name, p in self._parameters.items()}
        for name, child in self._modules.items():
            out[name] = child.as_dict()
        return out


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, run: Optional[RunConfig] = None,
                 device: Optional[Union[str, torch.device]] = None):
        """Parameters are allocated on `device` in `run.param_dtype` and left
        UNINITIALISED: call `init`, or load weights (`convert.py`,
        `load_state_dict`). device=None is the GPU, and raises without one."""
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; the port holds "
                             f"{PORTED_FAMILIES}")
        self.cfg = cfg
        self.run = run or RunConfig()
        self.device = torch.device(device) if str(device) == "meta" \
            else resolve_device(device)
        self.compute_dtype = resolve_dtype(self.run.compute_dtype)
        self.param_dtype = resolve_dtype(self.run.param_dtype)
        # pad the vocabulary to a multiple of 128; padded logit columns are
        # masked to -1e30 in _logits
        v = cfg.vocab_size
        self.padded_vocab = v if v % 128 == 0 else (v // 128 + 1) * 128
        self.tree = ParamTree(self._param_shapes()).to_empty(
            device=self.device)

    # ------------------------------------------------------------------ init
    def _param_shapes(self) -> Dict:
        """The parameter tree on the meta device: names, shapes, dtype."""
        cfg = self.cfg
        kw = dict(dtype=self.param_dtype, device="meta")
        table = torch.empty((self.padded_vocab, cfg.d_model), **kw)
        p = {"embed": table, "norm": torch.empty((cfg.d_model,), **kw)}
        if not cfg.tie_embeddings:
            p["head"] = table.clone()
        if cfg.family == "dense":
            p["layers"] = T.init_stack(cfg, cfg.n_layers, "dense", **kw)
        elif cfg.family == "moe":
            n_dense = cfg.moe.first_dense_layers
            if n_dense:
                p["dense_layers"] = T.init_stack(
                    cfg, n_dense, "dense", d_ff=cfg.moe.d_ff_dense, **kw)
            p["layers"] = T.init_stack(cfg, cfg.n_layers - n_dense, "moe",
                                       **kw)
            if cfg.mtp_depth:
                p["mtp"] = {
                    "proj": torch.empty((2 * cfg.d_model, cfg.d_model), **kw),
                    "block": T.init_block(None, cfg, "moe", **kw),
                    "norm": torch.empty((cfg.d_model,), **kw)}
        elif cfg.family == "ssm":
            p["layers"] = T.init_rwkv_stack(cfg, **kw)
        elif cfg.family == "hybrid":
            p["layers"] = T.init_hybrid(cfg, **kw)
        elif cfg.family == "vlm":
            p["layers"] = T.init_vlm(cfg, **kw)
        else:
            p["layers"] = T.init_encdec(cfg, **kw)
        return p

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None,
             seed: int = 0) -> "Model":
        """Fill the parameters in place from `generator` (which must live on
        the model's device), or from a new one seeded with `seed`. Weights
        are drawn straight onto the device, leaf by leaf and layer by layer,
        and stored in `param_dtype`."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        cfg, params = self.cfg, self.params
        kw = dict(dtype=self.param_dtype, device=self.device)
        params["embed"].copy_(L.init_embed(generator, self.padded_vocab,
                                           cfg.d_model, **kw))
        params["norm"].fill_(1.0)
        if "head" in params:
            params["head"].copy_(L.dense_init(
                generator, (self.padded_vocab, cfg.d_model),
                in_axis_size=cfg.d_model, **kw))
        if cfg.family == "dense":
            T.fill_stack(params["layers"], generator, cfg, "dense")
        elif cfg.family == "moe":
            if "dense_layers" in params:
                T.fill_stack(params["dense_layers"], generator, cfg, "dense",
                             d_ff=cfg.moe.d_ff_dense)
            T.fill_stack(params["layers"], generator, cfg, "moe")
            if "mtp" in params:
                mtp = params["mtp"]
                mtp["proj"].copy_(L.dense_init(
                    generator, (2 * cfg.d_model, cfg.d_model), **kw))
                T.fill_block(mtp["block"], generator, cfg, "moe")
                mtp["norm"].fill_(1.0)
        elif cfg.family == "ssm":
            T.fill_rwkv_stack(params["layers"], generator, cfg)
        elif cfg.family == "hybrid":
            T.fill_hybrid(params["layers"], generator, cfg)
        elif cfg.family == "vlm":
            T.fill_vlm(params["layers"], generator, cfg)
        else:
            T.fill_encdec(params["layers"], generator, cfg)
        return self

    @property
    def params(self) -> Dict:
        """The parameters as the nested dict the layer functions take."""
        return self.tree.as_dict()

    def state_dict(self, *args, **kwargs):
        """Keys are the parameter tree's paths joined by dots, without the
        name of the module that holds them."""
        return self.tree.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self.tree.load_state_dict(state_dict, *args, **kwargs)

    def trainable(self, flag: bool = True) -> "Model":
        """Make every parameter require a gradient (or none, flag=False)."""
        self.tree.requires_grad_(flag)
        return self

    # --------------------------------------------------------------- forward
    def _tokens(self, batch) -> torch.Tensor:
        return torch.as_tensor(batch["tokens"]).to(self.device).long()

    def _extra(self, batch, name: str) -> torch.Tensor:
        """batch[name] (media, frames or enc_out) on the model's device in
        the compute dtype."""
        return torch.as_tensor(batch[name]).to(self.device,
                                               self.compute_dtype)

    def _embed(self, params, tokens):
        return L.embed(params["embed"], tokens, self.compute_dtype)

    def _logits(self, params, x):
        x = L.rms_norm(x, params["norm"], self.cfg.norm_eps)
        head = params["embed"] if self.cfg.tie_embeddings else params["head"]
        lg = L.logits(head, x)
        if self.padded_vocab != self.cfg.vocab_size:
            lg[..., self.cfg.vocab_size:] = -1e30
        return lg

    @torch.no_grad()
    def forward(self, batch) -> torch.Tensor:
        """Full-sequence forward -> logits (B, S, padded_vocab)."""
        return self._forward(self.params, batch)

    def loss_fn(self, batch, params: Optional[Dict] = None):
        """Token-mean cross entropy of the next-token logits against
        batch["labels"] (labels < 0 masked) -> (loss, metrics), on the
        forward with grad mode as the caller has it. `params` defaults to
        the model's own. The reference's loss: for the MoE family
        ``cfg.moe.router_aux_weight`` times the MoE stack's summed
        load-balance term is added (the leading dense layers' and the MTP
        block's aux are dropped, as there), then 0.3 times the MTP loss
        when the config has an MTP block (``_mtp_loss``). metrics: "ce" (the
        cross entropy before the two terms) and "aux", as the reference's;
        for an MTP block also "mtp", which the reference computes and does
        not report. aux is 0 for the dense, ssm and hybrid families."""
        cfg = self.cfg
        params = self.params if params is None else params
        h, aux = self._hidden(params, batch)
        labels = torch.as_tensor(batch["labels"]).to(self.device).long()
        ce = L.cross_entropy(self._logits(params, h), labels)
        metrics = {"ce": ce.detach(), "aux": aux.detach()}
        loss = ce
        if cfg.moe is not None:
            loss = loss + cfg.moe.router_aux_weight * aux
        if cfg.mtp_depth and "mtp" in params:
            mtp = self._mtp_loss(params, h, batch, labels)
            metrics["mtp"] = mtp.detach()
            loss = loss + 0.3 * mtp
        return loss, metrics

    def _mtp_loss(self, params, h, batch, labels):
        """DeepSeek-V3's multi-token prediction, as the reference's: one
        more moe block predicts token t + 2 from (norm(h_t), embed(token
        t + 1)); h is the stack's output before the final norm."""
        cfg, run = self.cfg, self.run
        mp = params["mtp"]
        tokens = self._tokens(batch)
        hn = L.rms_norm(h[:, :-1], mp["norm"], cfg.norm_eps)
        nxt = self._embed(params, tokens[:, 1:])
        x = torch.cat([hn, nxt], dim=-1) @ mp["proj"].to(hn.dtype)
        x, _ = T.block(mp["block"], x, cfg, run, kind="moe",
                       positions=torch.arange(x.shape[1], device=self.device))
        lg = self._logits(params, x)
        return L.cross_entropy(lg[:, :-1], labels[:, 2:])

    def _forward(self, params, batch) -> torch.Tensor:
        return self._logits(params, self._hidden(params, batch)[0])

    def _hidden(self, params, batch):
        """(h, aux): the stack's output before the final norm, and the MoE
        stack's summed load-balance loss (0 for the other families)."""
        tokens = self._tokens(batch)
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=self.device)
        cfg, run = self.cfg, self.run
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        if cfg.family == "dense":
            x, aux = T.stack(params["layers"], x, cfg, run, kind="dense",
                             positions=positions)
        elif cfg.family == "moe":
            if "dense_layers" in params:
                x, _ = T.stack(params["dense_layers"], x, cfg, run,
                               kind="dense", positions=positions)
            x, aux = T.stack(params["layers"], x, cfg, run, kind="moe",
                             positions=positions)
        elif cfg.family == "ssm":
            x = T.rwkv_stack(params["layers"], x, cfg, run)
        elif cfg.family == "hybrid":
            x = T.hybrid_stack(params["layers"], x, cfg, run,
                               positions=positions)
        elif cfg.family == "vlm":
            x = T.vlm_stack(params["layers"], x, self._extra(batch, "media"),
                            cfg, run, positions=positions)
        else:
            x = T.encdec_apply(params["layers"], self._extra(batch, "frames"),
                               x, cfg, run, positions=positions)
        return x, aux

    # --------------------------------------------------------------- serving
    def init_caches(self, batch: int, max_len: int, *, device=None,
                    quant: Optional[bool] = None) -> Dict:
        """Zeroed caches on `device` (default: the model's), stacked on a
        leading layer axis:
          dense:  k, v (L, B, max_len, K, D) in the compute dtype, pos (L, B)
                  int32; under ``kv_cache_dtype="int8"`` (or `quant`) k, v
                  in int8 beside bfloat16 k_scale, v_scale (L, B, max_len,
                  K, 1), in every GQA cache of every family (MLA and RWKV
                  keep theirs as they are, as in the reference);
          moe:    {"dense": the first dense layers', "moe": the moe
                  layers'}, each the dense tree or, for MLA, ckv
                  (L, B, max_len, r), kr (L, B, max_len, rope), pos (L, B);
          ssm:    wkv (L, B, H, K, K) float32, tm_last, cm_last (L, B, d);
          hybrid: {"mamba": {h (G, period, B, H, N, P) float32,
                   conv (G, period, B, W-1, conv_dim)}, "attn": the dense
                   tree with G in place of L};
          vlm:    the dense tree of the self-attention blocks, (G,
                  period - 1) in place of L (cross blocks keep no cache);
          audio:  the dense tree of the decoder's layers."""
        cfg, dt = self.cfg, self.compute_dtype
        device = self.device if device is None else device
        q8 = self.run.kv_cache_dtype == "int8" if quant is None else quant

        def stacked(n, one):
            return T.tree_map(lambda a: a.new_zeros((n, *a.shape)), one)

        def kv():
            if cfg.attention_kind == "mla":
                return A.init_mla_cache(cfg, batch, max_len, dt, device=device)
            return A.init_gqa_cache(cfg, batch, max_len, dt, device=device,
                                    quant=q8)

        if cfg.family in ("dense", "audio"):
            return stacked(cfg.n_layers, kv())
        if cfg.family == "vlm":
            G, n_self = T.vlm_groups(cfg), cfg.cross_attn.period - 1
            return T.tree_map(lambda a: a.new_zeros((G, n_self, *a.shape)),
                              kv())
        if cfg.family == "moe":
            n_dense = cfg.moe.first_dense_layers
            out = {"moe": stacked(cfg.n_layers - n_dense, kv())}
            if n_dense:
                out["dense"] = stacked(n_dense, kv())
            return out
        if cfg.family == "ssm":
            return stacked(cfg.n_layers,
                           R.init_rwkv_cache(cfg, batch, dt, device=device))
        G, period = T.hybrid_groups(cfg), cfg.hybrid.period
        m = SSM.init_mamba2_cache(cfg, batch, dt, device=device)
        return {"mamba": T.tree_map(
                    lambda a: a.new_zeros((G, period, *a.shape)), m),
                "attn": stacked(G, kv())}

    @torch.no_grad()
    def prefill(self, batch, max_len: int):
        """Process a prompt, return (last-position logits (B, 1, V), caches).
        The dense and moe families fill their caches (moe: the KV or MLA
        latent caches of its dense and moe layers). For the other families
        the reference returns ZEROED caches (its serving engine
        teacher-forces prompts through `decode_step`), and so does the port,
        after running the stack over the prompt. For every family only the
        last position's hidden state goes through the final norm and the
        head, so the logits own B x 1 x V elements and no (B, S, V) logits
        are made (for these families the reference slices the whole
        forward's).

        As in the reference, the dense and moe caches hold the prompt's k
        and v in the compute dtype even under ``kv_cache_dtype="int8"``
        (no scales), so decode after a prefill takes the compute-dtype
        branch."""
        tokens = self._tokens(batch)
        B, S = tokens.shape
        cfg, run = self.cfg, self.run
        params = self.params
        if cfg.family not in ("dense", "moe"):
            h, _ = self._hidden(params, batch)
            last = self._logits(params, h[:, -1:])
            del h                       # freed before the caches are made
            return last, self.init_caches(B, max_len)
        x = self._embed(params, tokens)
        positions = torch.arange(S, device=self.device)
        names = ("ckv", "kr") if cfg.attention_kind == "mla" else ("k", "v")

        def run_stack(layers, kind):
            nonlocal x
            x, kv = T.stack_prefill(layers, x, cfg, run, kind=kind,
                                    positions=positions, pad_to=max_len)
            pos = torch.full((kv[0].shape[0], B), S, dtype=torch.int32,
                             device=self.device)
            return {**dict(zip(names, kv)), "pos": pos}

        if cfg.family == "dense":
            caches = run_stack(params["layers"], "dense")
        else:
            caches = {}
            if "dense_layers" in params:
                caches["dense"] = run_stack(params["dense_layers"], "dense")
            caches["moe"] = run_stack(params["layers"], "moe")
        return self._logits(params, x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, batch, caches):
        """One token for every sequence in the batch -> (logits (B, 1, V),
        caches). The caches are updated in place and handed back."""
        params = self.params
        tokens = self._tokens(batch)                     # (B, 1)
        x = self._embed(params, tokens)
        cfg, run = self.cfg, self.run
        if cfg.family == "dense":
            x, caches = T.stack_decode(params["layers"], x, caches, cfg, run,
                                       kind="dense")
        elif cfg.family == "moe":
            if "dense_layers" in params:
                x, _ = T.stack_decode(params["dense_layers"], x,
                                      caches["dense"], cfg, run, kind="dense")
            x, _ = T.stack_decode(params["layers"], x, caches["moe"], cfg, run,
                                  kind="moe")
        elif cfg.family == "ssm":
            x, caches = T.rwkv_stack_decode(params["layers"], x, caches, cfg,
                                            run)
        elif cfg.family == "hybrid":
            x, caches = T.hybrid_stack_decode(params["layers"], x, caches,
                                              cfg, run)
        elif cfg.family == "vlm":
            x, caches = T.vlm_stack_decode(params["layers"], x,
                                           self._extra(batch, "media"),
                                           caches, cfg, run)
        else:
            x, caches = T.encdec_decode(params["layers"], x,
                                        self._extra(batch, "enc_out"),
                                        caches, cfg, run)
        return self._logits(params, x), caches


def build_model(cfg: ModelConfig, run: Optional[RunConfig] = None, *,
                device: Optional[Union[str, torch.device]] = None,
                seed: int = 0) -> Model:
    """A model on `device` (None: the GPU) with weights drawn from `seed`."""
    return Model(cfg, run, device=device).init(seed=seed)


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def analytic_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from the shapes of the model's parameters on
    the meta device: nothing is allocated. `active_only` counts top_k /
    n_experts of the routed experts' leaves, as the reference does (the MTP
    block's included); for the other families it is every parameter
    (whisper's decoder layers count their unused cross-attention gates, as
    the reference's do)."""
    model = Model(cfg, RunConfig(), device="meta")
    total = expert = 0
    for name, p in model.tree.named_parameters():
        total += p.numel()
        if name.rsplit(".", 1)[-1] in EXPERT_LEAVES:
            expert += p.numel()
    if not active_only or cfg.moe is None:
        return total
    return int(total - expert + expert * (cfg.moe.top_k / cfg.moe.n_experts))
