"""Per-(arch x shape x mesh) RunConfig presets, a copy of the JAX package's
``repro/launch/presets.py``. Its sizes were tuned there for a TPU v5e's 16
GiB a chip:

* microbatches sized so each device sees ~1 sequence per microbatch at
  train_4k (activation stash = n_layers * S * d * 2B per device with
  remat='boundaries');
* FSDP (2D weight sharding over data x model) for >=30B-param archs;
* expert FSDP for deepseek-v3 (652B expert params need sharding over both
  axes);
* decode/prefill run microbatches=1 and keep ZeRO off (no optimizer).

The port runs on one card and shards nothing yet, so of these only the
dtypes, the remat policy, the attention implementation and the
microbatches take effect. Its attention default is "blocked", as the
reference's.
"""
from __future__ import annotations

from repro_torch.configs.base import (MeshConfig, ModelConfig, RunConfig,
                                      ShapeConfig)

_BIG_PARAMS = 30e9


def preset_run(cfg: ModelConfig, shape: ShapeConfig,
               mesh_cfg: MeshConfig) -> RunConfig:
    n_params = cfg.param_count()
    big = n_params >= _BIG_PARAMS
    run = RunConfig(
        attn_impl="blocked",
        remat="boundaries",
        compute_dtype="bfloat16",
        param_dtype="bfloat16" if big else "float32",
        moment_dtype="bfloat16" if big else "float32",
        fsdp_params=big,
        fsdp_experts=(cfg.moe is not None and cfg.moe.n_experts >= 128),
        zero1=True,
    )
    if shape.mode == "train":
        dp = mesh_cfg.dp
        mb = max(1, shape.global_batch // dp)
        # small models can afford 2 seqs per microbatch
        if cfg.d_model < 4096 and mb % 2 == 0:
            mb //= 2
        run = run.with_(microbatches=mb)
    else:
        run = run.with_(microbatches=1, zero1=False, remat="nothing")
    if shape.seq_len >= 32768:
        run = run.with_(attn_block_q=1024, attn_block_kv=2048)
    return run
