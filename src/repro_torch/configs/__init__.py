"""Architecture registry of the PyTorch package: --arch <id> resolves here.

Holds the dense decoder-only architectures, rwkv6-7b (``family == "ssm"``),
zamba2-7b (``family == "hybrid"``), olmoe-1b-7b and deepseek-v3-671b
(``family == "moe"``). The other families of the JAX package (VLM, audio)
join as their models are ported.
"""
from repro_torch.configs.base import (ModelConfig, MoEConfig, MLAConfig,
                                      SSMConfig, HybridConfig, EncDecConfig,
                                      CrossAttnConfig, ShapeConfig,
                                      MeshConfig, RunConfig, SHAPES,
                                      TRAIN_4K, PREFILL_32K, DECODE_32K,
                                      LONG_500K, SINGLE_POD, MULTI_POD,
                                      cell_id)

from repro_torch.configs.mistral_large_123b import CONFIG as _mistral
from repro_torch.configs.deepseek_7b import CONFIG as _ds7b
from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.chatglm3_6b import CONFIG as _chatglm
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.deepseek_v3_671b import CONFIG as _dsv3

ARCHS = {c.name: c for c in (_mistral, _ds7b, _nemotron, _chatglm, _rwkv,
                             _zamba2, _olmoe, _dsv3)}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
