"""Architecture registry of the PyTorch package: --arch <id> resolves here.

Holds the ten architectures of the JAX package, in its six families: the
dense decoder-only mistral-large-123b, deepseek-7b, nemotron-4-15b and
chatglm3-6b (``family == "dense"``), rwkv6-7b (``"ssm"``), zamba2-7b
(``"hybrid"``), olmoe-1b-7b and deepseek-v3-671b (``"moe"``),
llama-3.2-vision-90b (``"vlm"``) and whisper-small (``"audio"``).
"""
from dataclasses import replace

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
from repro_torch.configs.llama32_vision_90b import CONFIG as _llamav
from repro_torch.configs.whisper_small import CONFIG as _whisper

ARCHS = {c.name: c for c in (_mistral, _ds7b, _nemotron, _chatglm, _rwkv,
                             _zamba2, _olmoe, _dsv3, _llamav, _whisper)}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """The reference's grid skips: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def cut_depth(cfg: ModelConfig, layers: int) -> ModelConfig:
    """`cfg` cut to `layers` layers at full width. An MoE model keeps one
    MoE layer at least; a VLM's depth is rounded down to whole groups of
    `period` layers, and one group at least, so that it keeps a
    cross-attention layer. For the audio family the decoder is cut."""
    if cfg.moe is not None and layers <= cfg.moe.first_dense_layers:
        raise ValueError(f"--layers {layers}: {cfg.name} has "
                         f"{cfg.moe.first_dense_layers} dense layers before "
                         f"its MoE layers")
    if cfg.cross_attn is not None:
        period = cfg.cross_attn.period
        if layers < period:
            raise ValueError(f"--layers {layers}: {cfg.name} has one "
                             f"cross-attention layer in each {period}")
        layers -= layers % period
    return replace(cfg, n_layers=layers)
