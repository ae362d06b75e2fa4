"""nemotron-4-15b [dense] — GQA 48/8, squared-ReLU MLP, partial RoPE.
[arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_kind="relu2",
    rope_kind="partial",
    rope_fraction=0.5,
    source="[arXiv:2402.16819; unverified]",
)
