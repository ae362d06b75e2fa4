"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                # wkv heads = d_model / head_dim(64)
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    attention_kind="none",
    rope_kind="none",
    ssm=SSMConfig(d_state=64, head_dim=64, chunk=256),  # head_dim == wkv state dim
    source="[arXiv:2404.05892; hf]",
)
