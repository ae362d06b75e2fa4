"""zamba2-7b [hybrid] — 81 Mamba2 blocks + shared attention blocks (2
alternating weight sets) applied periodically. [arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, HybridConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,               # Mamba2 blocks (shared attn applied every 6)
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,                # shared-block MLP ff
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    hybrid=HybridConfig(period=6, n_shared_sets=2, shared_d_ff=14336),
    source="[arXiv:2411.15242; unverified]",
)
