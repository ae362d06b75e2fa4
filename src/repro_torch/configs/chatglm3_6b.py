"""chatglm3-6b [dense] — 2d RoPE, GQA 32/2. [arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_kind="2d",
    rope_fraction=0.5,
    source="[arXiv:2406.12793; hf]",
)
