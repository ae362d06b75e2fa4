"""llama-3.2-vision-90b [vlm] — 100 layers, gated cross-attn image layers
every 5th layer; vision frontend stubbed (precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ModelConfig, CrossAttnConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn=CrossAttnConfig(period=5, n_media_tokens=1601),
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
)
