"""whisper-small [audio] — enc-dec; conv frontend stubbed (precomputed frame
embeddings). 12 encoder + 12 decoder layers. [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig, EncDecConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,               # decoder layers; encoder in encdec config
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    rope_kind="none",          # whisper uses learned/sinusoidal positions
    mlp_kind="gelu",
    encdec=EncDecConfig(n_encoder_layers=12, enc_len=1500),
    source="[arXiv:2212.04356; unverified]",
)
