"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8 experts, MTP.
[arXiv:2412.19437; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,            # MLA: heads share a compressed latent, not GQA
    d_ff=2048,                 # per-expert ff (spec); dense layers use d_ff_dense
    vocab_size=129280,
    attention_kind="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, first_dense_layers=3, d_ff_dense=18432,
                  impl="ep_tp"),
    mtp_depth=1,
    rope_theta=10000.0,
    source="[arXiv:2412.19437; hf]",
)
