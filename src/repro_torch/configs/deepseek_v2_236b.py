"""deepseek-v2-236b [moe] — MLA (kv_lora=512, q_lora=1536, decoupled RoPE) +
160 routed experts top-6 + 2 shared experts; first layer dense FFN.
[arXiv:2405.04434; hf]"""
from repro_torch.models import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="deepseek-v2-236b", family="mla_moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=1536, vocab=102400, head_dim=192,
        n_experts=160, top_k=6, n_shared_experts=2, d_ff_expert=1536,
        capacity_factor=1.25, moe_layer_start=1,
        q_lora=1536, kv_lora=512, nope_head_dim=128, rope_head_dim=64,
        v_head_dim=128,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="deepseek-v2-smoke", family="mla_moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab=256, head_dim=24,
        n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=64,
        capacity_factor=1.5, moe_layer_start=1,
        q_lora=32, kv_lora=16, nope_head_dim=16, rope_head_dim=8, v_head_dim=16,
        q_chunk=32, kv_chunk=32,
    )
