"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2 routing, GQA kv=8.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.models import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab=32064, head_dim=128, rope_theta=10000.0,
        n_experts=16, top_k=2, d_ff_expert=6400, capacity_factor=1.25,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="phi3.5-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=256, head_dim=16,
        n_experts=4, top_k=2, d_ff_expert=96, capacity_factor=1.5,
        q_chunk=32, kv_chunk=32,
    )
