"""llama3.2-3b [dense] — small llama3, GQA kv=8, 128k vocab.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.models import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="llama3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256, head_dim=128, rope_theta=500000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="llama3.2-3b-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=256, head_dim=12, rope_theta=500000.0,
        q_chunk=32, kv_chunk=32,
    )
