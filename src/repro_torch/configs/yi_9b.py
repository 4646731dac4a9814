"""yi-9b [dense] — llama-arch GQA kv=4.  [arXiv:2403.04652; hf]"""
from repro_torch.models import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="yi-9b", family="dense",
        n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab=64000, head_dim=128, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="yi-9b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16, q_chunk=32, kv_chunk=32,
    )
