"""granite-20b [dense] — llama-arch code model, extreme GQA (kv=1).
[arXiv:2405.04324; hf]"""
from repro_torch.models import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="granite-20b", family="dense",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab=49152, head_dim=128, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="granite-20b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab=256, head_dim=16, q_chunk=32, kv_chunk=32,
    )
