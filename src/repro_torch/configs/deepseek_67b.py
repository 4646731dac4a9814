"""deepseek-67b [dense] — llama-arch, GQA kv=8, 95 layers.
[arXiv:2401.02954; hf]"""
from repro_torch.models import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="deepseek-67b", family="dense",
        n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab=102400, head_dim=128, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="deepseek-67b-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16, q_chunk=32, kv_chunk=32,
    )
