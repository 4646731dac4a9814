"""qwen2-vl-72b [vlm] — dense GQA backbone + M-RoPE; the vision frontend is a
STUB (input_specs supplies precomputed patch embeddings + positions).
[arXiv:2409.12191; hf]"""
from repro_torch.models import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, head_dim=128, rope_theta=1000000.0,
        mrope_sections=(16, 24, 24), n_patches=1024,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-vl-72b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        mrope_sections=(2, 3, 3), n_patches=8, q_chunk=32, kv_chunk=32,
    )
