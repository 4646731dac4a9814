"""zamba2-1.2b [hybrid] — Mamba2 backbone + weight-shared attention block
invoked every 6 layers.  [arXiv:2411.15242; hf]"""
from repro_torch.models import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32000, head_dim=64,
        ssm_state=64, ssm_headdim=64, ssm_expand=2, attn_every=6,
        scan_layers=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="zamba2-1.2b-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, head_dim=16,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, attn_every=2,
        ssm_chunk=16, scan_layers=False, q_chunk=32, kv_chunk=32,
    )
