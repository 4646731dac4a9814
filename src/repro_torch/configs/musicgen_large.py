"""musicgen-large [audio] — decoder-only over 4 EnCodec codebooks (summed
codebook embeddings in, 4 LM heads out); the EnCodec frontend is a STUB
(input_specs supplies token grids).  [arXiv:2306.05284; hf]"""
from repro_torch.models import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=2048, head_dim=64, codebooks=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="musicgen-large-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=64, head_dim=16, codebooks=4,
        q_chunk=32, kv_chunk=32,
    )
