"""xlstm-1.3b [ssm] — mLSTM blocks with sLSTM blocks at every 8th position
(ratio per the xLSTM paper).  d_ff=0: projections live inside the cells.
[arXiv:2405.04517; unverified]"""
from repro_torch.models import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="xlstm-1.3b", family="xlstm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, head_dim=512,
        slstm_every=8, ssm_expand=2, scan_layers=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch="xlstm-1.3b-smoke", family="xlstm",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=256, head_dim=16,
        slstm_every=2, ssm_expand=2, mlstm_chunk=16, scan_layers=False,
    )
