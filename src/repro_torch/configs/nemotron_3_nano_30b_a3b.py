"""nemotron-3-nano-30b-a3b [nemotron_h] — 52 blocks by the published
``hybrid_override_pattern``: 23 Mamba2 (64 heads of 64, N 128 in 8 groups,
conv over x, B and C, the gate before a grouped norm), 23 MoE (128 relu²
experts 1856 wide, top-6 by sigmoid with a correction bias, normalised ×
2.5, one shared expert 3712 wide) and 6 GQA attention blocks (32/2 heads of
128, no position embedding).  [hf: nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16]"""
from repro_torch.models import ModelConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"


def full_config() -> ModelConfig:
    return ModelConfig(
        arch="nemotron-3-nano-30b-a3b", family="nemotron_h",
        n_layers=len(PATTERN), d_model=2688, n_heads=32, n_kv_heads=2,
        d_ff=1856, vocab=131072, head_dim=128, rms_eps=1e-5,
        n_experts=128, top_k=6, n_shared_experts=1, d_ff_expert=1856, d_ff_shared=3712,
        capacity_factor=None, norm_topk_prob=True, routed_scaling_factor=2.5,
        router_scoring="sigmoid", expert_act="relu2",
        ssm_state=128, ssm_headdim=64, ssm_inner=64 * 64, ssm_chunk=128,
        ssm_groups=8, ssm_conv_bc=True, ssm_gate_norm_groups=True,
        layer_pattern=PATTERN, scan_layers=False,
    )


def smoke_config() -> ModelConfig:
    pattern = "MEM*EM"
    return ModelConfig(
        arch="nemotron-3-nano-smoke", family="nemotron_h",
        n_layers=len(pattern), d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=256, head_dim=16, rms_eps=1e-5,
        n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=32, d_ff_shared=64,
        capacity_factor=None, norm_topk_prob=True, routed_scaling_factor=2.5,
        router_scoring="sigmoid", expert_act="relu2",
        ssm_state=16, ssm_headdim=16, ssm_inner=64, ssm_chunk=16,
        ssm_groups=2, ssm_conv_bc=True, ssm_gate_norm_groups=True,
        layer_pattern=pattern, scan_layers=False, q_chunk=32, kv_chunk=32,
    )
