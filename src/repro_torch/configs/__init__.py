"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

from typing import Dict

from repro_torch.models import ModelConfig

from . import (deepseek_67b, deepseek_v2_236b, granite_20b, llama3_2_3b,
               musicgen_large, phi3_5_moe, qwen2_vl_72b, xlstm_1_3b, yi_9b,
               zamba2_1_2b)
from . import nemotron_3_nano_30b_a3b

_MODULES = {
    "granite-20b": granite_20b,
    "deepseek-67b": deepseek_67b,
    "yi-9b": yi_9b,
    "llama3.2-3b": llama3_2_3b,
    "zamba2-1.2b": zamba2_1_2b,
    "xlstm-1.3b": xlstm_1_3b,
    "qwen2-vl-72b": qwen2_vl_72b,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe,
    "deepseek-v2-236b": deepseek_v2_236b,
    "musicgen-large": musicgen_large,
}

ARCHS = list(_MODULES.keys())
# the port's alone (no family of the JAX package's computes them): in
# ``get_config`` and ``ALL_ARCHS``, not in ``ARCHS``, which the tests hold
# against the JAX package
_MODULES["nemotron-3-nano-30b-a3b"] = nemotron_3_nano_30b_a3b
ALL_ARCHS = list(_MODULES.keys())

# shape grid assigned to every LM architecture
SHAPES: Dict[str, dict] = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES[arch]
    return mod.smoke_config() if smoke else mod.full_config()


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    """long_500k needs sub-quadratic sequence mixing (see DESIGN.md §4)."""
    if shape == "long_500k":
        return cfg.supports_long_context
    return True
