from . import checkpoint
from .data import SyntheticData
from .optimizer import AdamW, global_norm, warmup_cosine
from .train_step import make_decode_step, make_prefill_step, make_train_step
from .trainer import TorchCluster, build_training_workflow, run_training
