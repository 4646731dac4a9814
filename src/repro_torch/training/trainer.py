"""Triggerflow-orchestrated training: the training loop *is* an ASF state
machine (the paper's §5.2 engine) over the port's Triggerflow, with a
torch executor on one device as the "serverless function" backend.

    TrainChunk ──▶ Gate(Choice) ──▶ TrainChunk …
                          └──▶ Eval ──▶ Done(Succeed)

Each TrainChunk task runs N optimizer steps, checkpoints in the JAX
package's layout (``training.checkpoint``) and emits a termination event
carrying {step, loss}; the Choice trigger loops until the target step
count.  Kill the worker mid-run and restart on the same workdir: Triggerflow
replays uncommitted events while the executor restores the latest
checkpoint.  ``TorchCluster`` takes the reference's ``JaxCluster``'s
place; it runs on an explicit device, the card unless the caller passes
the CPU.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core import Triggerflow
from ..core.statemachine import StateMachine
from ..models import Model, ModelConfig
from ..models.convert import params_from_jax, params_to_jax
from . import checkpoint as ckpt_lib
from .data import SyntheticData
from .optimizer import AdamW, warmup_cosine
from .train_step import make_train_step


class TorchCluster:
    """Host-side training executor (the data plane the triggers orchestrate)."""

    def __init__(self, cfg: ModelConfig, workdir: str, batch: int, seq: int,
                 peak_lr: float = 3e-4, total_steps: int = 1000,
                 data_kind: str = "copy_task", seed: int = 0,
                 accum_steps: int = 1, device="cuda"):
        self.cfg = cfg
        self.workdir = workdir
        self.device = torch.device(device)
        self.opt = AdamW(lr=warmup_cosine(peak_lr, warmup=20, total=total_steps))
        self.data = SyntheticData(cfg.vocab, seq, batch, kind=data_kind, seed=seed,
                                  codebooks=cfg.codebooks)
        self.accum_steps = accum_steps
        self.step = 0
        self.model: Optional[Model] = None
        self.opt_state = None
        self.step_fn = None
        self.history: list = []

    # -- state ------------------------------------------------------------------
    def _params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def ensure_state(self) -> None:
        """Build the model (seed 0) and the optimizer's state, then load the
        latest checkpoint under the workdir, if there is one."""
        if self.model is not None:
            return
        self.model = Model(self.cfg, device=self.device, seed=0)
        self.step_fn = make_train_step(self.model, self.opt, self.accum_steps)
        params = self._params()
        self.opt_state = self.opt.init(params)
        if ckpt_lib.latest_step(self.workdir) is None:
            return
        like = self._reference_trees()
        self.step, tree, opt_tree, _ = ckpt_lib.restore(self.workdir, *like)
        with torch.no_grad():
            for k, t in params_from_jax(_numpy(tree)).items():
                params[k].copy_(t)
            for moment in ("m", "v"):
                for k, t in params_from_jax(_numpy(opt_tree[moment])).items():
                    self.opt_state[moment][k].copy_(t)
        self.opt_state["count"] = opt_tree["count"]

    def _reference_trees(self):
        """The parameters and the optimizer's state in the reference's
        layout, on the CPU, as the checkpoint stores them."""
        cpu = {k: p.detach().cpu() for k, p in self._params().items()}
        params = params_to_jax(cpu, self.cfg)
        opt = {m: params_to_jax({k: t.cpu() for k, t in self.opt_state[m].items()},
                                self.cfg) for m in ("m", "v")}
        return params, {**opt, "count": self.opt_state["count"]}

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).long().to(self.device)
                for k, v in self.data.batch_at(step).items()}

    # -- the "serverless function" ------------------------------------------------
    def train_chunk(self, args: Dict[str, Any]) -> Dict[str, Any]:
        self.ensure_state()
        n = int(args.get("steps", 10))
        losses = []
        t0 = time.time()
        for _ in range(n):
            self.opt_state, metrics = self.step_fn(self.opt_state, self.batch_at(self.step))
            self.step += 1
            losses.append(float(metrics["loss"]))
        ckpt_lib.save(self.workdir, self.step, *self._reference_trees(),
                      extra={"loss": losses[-1]})
        rec = {"step": self.step, "loss": losses[-1],
               "loss_mean": float(np.mean(losses)),
               "wall_s": round(time.time() - t0, 3)}
        self.history.append(rec)
        return rec

    def evaluate(self, args: Dict[str, Any]) -> Dict[str, Any]:
        self.ensure_state()
        with torch.no_grad():
            loss, _ = self.model.loss(self.batch_at(10 ** 6 + self.step))  # held-out stream
        return {"step": self.step, "eval_loss": float(loss)}


def _numpy(tree):
    """A restored tree of tensors as numpy leaves, which
    ``params_from_jax`` reads (bf16 through fp32, exactly)."""
    return {k: _numpy(v) if isinstance(v, dict) else
            (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in tree.items()}


def build_training_workflow(tf: Triggerflow, cluster: TorchCluster, workflow: str,
                            total_steps: int, chunk_steps: int = 10,
                            eval_every_chunks: int = 0) -> StateMachine:
    """Compile the training loop to an ASF state machine over triggers."""
    tf.backend.register(f"{workflow}:train_chunk",
                        lambda args: cluster.train_chunk(
                            {**(args if isinstance(args, dict) else {}),
                             "steps": chunk_steps}))
    tf.backend.register(f"{workflow}:evaluate", cluster.evaluate)
    defn = {
        "StartAt": "TrainChunk",
        "States": {
            "TrainChunk": {"Type": "Task", "Resource": f"{workflow}:train_chunk",
                           "Next": "Gate"},
            "Gate": {"Type": "Choice",
                     "Choices": [{"Variable": "$.result.step", "Op": "lt",
                                  "Value": total_steps, "Next": "TrainChunk"}],
                     "Default": "Eval" if eval_every_chunks else "Done"},
            "Done": {"Type": "Succeed"},
        },
    }
    if eval_every_chunks:
        defn["States"]["Eval"] = {"Type": "Task",
                                  "Resource": f"{workflow}:evaluate",
                                  "Next": "Done"}
    sm = StateMachine(defn)
    sm.deploy(tf, workflow)
    return sm


def run_training(cfg: ModelConfig, workdir: str, total_steps: int = 50,
                 chunk_steps: int = 10, batch: int = 8, seq: int = 128,
                 tf: Optional[Triggerflow] = None, peak_lr: float = 3e-4,
                 timeout: float = 3600.0, device="cuda") -> Dict[str, Any]:
    """End-to-end: a trigger-orchestrated training run on ``device`` (the
    Triggerflow's too, when this makes it).  Returns the final state."""
    tf = tf or Triggerflow(inline_functions=True, device=device)
    cluster = TorchCluster(cfg, workdir, batch, seq, peak_lr=peak_lr,
                           total_steps=total_steps, device=device)
    wf = f"train-{cfg.arch}-{os.path.basename(workdir)}"
    sm = build_training_workflow(tf, cluster, wf, total_steps, chunk_steps,
                                 eval_every_chunks=1)
    result = sm.run(tf, wf, timeout=timeout)
    return {"workflow_result": result, "history": cluster.history,
            "cluster": cluster}
