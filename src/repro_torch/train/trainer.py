"""The training loop: data pipeline + sharded train step +
checkpointing, with exact resume (mirrors ``src/repro/train/trainer.py``).

The state lives on the mesh as DTensors placed by the partition rules;
the step is ``train_step.make_train_step``'s.  Resume restores the train
state (params, optimizer state, error-feedback residual) and the data
pipeline's state from one checkpoint, so a resumed run gives the same
bits as one that never stopped.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.optim.adamw import OptConfig
from repro_torch.sharding import partition
from repro_torch.train import train_step as ts

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    microbatches: int = 1
    compress_grads: bool = False
    async_ckpt: bool = False
    seed: int = 0


class Trainer:
    """``Trainer(cfg, shape, mesh, ocfg, tcfg)`` on a ``DeviceMesh``
    (``launch.mesh``); params, batches and state live on the mesh's
    device type."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, mesh,
                 ocfg: OptConfig | None = None,
                 tcfg: TrainerConfig | None = None):
        self.cfg = cfg
        self.shape = shape
        self.mesh = mesh
        self.ocfg = ocfg or OptConfig()
        self.tcfg = tcfg or TrainerConfig()
        self.device = torch.device(mesh.device_type)
        if self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.pipe = SyntheticPipeline.for_model(cfg, shape,
                                                seed=self.tcfg.seed,
                                                device=self.device)
        self.step = 0
        self.state = None
        self._build()

    def _build(self):
        state_shapes = ts.init_train_state(
            self.cfg, self.ocfg, compress_grads=self.tcfg.compress_grads,
            device="meta")
        batch_shapes = self.pipe.batch_at(0)
        self.step_fn, self.pspecs, self.bspecs = ts.make_train_step(
            self.cfg, self.ocfg, self.mesh, state_shapes, batch_shapes,
            microbatches=self.tcfg.microbatches,
            compress_grads=self.tcfg.compress_grads)

    def init_or_resume(self):
        """Restore the latest checkpoint under ``ckpt_dir``, else a fresh
        state from ``seed``.  Returns ("resumed" | "fresh", step)."""
        latest = ckpt.latest_step(self.tcfg.ckpt_dir)
        if latest is not None:
            state, extra, step = ckpt.restore(
                self.tcfg.ckpt_dir, latest, mesh=self.mesh,
                specs=self.pspecs)
            self.state = state
            self.step = extra.get("data_state", {}).get("step", step)
            return "resumed", self.step
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        state = ts.init_train_state(
            self.cfg, self.ocfg, gen,
            compress_grads=self.tcfg.compress_grads, device=self.device)
        self.state = partition.logical_to_sharding(state, self.pspecs,
                                                   self.mesh)
        self.step = 0
        return "fresh", 0

    def save(self, block: bool = True):
        extra = {"data_state": self.pipe.state(self.step)}
        if self.tcfg.async_ckpt and not block:
            ckpt.save_async(self.tcfg.ckpt_dir, self.step, self.state, extra)
        else:
            ckpt.save(self.tcfg.ckpt_dir, self.step, self.state, extra)
        ckpt.gc_keep_last(self.tcfg.ckpt_dir, self.tcfg.keep_ckpts)

    def train(self, n_steps: int, log=print) -> dict:
        """``n_steps`` steps from the current one; checkpoints every
        ``ckpt_every``.  Returns the last step's metrics (0-dim tensors on
        the device)."""
        if self.state is None:
            self.init_or_resume()
        metrics = {}
        for _ in range(n_steps):
            batch = partition.logical_to_sharding(
                self.pipe.batch_at(self.step), self.bspecs, self.mesh)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            self.step += 1
            if self.step % self.tcfg.log_every == 0 and log:
                log(f"step {self.step}: "
                    f"loss={float(metrics['loss']):.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"{time.perf_counter() - t0:.2f}s/step")
            if self.step % self.tcfg.ckpt_every == 0:
                self.save(block=not self.tcfg.async_ckpt)
        return metrics
