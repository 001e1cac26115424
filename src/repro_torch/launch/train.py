"""Training launcher: ``python -m repro_torch.launch.train --arch
granite-3-2b --steps 200 [--reduced] [--microbatches N]
[--compress-grads] [--device cpu]`` (mirrors
``src/repro/launch/train.py``).

Runs on the card unless ``--device cpu``; ``--reduced`` takes the
smoke-scale config.  One process gives a one-rank mesh (``data`` x
``model`` = 1 x 1); under a multi-process launcher that has started the
process group, the local mesh spans every rank, and
``--production-mesh`` asks for the 16 x 16 one (256 ranks).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 mesh (requires 256 ranks)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    started = not dist.is_initialized()     # the group this call starts
    cfg = get_config(args.arch, reduced=args.reduced)
    shape = ShapeConfig("cli", args.seq_len, args.global_batch, "train")
    mesh = (make_production_mesh(multi_pod=args.multi_pod,
                                 device=args.device)
            if args.production_mesh else make_local_mesh(device=args.device))
    ocfg = OptConfig(peak_lr=args.lr, warmup_steps=min(20, args.steps // 5),
                     decay_steps=args.steps)
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         log_every=10, microbatches=args.microbatches,
                         compress_grads=args.compress_grads)
    tr = Trainer(cfg, shape, mesh, ocfg, tcfg)
    kind, step = tr.init_or_resume()
    print(f"{kind} at step {step}; devices={dist.get_world_size()} "
          f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    tr.train(args.steps - step)
    tr.save()
    print(f"done at step {tr.step}; checkpoints in {args.ckpt_dir}")
    if started:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
