"""End-to-end training example of the PyTorch/CUDA port, the twin of
``examples/train_tiny_lm.py``: its granite-family model (11.0M params)
for a few hundred steps through ``Trainer`` on
``launch.mesh.make_local_mesh``, with checkpointing and exact resume (a
second run over the same ``--ckpt-dir`` continues from its last
checkpoint, bit for bit).

Run:  PYTHONPATH=src python examples/train_tiny_lm_torch.py [--steps 300]
      [--device cpu]
"""
import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import flatten


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_tiny_lm"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # granite family widened a bit beyond the smoke config (11.0M params)
    cfg = get_config("granite-3-2b", reduced=True).replace(
        n_layers=6, d_model=384, n_heads=6, n_kv_heads=2, head_dim=64,
        d_ff=1024, vocab_size=4096)
    shape = ShapeConfig("tiny", seq_len=128, global_batch=8, kind="train")
    started = not dist.is_initialized()     # the group this run starts
    mesh = make_local_mesh(device=args.device)
    tr = Trainer(
        cfg, shape, mesh,
        OptConfig(peak_lr=3e-4, warmup_steps=30, decay_steps=args.steps),
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=20),
    )
    kind, step = tr.init_or_resume()
    n_params = sum(t.numel() for _, t in flatten(tr.state["params"]))
    print(f"{kind} at step {step}; params={n_params / 1e6:.1f}M")
    tr.train(args.steps - step)
    tr.save()
    print(f"final checkpoint at step {tr.step} in {args.ckpt_dir}")
    if started:
        dist.destroy_process_group()
    return tr


if __name__ == "__main__":
    main()
