"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--steps N] [--device cuda|cpu]`` (the port of ``repro.launch.train``).

The smoke-config model by default (``--full`` for the full config),
synthetic data, on the card unless ``--device`` says otherwise. Fault
tolerance is on: checkpoint/restart, the straggler monitor, deterministic
data skipping (``train/trainer.py``). The LM archs train through
``models.lm.make_train_step`` (its step updates in place), the four GNN
archs (EGNN, NequIP, DimeNet with its triplets, Equiformer-v2) through the
GNN driver's full-graph step, and xDeepFM through
``models.recsys.xdeepfm.make_train_step`` on ``SyntheticRecsysStream``
(``--batch`` rows a step; AdamW with 10 warm-up steps, cosine to
``--steps``).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from repro_torch.common.params import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig
from repro_torch.data.pipeline import SyntheticLMStream, SyntheticRecsysStream
from repro_torch.train.optimizer import AdamWConfig, init_adamw
from repro_torch.train.trainer import Trainer, TrainerConfig


def build(args, device: torch.device):
    """(step, stream, params, opt_state, to_device) for ``args.arch``."""
    cfg = get_config(args.arch) if args.full else smoke_config(args.arch)

    def to_device(b):
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    if isinstance(cfg, LMConfig):
        from repro_torch.models import lm
        params = lm.init_lm(cfg, 0, device=device)
        step = lm.make_train_step(
            cfg, None, lm.ExecOpts(q_block=0, remat=False),
            AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps))
        stream = SyntheticLMStream(cfg.vocab_size, args.batch, args.seq)
    elif isinstance(cfg, RecsysConfig):
        from repro_torch.models.recsys import xdeepfm
        params = xdeepfm.init(cfg, 0, device=device)
        step = xdeepfm.make_train_step(cfg, AdamWConfig(
            lr=args.lr, warmup_steps=10, total_steps=args.steps))
        stream = SyntheticRecsysStream(cfg.n_sparse, cfg.vocab_per_field,
                                       args.batch)
    elif isinstance(cfg, GNNConfig):
        from repro_torch.models.gnn import driver as gd
        from repro_torch.models.gnn.dimenet import build_triplets
        g = gd.make_flat_graph(128, 512, 16, seed=0, device=device)
        trip = (build_triplets(g.edge_src.cpu().numpy(),
                               g.edge_dst.cpu().numpy(),
                               g.edge_mask.cpu().numpy(), device=device)
                if cfg.model == "dimenet" else None)
        params = gd.init_model(cfg, 0, 16, device=device)
        step = gd.make_train_step(cfg, "full_graph",
                                  opt_cfg=AdamWConfig(lr=args.lr))

        class _GraphStream:
            def batch_at(self, step):
                return {"graph": g, "triplets": trip}
        stream = _GraphStream()
        to_device = None
    else:
        raise SystemExit(f"no trainer for {args.arch}")
    return step, stream, params, init_adamw(params), to_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--full", action="store_true",
                    help="use the full (assigned) config instead of smoke")
    args = ap.parse_args(argv)

    device = resolve_device(args.device, "repro_torch.launch.train")
    step, stream, params, opt, to_dev = build(args, device)
    tc = TrainerConfig(total_steps=args.steps,
                       checkpoint_every=max(args.steps // 2, 1),
                       checkpoint_dir=args.ckpt_dir,
                       log_every=max(args.steps // 10, 1))
    trainer = Trainer(tc, step, stream, params, opt, to_dev)
    if trainer.try_restore():
        print(f"restored from step {trainer.step}")
    out = trainer.run()
    for h in out["history"]:
        print(json.dumps(h))
    if not out["history"]:
        print(f"restored at step {trainer.step} of {args.steps}: no step "
              "left to run")
        return None
    loss = out["history"][-1]["loss"]
    print(f"final loss: {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
