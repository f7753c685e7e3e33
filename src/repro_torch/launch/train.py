"""The training command line (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        --steps 50 --batch 8 --seq 128 --device cpu

The same options as the reference, plus ``--device`` (default ``cuda``).
It trains the reduced variant of ``--arch`` (``--full-config`` for the full
one) end-to-end with checkpointing and the straggler monitor, and
demonstrates restart-after-kill (``--resume``).  On the card the dense,
MoE, hybrid and SSM families train through their kernels' forward and
backward (flash attention at head dims 32, 64, 80 and 128, the SSD and
sLSTM scans).  A reduced model has heads of 32; ``--full-config`` trains
the full-width one in float32 (stablelm-3b's heads of 80 among them) as
far as the card's memory allows.  ``chip_smoke.py`` trains full-width
stablelm-3b, qwen2.5-14b at 4 of its 48 layers and musicgen-large in
bfloat16 with a float32 master copy:

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
        --full-config --steps 20 --batch 1 --seq 1024
"""
from __future__ import annotations

import argparse
import tempfile

from ..configs import ARCHS
from ..data import DataConfig
from ..optim import AdamWConfig
from ..train.trainer import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (not reduced) architecture config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = ARCHS[args.arch]
    if not args.full_config:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    tcfg = TrainerConfig(total_steps=args.steps)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")

    trainer = Trainer(cfg, opt_cfg, data_cfg, tcfg, ckpt_dir,
                      device=args.device)
    if args.resume and trainer.try_restore():
        print(f"[train] resumed from step {trainer.step}")
    hist = trainer.run()
    trainer.close()
    print(f"[train] done: {len(hist)} steps, "
          f"final loss {hist[-1]['loss']:.4f}, checkpoints in {ckpt_dir}")


if __name__ == "__main__":
    main()
