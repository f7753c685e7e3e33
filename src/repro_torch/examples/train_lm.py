"""End to end: train a ~100M-parameter LM for a few hundred steps
with checkpointing, a mid-run restart, and PTT-based straggler detection
(twin of ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm    # 300 steps
    PYTHONPATH=src python -m repro_torch.examples.train_lm --small

The model is the full xlstm-125m architecture config.  Halfway through,
the run checkpoints and a NEW Trainer restores from disk and continues —
proving restart-exactness on the real loop.  A synthetic straggler appears
on pod 1 at step 60%; the supervisor's rescale events are printed at the
end.  On the card unless ``--device cpu``; ``--ckpt-dir`` picks the
checkpoint directory (a fresh temporary one by default).
"""
from __future__ import annotations

import argparse
import tempfile

from ..configs import get_config
from ..data import DataConfig
from ..optim import AdamWConfig
from ..serve.engine import resolve_device
from ..train.trainer import Trainer, TrainerConfig


def setup(small: bool, steps: int | None):
    """(cfg, steps, seq, batch) as the original sets them."""
    cfg = get_config("xlstm-125m")
    if small:
        cfg = cfg.reduced()
    steps = steps or (40 if small else 300)
    seq, batch = (64, 2) if small else (256, 4)
    return cfg, steps, seq, batch


def make_trainer(cfg, steps: int, total: int, seq: int, batch: int,
                 ckpt_dir: str, device, checkpoint_every: int) -> Trainer:
    """A ``Trainer`` of the run's optimizer, data and straggler schedule,
    to ``total`` steps."""
    opt_cfg = AdamWConfig(lr=6e-4, warmup_steps=steps // 10,
                          total_steps=steps)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    straggle_from = int(steps * 0.6)

    def pod_time(step, pod):
        return 2.5 if (pod == 1 and step >= straggle_from) else 1.0

    return Trainer(cfg, opt_cfg, data_cfg,
                   TrainerConfig(total_steps=total,
                                 checkpoint_every=checkpoint_every,
                                 log_every=max(steps // 10, 1)),
                   ckpt_dir, pod_time_fn=pod_time, device=device)


def main(argv=None) -> dict:
    """Returns both phases' histories, the step the second resumed at and
    the supervisor's events."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg, steps, seq, batch = setup(args.small, args.steps)
    print(f"training {cfg.name}: {cfg.n_params/1e6:.0f}M params, "
          f"{steps} steps, seq {seq}, batch {batch}")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_trainlm_")

    # phase 1: train to the halfway checkpoint, then "crash"
    half = steps // 2
    t1 = make_trainer(cfg, steps, half, seq, batch, ckpt_dir, device,
                      max(half // 2, 1))
    first = t1.run()
    t1.close()
    print(f"-- simulated crash after step {t1.step}; restarting from "
          f"{ckpt_dir}")

    # phase 2: a fresh trainer restores and finishes
    t2 = make_trainer(cfg, steps, steps, seq, batch, ckpt_dir, device,
                      max(steps // 4, 1))
    assert t2.try_restore(), "restore failed"
    resumed_at = t2.step
    print(f"-- resumed at step {t2.step} (data stream skipped ahead exactly)")
    hist = t2.run()
    t2.close()

    print(f"\nfinal loss: {hist[-1]['loss']:.4f} "
          f"(first: {hist[0]['loss']:.4f})")
    print("supervisor events:")
    for e in t2.supervisor.events:
        print(f"  step {e.step}: {e.kind} — {e.detail}")
    return {"cfg": cfg, "steps": steps, "seq": seq, "batch": batch,
            "first": first, "resumed": hist, "resumed_at": resumed_at,
            "events": [(e.step, e.kind, e.detail)
                       for e in t2.supervisor.events],
            "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
