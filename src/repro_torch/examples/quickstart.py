"""Quickstart: the public API in ~40 lines (twin of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a reduced Qwen2.5-style model, trains a few steps on the synthetic
stream, then serves a short generation from the trained weights.  On the
card unless ``--device cpu``; ``main(params=...)`` starts from given
weights (the reference's, bridged, in the tests).  The step is a
``TrainStepGraph``, as the original's is ``jax.jit(make_train_step(...))``:
on the card a captured graph, on the CPU the plain step.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import get_config
from ..data import DataConfig, SyntheticStream
from ..models import decode_step, init_params
from ..models.transformer import prefill
from ..optim import AdamWConfig, init_opt_state
from ..serve.engine import resolve_device
from ..train.step_graph import TrainStepGraph

STEPS = 20


def main(argv=None, params=None) -> dict:
    """Returns the config, the optimizer's and the stream's, the losses of
    every step, the trained params, the prompt, the generated token ids and
    the logits each was taken from (the prefill's, then each decode
    step's)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("qwen2.5-14b").reduced()
    print(f"model: {cfg.name}  ({cfg.n_params/1e6:.1f}M params)")

    params = (init_params(cfg, 0, device) if params is None
              else _to(params, device))
    opt_state = init_opt_state(params)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)
    stream = SyntheticStream(data_cfg)
    train = TrainStepGraph(cfg, opt_cfg, params, opt_state,
                           {k: torch.as_tensor(v)
                            for k, v in stream.batch_at(0).items()})

    losses = []
    for i, batch in zip(range(STEPS), stream):
        metrics = train.step(batch)
        losses.append(float(metrics["loss"]))
        if (i + 1) % 5 == 0:
            print(f"step {i+1:3d}  loss {float(metrics['loss']):.4f}  "
                  f"lr {float(metrics['lr']):.2e}")
    train.close()

    # greedy generation from the trained weights
    prompt = torch.as_tensor(next(stream)["tokens"][:1, :16], device=device)
    with torch.no_grad():
        logits, state = prefill(params, cfg, prompt, max_len=32)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out, seen = [int(tok[0])], [logits]
        for _ in range(8):
            logits, state = decode_step(params, cfg, state, tok)
            tok = torch.argmax(logits, -1).to(torch.int32)
            out.append(int(tok[0]))
            seen.append(logits)
    print("generated token ids:", out)
    return {"cfg": cfg, "opt": opt_cfg, "data": data_cfg,
            "losses": losses, "params": params,
            "prompt": prompt, "generated": out, "logits": seen}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


if __name__ == "__main__":
    main()
