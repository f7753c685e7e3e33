"""The torch backend of the placement score: the port's counterpart of
``repro/core/placement_jax.py``, selected with
``make_scheduler(..., placement_backend="torch")``.

Every PTT search accepts a ``score_fn`` hook that computes the queue-aware
score vector ``ptt + queue_penalty * load`` over the candidate places (see
``PTT._best_from_indices``); the argmin/tie-break tail stays host-side so
the RNG draw sequence is backend-independent.  This hook computes the
score on a torch device, the card by default.

As the JAX backend's:

* With ``queue_penalty == 0`` the search passes no load and the hook
  returns the PTT column unchanged, so this backend is bit-identical to
  numpy (the goldens are pinned on numpy).
* With a penalty the score is computed in float32, as the JAX backend does
  without x64, and the device may fuse the multiply-add; scores can differ
  from numpy's float64 in the last float32 ulp and break ties otherwise.
* No fallback: without the device the hook is built for, building it
  raises, so a sweep never mixes backends.  Nothing is compiled (no
  ``torch.compile``): one eager multiply-add a call.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def make_score_fn(device=None) -> Callable[
        [np.ndarray, Optional[np.ndarray], float], np.ndarray]:
    """The score hook ``(vals, load, penalty) -> vals + penalty * load`` on
    ``device`` (default: the card), as a float32 numpy array; ``load=None``
    returns ``vals`` itself.  Raises ``RuntimeError`` when the device is a
    card and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "placement_backend='torch' computes the score on the card and "
            "torch.cuda.is_available() is false; use the default "
            "placement_backend='numpy'")

    def score_fn(vals: np.ndarray, load: Optional[np.ndarray],
                 penalty: float) -> np.ndarray:
        if load is None:
            # no queue penalty -> the score IS the PTT column; returning
            # it unchanged is exact (and keeps this backend bit-identical
            # to numpy whenever queue-aware placement is off)
            return vals
        v = torch.as_tensor(vals, dtype=torch.float32).to(device)
        ld = torch.as_tensor(load, dtype=torch.float32).to(device)
        return torch.add(v, ld, alpha=float(np.float32(penalty))).cpu().numpy()

    return score_fn
