"""Decoder LM over every layer plan of the reference (port of
``repro/models/transformer.py``).

Families:
  dense / vlm / audio — pre-norm GQA attention + FFN; vlm and audio take
      precomputed ``frontend`` embeddings [B, P, d] as a prefix (below);
  moe — attention + top-k capacity-routed MoE FFN (+ optional shared
      expert, ``moe.py``); ``forward`` returns the summed aux loss;
  hybrid (zamba2) — Mamba-2 backbone; ONE weight-shared attention+FFN block
      applied every ``shared_attn_every`` layers, each application with its
      own KV cache;
  ssm (xlstm) — mLSTM blocks with an sLSTM every ``slstm_every``.

Params mirror the reference's tree: ``embed``, ``final_norm``, ``lm_head``,
one stacked tree per block kind under ``stacks`` (leading layer axis, in
plan order) and, for the hybrid, the unstacked ``shared_attn``.  The
reference scans over each stack with ``jax.lax.scan``; here a Python loop
walks the plan and indexes the stacks.  Logits come back in float32.

Training: ``forward(..., remat=True)`` recomputes each stacked layer in
the backward (``torch.utils.checkpoint``, the counterpart of the
reference's ``jax.checkpoint`` of its scan body; the hybrid's shared block
is not rematerialised there either), and :func:`loss_and_metrics` is the
reference's loss.

The ``frontend`` prefix (``forward``, ``prefill`` and ``loss_and_metrics``
through ``batch["frontend"]``), as the reference's: its embeddings, cast to
the model's dtype, go before the token embeddings, the positions run over
the whole ``P + S``, and the LM head runs over the text positions only
(sliced after the final norm).  Any layer plan takes one.

A padded prefill (``prefill(..., length=PadLength)``: the serving engine's
captured graph of a length bucket, ``serve/prefill_graph.py``) runs the
bucket's S positions and computes the reference's prefill of the first
``length`` of them: positions from the real length on are no input.  The
logits are the last real token's, the caches' ``length`` the real one and
their rows from it on zero; causal attention needs nothing more; the MoE
routes the tokens as the real length's groups do (``moe.route_padded``),
Mamba-2 and mLSTM give a pad decay 0 and input 0 (their state passes the
pads unchanged; Mamba-2's conv tail is gathered at the real end), and the
sLSTM scan stops each row's carry at its length.  Every number derived
from the length is computed on the host (:func:`fill_pad_length`) and written
into the :class:`PadLength` tensors, and nothing in the path synchronises
with the host.

The decode state mirrors the reference's too: one stacked tree per state
kind (``kv``, ``shared_kv``, ``mamba``, ``mlstm``, ``slstm``).  In place,
unlike the reference: ``prefill`` writes each block's state into a state
preallocated for ``max_len``, and ``decode_step`` writes each block's new
state (the K/V row and ``length`` of a cache, the recurrent state of an
SSM block) into the ``state`` it is given and returns that same object.

On a device mesh (params and batch as DTensors under
``parallel.sharding_ctx``, as the dry-run runs a step) the same functions
run the step on every device's shards: FSDP's leaves are gathered over
the data axes (``gather_data``), the layouts the reference pins are pinned
with ``constrain``, the vocab-sharded lookup, the experts and the kernels
run on their shards by their sharding rules, and a prefill's state is
made at ``decode_state_specs``.  On plain tensors nothing of that runs.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Iterator, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..parallel.sharding import (constrain, decode_state_specs,
                                 gather_data, is_distributed, keep_layout,
                                 model_coordinate, on_shards, placements,
                                 zeros_distributed)
from ..parallel.sharding import pad as zero_pad
from .attention import (attention_block, attention_decode, init_attention,
                        init_kv_cache)
from .layers import ffn, init_ffn, init_linear, rms_norm
from .mamba2 import (init_mamba2, init_mamba2_state, mamba2_block,
                     mamba2_decode)
from .moe import init_moe, moe_block, real_routing
from .xlstm import (init_mlstm, init_mlstm_state, init_slstm,
                    init_slstm_state, mlstm_block, mlstm_decode, slstm_block,
                    slstm_decode)

Params = dict
PyTree = Any

_ATTN = ("attn", "attn_moe", "shared_attn")
_STATE_KEY = {"attn": "kv", "attn_moe": "kv", "shared_attn": "shared_kv",
              "mamba2": "mamba", "mlstm": "mlstm", "slstm": "slstm"}


class PadLength(NamedTuple):
    """A padded prefill's real length and what derives from it, on the
    device: ``length`` [B] int32, and for an MoE model ``moe_group`` and
    ``moe_capacity`` (int64 scalars: tokens a routing group at the real
    length, an expert's slots in one; ``moe.real_routing``), else None."""
    length: torch.Tensor
    moe_group: Optional[torch.Tensor] = None
    moe_capacity: Optional[torch.Tensor] = None


def pad_length(cfg: ModelConfig, n: int, device=None) -> PadLength:
    """A new :class:`PadLength` of batch 1 on ``device`` holding a real
    length ``n``."""
    device = resolve_device(device)
    moe = {k: torch.zeros((), dtype=torch.int64, device=device)
           for k in ("moe_group", "moe_capacity") if cfg.family == "moe"}
    pad = PadLength(torch.zeros(1, dtype=torch.int32, device=device), **moe)
    fill_pad_length(pad, cfg, n)
    return pad


def fill_pad_length(pad: PadLength, cfg: ModelConfig, n: int) -> None:
    """Write the numbers of a real length ``n`` (batch 1), computed on the
    host by the functions the unpadded path uses, into ``pad``'s tensors (a
    fill a tensor: no wait on the device)."""
    pad.length.fill_(n)
    if cfg.family == "moe":
        group, capacity = real_routing(n, cfg.top_k, cfg.n_experts,
                                       cfg.capacity_factor)
        pad.moe_group.fill_(group)
        pad.moe_capacity.fill_(capacity)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer_plan(cfg: ModelConfig) -> list[str]:
    """Block type per layer index (as the reference's ``layer_plan``)."""
    if cfg.family in ("dense", "vlm", "audio"):
        return ["attn"] * cfg.n_layers
    if cfg.family == "moe":
        return ["attn_moe"] * cfg.n_layers
    if cfg.family == "hybrid":
        plan = []
        for i in range(cfg.n_layers):
            plan.append("mamba2")
            if cfg.shared_attn_every and (i + 1) % cfg.shared_attn_every == 0:
                plan.append("shared_attn")
        return plan
    if cfg.family == "ssm":
        k = cfg.slstm_every
        return ["slstm" if (k and i % k == k - 1) else "mlstm"
                for i in range(cfg.n_layers)]
    raise ValueError(f"unknown family {cfg.family}")


def _layer(tree: PyTree, i: int) -> PyTree:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree: PyTree) -> PyTree:
    """Each leaf of a stacked tree as its tuple of per-layer views, by one
    ``unbind`` a leaf: its gradient is then one stack of the layers'
    gradients, where a view per layer would add a zero-filled stack of
    every leaf for each layer."""
    if isinstance(tree, dict):
        return {k: _unstack(v) for k, v in tree.items()}
    return tree.unbind(0)


def _walk(params: Params, cfg: ModelConfig) -> Iterator[tuple[str, Params,
                                                               int]]:
    """(kind, block params, index into the kind's state stack) for each
    block of the plan, in order.  A stacked kind's i-th block is layer i of
    its stack; the shared block's i-th application has the i-th cache.
    (``attn`` and ``attn_moe`` both keep ``kv``; no plan has both.)"""
    seen: Counter = Counter()
    stacks = {kind: _unstack(stack)
              for kind, stack in params["stacks"].items()}
    for kind in layer_plan(cfg):
        i = seen[kind]
        seen[kind] += 1
        p = (params["shared_attn"] if kind == "shared_attn"
             else _layer(stacks[kind], i))
        yield kind, p, i


def _head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, kind: str, stack: tuple[int, ...],
                **kw) -> Params:
    d, dt, device = cfg.d_model, kw["dtype"], kw["device"]
    ln = lambda: torch.ones(stack + (d,), dtype=dt, device=device)
    if kind in _ATTN:
        p = {
            "ln1": ln(),
            "attn": init_attention(d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, cfg.qkv_bias,
                                   stack=stack, **kw),
            "ln2": ln(),
        }
        if kind == "attn_moe":
            p["moe"] = init_moe(d, cfg.n_experts, cfg.d_ff,
                                cfg.moe_shared_ff, stack=stack, **kw)
        else:
            p["ffn"] = init_ffn(d, cfg.d_ff, cfg.act, stack=stack, **kw)
        return p
    if kind == "mamba2":
        return {"ln1": ln(),
                "mamba": init_mamba2(d, cfg.n_heads, cfg.mamba_head_dim,
                                     cfg.ssm_state, stack=stack, **kw)}
    if kind == "mlstm":
        return {"ln1": ln(),
                "mlstm": init_mlstm(d, cfg.n_heads, cfg.mlstm_proj_factor,
                                    stack=stack, **kw)}
    if kind == "slstm":
        return {"ln1": ln(),
                "slstm": init_slstm(d, cfg.n_heads, stack=stack, **kw)}
    raise ValueError(kind)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random weights with the reference's init scales, drawn on ``device``
    from a seeded ``torch.Generator`` (none on the meta device, where the
    tree has shapes only).  ``None`` is the card, and raises without one
    (``device.resolve_device``): pass ``device="cpu"`` for the CPU."""
    plan = layer_plan(cfg)
    device = resolve_device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    kw = dict(gen=gen, device=device, dtype=_dtype(cfg))
    params: Params = {
        "embed": init_linear((cfg.vocab, cfg.d_model), scale=0.02, **kw),
        "final_norm": torch.ones((cfg.d_model,), dtype=kw["dtype"],
                                 device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear((cfg.d_model, cfg.vocab), **kw)
    counts = Counter(kind for kind in plan if kind != "shared_attn")
    params["stacks"] = {kind: _init_block(cfg, kind, (n,), **kw)
                        for kind, n in counts.items()}
    if "shared_attn" in plan:
        params["shared_attn"] = _init_block(cfg, "shared_attn", (), **kw)
    return params


# ---------------------------------------------------------------------------
# forward / prefill
# ---------------------------------------------------------------------------

def _whole(h: torch.Tensor) -> torch.Tensor:
    """A block's (or the head's) normed input, on a mesh whole over the
    model axis before the projections sharded over it: with
    ``cfg.seq_parallel`` (which the dry-run sets with FSDP) Megatron
    sequence parallelism's gather of the sequence-sharded stream, as the
    reference pins it (else its partitioner gathers the weights); in any
    case the boundary at which the partial sums of its gradient from those
    projections are reduced (Megatron's all-reduce of the input gradient),
    where DTensor would carry them on into the products before it."""
    return constrain(h, ("dp", None, None))


def _mlp(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
         with_aux: bool = False, sp: bool = False,
         pad: Optional[PadLength] = None):
    """The second half of an attention block: (x_out, the MoE aux loss with
    ``with_aux``, else None, and None for a dense FFN).  ``sp``: the
    forward's, whose residual stream is sequence-sharded on a mesh under
    ``cfg.seq_parallel``; ``pad``: a padded prefill's."""
    h = _whole(rms_norm(x, p["ln2"], cfg.rms_eps))
    if kind == "attn_moe":
        y, aux = moe_block(p["moe"], h, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           with_aux=with_aux, pad=pad)
        return x + _branch(y, cfg, sp), aux
    return x + _branch(ffn(p["ffn"], h, cfg.act), cfg, sp), None


def _branch(y: torch.Tensor, cfg: ModelConfig, sp: bool) -> torch.Tensor:
    """A block's output before it joins the residual stream.  On a mesh,
    Megatron's tensor parallelism: the row-parallel product's partial sum
    over the model axis is all-reduced, so that the stream and every
    block's input stay whole over it, or, in the forward with
    ``cfg.seq_parallel``, reduce-scattered onto the sequence-sharded stream
    (the reference's partitioner makes that choice; DTensor would carry the
    partial sum on and run the next products on gathered weights)."""
    if sp and cfg.seq_parallel:
        return constrain(y, ("dp", "model", None))
    return constrain(y, ("dp",) + (None,) * (y.ndim - 1))


def _block(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
           positions: torch.Tensor, with_state: bool,
           pad: Optional[PadLength] = None):
    """One block over the whole sequence: (x_out, its decode state — (k, v)
    for attention — or None without ``with_state``, its MoE aux loss
    without ``with_state`` (a prefill drops it) or None).  ``pad``: a
    padded prefill's real length (``with_state`` only)."""
    h = _whole(rms_norm(x, p["ln1"], cfg.rms_eps))
    length = None if pad is None else pad.length
    if kind in _ATTN:
        y, kv = attention_block(
            p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            positions=positions, return_kv=True)
        x, aux = _mlp(cfg, kind, p, x + _branch(y, cfg, not with_state),
                      with_aux=not with_state, sp=not with_state, pad=pad)
        return x, kv, aux
    if kind == "mamba2":
        out = mamba2_block(p["mamba"], h, n_heads=cfg.n_heads,
                           head_dim=cfg.mamba_head_dim,
                           ssm_state=cfg.ssm_state, return_state=with_state,
                           length=length)
    elif kind == "mlstm":
        out = mlstm_block(p["mlstm"], h, n_heads=cfg.n_heads,
                          return_state=with_state, length=length)
    elif kind == "slstm":
        out = slstm_block(p["slstm"], h, n_heads=cfg.n_heads,
                          return_state=with_state, length=length)
    else:
        raise ValueError(kind)
    y, st = out if with_state else (out, None)
    return x + _branch(y, cfg, not with_state), st, None


def _block_fwd(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
               positions: torch.Tensor):
    """One block of the forward: (x_out, its MoE aux loss or None).  With
    ``cfg.seq_parallel`` a stacked block's output, the residual stream
    (and what remat keeps of it), is pinned sequence-sharded over the model
    axis, as the reference's scan body pins it."""
    x, _, aux = _block(cfg, kind, p, x, positions, with_state=False)
    if cfg.seq_parallel and kind != "shared_attn":
        x = constrain(x, ("dp", "model", None))
    return x, aux


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On a mesh of more than one device the lookup
    runs on the shards, as the reference's vocab-sharded embedding: each
    shard of the vocabulary gives the rows of the tokens it holds and zeros
    for the others, partial sums all-reduced over the model axis (the
    gradient lands on the local rows, a partial sum over the data axes)."""
    if not is_distributed(table) or table.device_mesh.size() == 1:
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    if not is_distributed(tokens):
        tokens = DTensor.from_local(tokens, mesh, tuple(
            Replicate() for _ in names), run_check=False)
    vocab = [n for n, p in zip(names, table.placements) if p.is_shard(0)]
    tp = placements(mesh, dict.fromkeys(vocab, 0))
    tok = tuple(p if p.is_shard(0) else Replicate()
                for p in tokens.placements)
    batch = [n for n, p in zip(names, tok) if p.is_shard()]
    out = tuple(Partial() if n in vocab else p for n, p in zip(names, tok))
    grad = tuple(Partial() if n in batch else p for n, p in zip(names, tp))
    coord = model_coordinate(mesh) if "model" in vocab else 0

    def local(t, ids):
        if not vocab:
            return t[ids]
        ids = ids.long() - coord * t.shape[0]
        mine = (ids >= 0) & (ids < t.shape[0])
        return t[ids.clamp(0, t.shape[0] - 1)] * mine[..., None].to(t.dtype)

    x = on_shards(local, mesh, (table, tokens), (tp, tok), out, (grad, tok))
    return x.redistribute(mesh, tok)    # the partial sums reduced


def _embed(params: Params, tokens: torch.Tensor,
           frontend: torch.Tensor | None) -> tuple[torch.Tensor, int]:
    """The token embeddings after the ``frontend`` prefix, if any, cast to
    their dtype: (x [B, P + S, d], P)."""
    x = _lookup(params["embed"], tokens)
    if frontend is None:
        return x, 0
    return torch.cat([frontend.to(x.dtype), x], dim=1), frontend.shape[1]


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend: torch.Tensor | None = None,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S] -> (logits [B, S, V] float32, the summed MoE aux
    loss, float32; 0 without MoE blocks).  ``frontend`` [B, P, d] embeddings
    are prepended; logits come back for the text positions only.  With
    ``remat`` each stacked layer keeps only its input for the backward and
    runs again there."""
    params = gather_data(params)
    x, prefix = _embed(params, tokens, frontend)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux_total = torch.zeros((), device=x.device)
    for kind, p, _ in _walk(params, cfg):
        if remat and kind != "shared_attn":
            # no block draws a random number, so there is no RNG state to
            # stash; reading the CUDA generator's is refused in a graph
            # capture (``train/step_graph.py``)
            x, aux = checkpoint(_block_fwd, cfg, kind, p, x, positions,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _block_fwd(cfg, kind, p, x, positions)
        if aux is not None:
            aux_total = aux_total + aux
    x = _whole(rms_norm(x, params["final_norm"], cfg.rms_eps))[:, prefix:]
    logits = (x @ _head(params, cfg)).float()
    return logits, aux_total


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int, frontend: torch.Tensor | None = None,
            length: Optional[PadLength] = None
            ) -> tuple[torch.Tensor, PyTree]:
    """Process the full prompt, after the ``frontend`` prefix if any; return
    (last-token logits [B,V] float32, decode state sized for ``max_len``,
    holding the prefix's and the prompt's ``P + S`` positions) — the
    serving engine's prefill.  With ``length`` the prompt is padded past
    its real length (no prefix; plain tensors): the result is the prefill
    of the real prompt (module docstring), with no wait on the device."""
    if length is not None and (frontend is not None or is_distributed(
            tokens, params["embed"])):
        raise ValueError("prefill: a padded prompt takes no frontend prefix "
                         "and no DTensor")
    params = gather_data(params)
    x, _ = _embed(params, tokens, frontend)
    bsz, s_total = x.shape[0], x.shape[1]
    if max_len < s_total:
        raise ValueError(f"max_len {max_len} < prompt {s_total}")
    positions = torch.arange(s_total, device=x.device)[None, :]
    state = _new_state(cfg, bsz, max_len, x)
    live = None
    if length is not None:      # [B, S, 1, 1]: the real rows of a cache
        live = (positions < length.length[:, None])[..., None, None]
    for kind, p, i in _walk(params, cfg):
        x, st, _ = _block(cfg, kind, p, x, positions, with_state=True,
                          pad=length)
        slot = state[_STATE_KEY[kind]]
        if kind in _ATTN:
            for name, t in zip("kv", st):
                if live is not None:    # rows from the real length on: 0
                    t = torch.where(live, t, 0.0)
                _fill_cache(slot[name], i, t)
        else:
            for name, t in st.items():
                slot[name][i] = t
    for key in ("kv", "shared_kv"):
        if key in state:
            if length is None:
                state[key]["length"].fill_(s_total)
            else:
                state[key]["length"].copy_(length.length.expand_as(
                    state[key]["length"]))
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if length is None:
        last = x[:, -1]
    else:                       # the last real token's, by a device index
        at = (length.length.long() - 1)[:, None, None].expand(
            -1, 1, x.shape[-1])
        last = x.gather(1, at)[:, 0]
    logits = (last @ _head(params, cfg)).float()
    return logits, state


def _fill_cache(cache: torch.Tensor, i: int, t: torch.Tensor) -> None:
    """Layer ``i`` of a K/V cache ``[L, B, T, Hkv, D]`` takes the prompt's
    rows ``t [B, S, Hkv, D]`` at positions 0..S-1.  A DTensor cache
    sharded on its sequence takes them padded to T, moved to the layer's
    sharding and written into its local shard, a whole layer (the slots
    past S are zeros in a new cache): a slice of a sharded dim is no shard
    of it."""
    s = t.shape[1]
    if is_distributed(cache) and any(p.is_shard(2) for p in cache.placements):
        from torch.distributed.tensor import Shard
        layer = tuple(Shard(p.dim - 1) if p.is_shard() else p
                      for p in cache.placements)
        full = zero_pad(t, (0, 0, 0, 0, 0, cache.shape[2] - s))
        cache.to_local()[i] = full.redistribute(cache.device_mesh,
                                                layer).to_local()
    else:
        cache[i, :, :s] = t


def _new_state(cfg: ModelConfig, bsz: int, max_len: int,
               x: torch.Tensor) -> PyTree:
    """A prefill's decode state, on ``x``'s device; where ``x`` is a DTensor,
    at ``decode_state_specs`` on its mesh, each leaf made from its own
    shard (its shapes from a build of fake tensors)."""
    if not is_distributed(x):
        return init_decode_state(cfg, bsz, max_len, device=x.device)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        shapes = init_decode_state(cfg, bsz, max_len, device="meta")
    mesh = x.device_mesh
    return zeros_distributed(shapes, decode_state_specs(shapes, mesh), mesh,
                             x.to_local().device)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's -log softmax(logits)[label].  Logits sharded on their
    vocabulary (a mesh's vocab-sharded head) stay so, as the reference's
    pins keep them: each token's max and sum of exponentials reduced over
    the shards, its label's logit taken by the shard that holds it (a
    softmax op would gather the logits)."""
    v = logits.ndim - 1
    if not (is_distributed(logits) and any(p.is_shard(v)
                                           for p in logits.placements)):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    mesh = logits.device_mesh
    logits = keep_layout(logits)    # its gradient vocab-sharded too
    m = logits.detach().amax(v, keepdim=True)
    lse = (logits - m).exp().sum(v, keepdim=True).log() + m
    pl = tuple(p if not p.is_shard(v) else Replicate()
               for p in logits.placements)
    vocab = [i for i, p in enumerate(logits.placements) if p.is_shard(v)]
    names = mesh.mesh_dim_names

    def pick(lg, lab):
        start = 0       # the first vocabulary row of this shard
        for i in vocab:
            start = start * mesh.shape[i] + mesh.get_local_rank(i)
        idx = lab.long() - start * lg.shape[-1]
        mine = (idx >= 0) & (idx < lg.shape[-1])
        got = lg.gather(-1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(mine, got[..., 0], 0.0)

    lab = tuple(p if p.is_shard(0) else Replicate()
                for p in labels.placements) if is_distributed(labels) else pl
    out = tuple(Partial() if i in vocab else p
                for i, p in enumerate(pl[:len(names)]))
    picked = on_shards(pick, mesh, (logits, labels),
                       (tuple(logits.placements), lab), out)
    return lse[..., 0] - picked.redistribute(mesh, pl)


def loss_and_metrics(params: Params, cfg: ModelConfig, batch: dict,
                     remat: bool = False) -> tuple[torch.Tensor, dict]:
    """Mean next-token NLL over ``loss_mask`` (all tokens without one) plus
    ``aux_loss_coef`` x the MoE aux loss: (total, {"loss", "aux_loss",
    "tokens"}), as the reference's."""
    logits, aux = forward(params, cfg, batch["tokens"], batch.get("frontend"),
                          remat=remat)
    nll = _nll(logits, batch["labels"])
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    total = loss + cfg.aux_loss_coef * aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": mask.sum()}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> PyTree:
    """Stacked per-kind decode state mirroring the layer plan: KV caches
    {"k", "v": [L,B,T,Hkv,D], "length": [L,B]} for ``kv`` (attention
    layers) and ``shared_kv`` (applications of the shared block), and the
    recurrent states ``mamba``, ``mlstm`` and ``slstm``."""
    n = Counter(_STATE_KEY[kind] for kind in layer_plan(cfg))
    dt, hd = _dtype(cfg), cfg.resolved_head_dim
    state: dict[str, PyTree] = {}
    for key in ("kv", "shared_kv"):
        if n[key]:
            state[key] = init_kv_cache(batch, max_len, cfg.n_kv_heads, hd,
                                       dt, device, stack=(n[key],))
    if n["mamba"]:
        state["mamba"] = init_mamba2_state(
            batch, cfg.n_heads, cfg.mamba_head_dim, cfg.ssm_state, dt, device,
            stack=(n["mamba"],))
    if n["mlstm"]:
        d_inner = int(cfg.d_model * cfg.mlstm_proj_factor)
        state["mlstm"] = init_mlstm_state(
            batch, cfg.n_heads, d_inner // cfg.n_heads, dt, device,
            stack=(n["mlstm"],))
    if n["slstm"]:
        state["slstm"] = init_slstm_state(batch, cfg.d_model, dt, device,
                                          stack=(n["slstm"],))
    return state


def _block_decode(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                  st: PyTree):
    """One block for one token: (x_out, the block's new recurrent state, or
    None for attention, whose cache ``st`` is updated in place)."""
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    if kind in _ATTN:
        y, _ = attention_decode(
            p["attn"], h, st, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta)
        return _mlp(cfg, kind, p, x + _branch(y, cfg, False))[0], None
    if kind == "mamba2":
        y, new = mamba2_decode(p["mamba"], h, st, n_heads=cfg.n_heads,
                               head_dim=cfg.mamba_head_dim,
                               ssm_state=cfg.ssm_state)
    elif kind == "mlstm":
        y, new = mlstm_decode(p["mlstm"], h, st, n_heads=cfg.n_heads)
    elif kind == "slstm":
        y, new = slstm_decode(p["slstm"], h, st, n_heads=cfg.n_heads)
    else:
        raise ValueError(kind)
    return x + _branch(y, cfg, False), new


def decode_step(params: Params, cfg: ModelConfig, state: PyTree,
                tokens: torch.Tensor) -> tuple[torch.Tensor, PyTree]:
    """One decode step.  tokens: [B] -> (logits [B, V] float32, state),
    with ``state`` updated in place."""
    params = gather_data(params)
    x = _lookup(params["embed"], tokens)[:, None, :]  # [B, 1, d]
    for kind, p, i in _walk(params, cfg):
        slot = state[_STATE_KEY[kind]]
        x, new = _block_decode(cfg, kind, p, x, _layer(slot, i))
        if new is not None:
            for name, t in new.items():
                slot[name][i] = t
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = (x[:, 0] @ _head(params, cfg)).float()
    return logits, state
