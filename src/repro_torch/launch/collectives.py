"""The collectives a step's shardings imply, per device and per step: the
port's counterpart of the collective half of ``repro/launch/hlo_analysis.py``.

The reference parses every collective out of its compiled, partitioned HLO.
The port's dry-run observes those its step on DTensors issues
(``launch/dryrun.py``); this module derives them beside that: from each
leaf's *sanitized* spec, as
``parallel/sharding.py`` assigns it (an axis that ``sanitize`` dropped
implies nothing), and from the activation layouts each block of the
``layer_plan`` passes.  Each entry is one collective with its mesh axis,
its source (a leaf path or a block) and its phase, run ``count`` times;
an axis of size 1 moves nothing and is left out.

The record is the reference's (``hlo_analysis.py:189-197``): per-device
*result* bytes by kind, an all-reduce weighted 2x (a ring moves about twice
its payload), and the call counts.  ``entries`` keeps the parts, summed
over layers.

The layouts (Megatron tensor parallelism over "model", activations
replicated over it between blocks; data parallelism over ``dp_axes``):

- **TP.** A row-sharded projection (``wo``, ``w_down``, ``w_out``) gives a
  partial sum: an all-reduce of its output in the forward, and again in
  the remat forward unless it is the block's last op (the remat forward
  stops at the last tensor the backward needs).  The column-sharded
  projections of one replicated input: one all-reduce of that input's
  gradient in the backward (their partial gradients summed first).  A
  column-sharded activation that a replicated or column-sharded weight
  reads (mLSTM's ``xi``) is all-gathered, and its gradient brought back
  to the shard.  An RMS
  norm over a sharded dim (``norm_z``, mLSTM's ``norm_h``) reduces each
  token's sum of squares (float32), forward and backward.  Heads that the
  model axis does not divide (GQA K/V of 2 heads on 4 ranks) leave their
  projection split inside a head: that projection is all-gathered, its
  gradient reduce-scattered.
- **Embedding and head.** The vocab-sharded lookup is an all-reduce of the
  embeddings; the vocab-sharded head's loss reduces each token's max, sum
  of exponentials and label logit (float32), its input gradient is an
  all-reduce; returned logits (prefill, decode) are all-gathered.
- **EP.** Expert stacks sharded over "model": each rank dispatches the
  capacity slots of its 1/m share of the tokens by an all-to-all and gets
  them back by a second (forward, remat forward, and their transposes in
  the backward); the combined outputs are all-gathered to the replicated
  residual.  Slots are the port's ``moe_block``'s (``moe.dispatch_plan``).
- **DP.** Each gradient (float32, the accumulation buffer) reduces over
  ``dp_axes`` once a step.  Under ZeRO-1 (``opt_moment_specs`` put "data"
  on a dim) that is a reduce-scatter over "data" (then an all-reduce over
  "pod" on the multi-pod mesh) and the updated param's all-gather; else
  one all-reduce.
- **FSDP** (a param spec with "data"): each layer's param is all-gathered
  over "data" in the forward and again in the remat forward, its gradient
  reduce-scattered in the backward (once a microbatch, in the param's
  dtype); the update leaves it sharded.
- **SP decode.** A KV cache sharded on T over "model": the query and the
  new K/V row are all-gathered, the softmax's per-(b, h) max and sum and
  the output are all-reduced.  A prefill fills such a cache by an
  all-to-all of K and V from head-sharded to T-sharded.
- **sLSTM.** Where ``r_gates`` is sharded, the recurrence runs on each
  device's shard of the units with no exchange, a token or a step (each
  unit reads its own column of r and its own carry; the kernels' sharding
  rule, which the dry-run's DTensor step observes: its calls do not grow
  with S); its output h is all-gathered once a layer for the up
  projections (forward, remat forward), its gradient reduce-scattered back
  in the backward.  mLSTM's ``xi`` meets a replicated ``w_if`` beside its
  column-sharded q, k, v: its gradient is all-reduced before it is cut to
  the shard.

Not counted: the scalar reductions of the loss and the MoE aux loss over
the batch (a few bytes), and Megatron sequence parallelism
(``seq_parallel``, which the models run under ``sharding_ctx`` since they
pin its layouts with ``constrain``): this count is the specs' alone.  The
dry-run records what its step on DTensors issues beside it
(``launch/dryrun.py``); this count is ``collectives_derived`` there.
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Any

from ..configs.base import ModelConfig
from ..models.moe import dispatch_plan
from ..models.transformer import layer_plan
from ..parallel.sharding import axis_sizes

F32 = 4


@dataclasses.dataclass
class Entry:
    """One collective: ``count`` calls of ``nbytes`` result bytes each on
    each device of its group, over ``axis``."""
    kind: str
    nbytes: int
    count: int
    axis: Any
    source: str
    phase: str

    def as_dict(self) -> dict:
        return {"kind": self.kind, "bytes_each": self.nbytes,
                "count": self.count,
                "axis": self.axis if isinstance(self.axis, str)
                else list(self.axis),
                "source": self.source, "phase": self.phase}


class Tally:
    """Entries keyed by (kind, axis, source, phase, bytes each)."""

    def __init__(self, sizes: dict):
        self.sizes = dict(sizes)
        self._e: dict = {}

    def group(self, axis) -> int:
        return math.prod(self.sizes.get(a, 1) for a in (
            (axis,) if isinstance(axis, str) else axis))

    def add(self, kind: str, nbytes: float, axis, source: str, phase: str,
            times: int = 1) -> None:
        nbytes = int(nbytes)
        if self.group(axis) <= 1 or nbytes <= 0 or times <= 0:
            return
        key = (kind, axis, source, phase, nbytes)
        self._e[key] = self._e.get(key, 0) + times

    def entries(self) -> list[Entry]:
        return [Entry(k, b, n, a, s, p)
                for (k, a, s, p, b), n in self._e.items()]

    def summary(self) -> dict:
        return summarize(self.entries())


def summarize(entries) -> dict:
    """The reference's record: ``{"bytes": {kind: per-device result bytes,
    all-reduce 2x, "total": ...}, "counts": {kind: calls}}`` and the
    entries."""
    nbytes: dict = {}
    counts: dict = {}
    for e in entries:
        w = 2 if e.kind == "all-reduce" else 1
        nbytes[e.kind] = nbytes.get(e.kind, 0) + w * e.nbytes * e.count
        counts[e.kind] = counts.get(e.kind, 0) + e.count
    nbytes["total"] = sum(nbytes.values())
    return {"bytes": nbytes, "counts": counts,
            "entries": [e.as_dict() for e in sorted(
                entries, key=lambda e: (e.phase, e.source, e.kind))]}


# -- specs --------------------------------------------------------------------

def _has(entry, axis: str) -> bool:
    return entry == axis or (isinstance(entry, tuple) and axis in entry)


def col(spec) -> bool:
    """A projection [.., in, out] whose output dim is sharded over model."""
    return spec is not None and _has(spec[-1], "model")


def row(spec) -> bool:
    """A projection [.., in, out] whose input dim is sharded over model."""
    return spec is not None and len(spec) >= 2 and _has(spec[-2], "model")


def sharded(spec, axis: str) -> bool:
    return spec is not None and any(_has(a, axis) for a in spec)


def local_numel(shape, spec, sizes: dict, without=()) -> int:
    """Elements of a leaf on one device under ``spec`` (the axes in
    ``without`` left unsplit)."""
    n = 1
    for dim, a in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        names = (a,) if isinstance(a, str) else (a or ())
        div = math.prod(sizes[x] for x in names if x not in without)
        n *= dim // div
    return n


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _get(tree, *keys):
    for k in keys:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


# -- building blocks (each also run as DTensors in the tests) --------------

def tp_pair(t: Tally, act_bytes: int, *, src: str, phases: "_Phases",
            last: bool = True) -> None:
    """A column-sharded projection into a row-sharded one, on a replicated
    activation of ``act_bytes`` a device: the row output's all-reduce and,
    in the backward, the input gradient's."""
    phases.fwd(t, "all-reduce", act_bytes, "model", src, last=last)
    phases.bwd(t, "all-reduce", act_bytes, "model", src)


def vocab_embedding(t: Tally, act_bytes: int, *, src: str,
                    phases: "_Phases") -> None:
    """The lookup in a table sharded on its vocab over model: a partial sum
    of the embeddings, all-reduced (its gradient lands on the local rows)."""
    phases.fwd(t, "all-reduce", act_bytes, "model", src, remat=False)


def grad_reduce(t: Tally, grad_bytes: int, param_bytes: int, *, zero: bool,
                src: str) -> None:
    """A gradient of ``grad_bytes`` (each device's, under the param's TP
    spec) reduced over the DP axes once a step.  Under ZeRO-1 a
    reduce-scatter over "data" (result: 1/|data|), an all-reduce of that
    over "pod", and the updated param's all-gather (``param_bytes``); else
    one all-reduce."""
    dp = _dp_axes(t.sizes)
    if not zero:
        t.add("all-reduce", grad_bytes, dp, src, "update")
        return
    shard = grad_bytes // t.group("data")
    t.add("reduce-scatter", shard, "data", src, "update")
    if "pod" in t.sizes:
        t.add("all-reduce", shard, "pod", src, "update")
    t.add("all-gather", param_bytes, "data", src, "update")


def fsdp_gather(t: Tally, layer_bytes: int, layers: int, *, src: str,
                phases: "_Phases") -> None:
    """An FSDP leaf's ``layers`` per-layer all-gathers over "data" (each
    ``layer_bytes``: the layer's TP shard), in the forward and the remat
    forward; the gradient's reduce-scatter in the backward."""
    phases.fwd(t, "all-gather", layer_bytes, "data", src, times=layers)
    phases.bwd(t, "reduce-scatter", layer_bytes // t.group("data"), "data",
               src, times=layers)


def expert_all_to_all(t: Tally, slot_bytes: int, *, src: str,
                      phases: "_Phases") -> None:
    """EP over model: the dispatch and the combine all-to-all of each
    device's ``slot_bytes`` of capacity slots, in the forward and the remat
    forward, and their transposes in the backward."""
    phases.fwd(t, "all-to-all", slot_bytes, "model", src, times=2)
    phases.bwd(t, "all-to-all", slot_bytes, "model", src, times=2)


def gathered(t: Tally, full_bytes: int, *, src: str, phases: "_Phases",
             times: int = 1, grad: str = "reduce-scatter") -> None:
    """A model-sharded activation that a consumer needs whole: its
    all-gather (result ``full_bytes``) in the forward.  In the backward its
    gradient goes back to the shard: from a partial sum (the consumers
    column-sharded) a reduce-scatter; from a partial sum that meets a
    replicated gradient (a replicated consumer beside them) an all-reduce
    first; from a model-sharded gradient (an elementwise consumer with a
    sharded weight) an all-gather first."""
    phases.fwd(t, "all-gather", full_bytes, "model", src, times=times)
    nbytes = (full_bytes // t.group("model") if grad == "reduce-scatter"
              else full_bytes)
    phases.bwd(t, grad, nbytes, "model", src, times=times)


class _Phases:
    """Where a block's collectives go: ``forward`` (``times`` x the
    microbatches), ``remat`` (the remat forward) and ``backward`` for a
    train step; ``forward`` only for a prefill or a decode step."""

    def __init__(self, train: bool, remat: bool, n_micro: int = 1):
        self.train, self.remat, self.n = train, remat, n_micro

    def fwd(self, t, kind, nbytes, axis, src, *, times=1, last=False,
            remat=True) -> None:
        t.add(kind, nbytes, axis, src, "forward", times * self.n)
        if self.train and self.remat and remat and not last:
            t.add(kind, nbytes, axis, src, "remat", times * self.n)

    def bwd(self, t, kind, nbytes, axis, src, *, times=1) -> None:
        if self.train:
            t.add(kind, nbytes, axis, src, "backward", times * self.n)


# -- the step ----------------------------------------------------------------

class _Step:
    def __init__(self, cfg, params, specs, sizes, kind, *, batch, seq,
                 n_micro, decode_specs=None):
        self.cfg, self.params, self.specs = cfg, params, specs
        self.sizes = sizes
        self.kind = kind
        self.t = Tally(sizes)
        self.it = {"float32": 4, "bfloat16": 2, "float16": 2}[cfg.dtype]
        self.m = sizes.get("model", 1)
        dp = math.prod(sizes[a] for a in _dp_axes(sizes))
        self.b = batch // dp if batch % dp == 0 else batch
        self.s = seq
        self.dspecs = decode_specs
        self.ph = _Phases(kind == "train", True, n_micro)
        self.ph_shared = _Phases(kind == "train", False, n_micro)

    def act(self, width: int) -> int:
        return self.b * self.s * width * self.it

    def spec(self, kind: str, *path):
        """The spec of a block's leaf (None where the block has none)."""
        base = (("shared_attn",) if kind == "shared_attn"
                else ("stacks", kind))
        return _get(self.specs, *base, *path)

    # -- blocks ----------------------------------------------------------
    def proj_group(self, kind, ph, names, src, down=None, last=True):
        """Column projections ``names`` of one replicated input, into a
        hidden that the row projection ``down`` reads (the rules shard both
        on the same dim, so both are sharded or neither is)."""
        col_in = any(col(self.spec(kind, *n)) for n in names)
        act = self.act(self.cfg.d_model)
        if down is None:
            if col_in:
                ph.bwd(self.t, "all-reduce", act, "model", src)
            return
        if col_in != row(self.spec(kind, *down)):
            raise ValueError(f"{src}: the in and out projections are not "
                             f"sharded alike")
        if col_in:
            tp_pair(self.t, act, src=src, phases=ph, last=last)

    def rms_sharded(self, ph, src):
        ph.fwd(self.t, "all-reduce", self.b * self.s * F32, "model", src)
        ph.bwd(self.t, "all-reduce", self.b * self.s * F32, "model", src)

    def attention(self, kind, ph, src):
        cfg, t = self.cfg, self.t
        hd = cfg.resolved_head_dim
        widths = {"wq": cfg.n_heads * hd, "wk": cfg.n_kv_heads * hd,
                  "wv": cfg.n_kv_heads * hd}
        heads = {"wq": cfg.n_heads, "wk": cfg.n_kv_heads,
                 "wv": cfg.n_kv_heads}
        split = {n: col(self.spec(kind, "attn", n))
                 and heads[n] % self.m != 0 for n in widths}
        decode = self.kind == "decode"
        kv_spec = (_get(self.dspecs, "shared_kv" if kind == "shared_attn"
                        else "kv", "k") if self.dspecs else None)
        sp = kv_spec is not None and _has(kv_spec[2], "model")
        for n, w in widths.items():
            if split[n] or (decode and sp and col(
                    self.spec(kind, "attn", n))):
                gathered(t, self.act(w), src=f"{src}.attn.{n}", phases=ph)
        if any(col(self.spec(kind, "attn", n)) for n in widths):
            ph.bwd(t, "all-reduce", self.act(cfg.d_model), "model",
                   f"{src}.attn.in")
        if self.kind == "prefill" and sp:
            for n in ("wk", "wv"):
                if not split[n] and col(self.spec(kind, "attn", n)):
                    ph.fwd(t, "all-to-all", self.act(widths[n]) // self.m,
                           "model", f"{src}.cache.{n[1]}")
        if decode and sp:       # softmax over a T-sharded cache
            rows = self.b * cfg.n_heads
            for what in ("max", "sum"):
                ph.fwd(t, "all-reduce", rows * F32, "model",
                       f"{src}.attn.softmax_{what}")
            ph.fwd(t, "all-reduce", self.act(widths["wq"]), "model",
                   f"{src}.attn.out")
        if row(self.spec(kind, "attn", "wo")):
            ph.fwd(t, "all-reduce", self.act(cfg.d_model), "model",
                   f"{src}.attn.wo", last=False)

    def block(self, kind: str, n: int):
        """``n`` applications of a block ``kind`` of the plan."""
        cfg, t = self.cfg, self.t
        ph = self.ph_shared if kind == "shared_attn" else self.ph
        src = "shared_attn" if kind == "shared_attn" else f"stacks.{kind}"
        d = cfg.d_model
        for _ in range(n):
            if kind in ("attn", "attn_moe", "shared_attn"):
                self.attention(kind, ph, src)
                if kind == "attn_moe":
                    self.moe(ph, src)
                else:
                    self.proj_group(kind, ph, [("ffn", "w_gate"),
                                               ("ffn", "w_up")],
                                    f"{src}.ffn", ("ffn", "w_down"))
            elif kind == "mamba2":
                if sharded(self.spec(kind, "mamba", "norm_z"), "model"):
                    self.rms_sharded(ph, f"{src}.mamba.norm_z")
                self.proj_group(kind, ph, [("mamba", "wx"), ("mamba", "wz"),
                                           ("mamba", "wdt")],
                                f"{src}.mamba", ("mamba", "w_out"))
            elif kind == "mlstm":
                d_inner = int(d * cfg.mlstm_proj_factor)
                p = lambda name: self.spec(kind, "mlstm", name)
                if col(p("w_x")):   # xi into the column-sharded q, k, v
                    # and the replicated w_if
                    gathered(t, self.act(d_inner), src=f"{src}.mlstm.xi",
                             phases=ph, grad="all-reduce")
                if sharded(p("norm_h"), "model"):
                    self.rms_sharded(ph, f"{src}.mlstm.norm_h")
                self.proj_group(kind, ph, [("mlstm", "w_x"),
                                           ("mlstm", "w_gate_proj")],
                                f"{src}.mlstm", ("mlstm", "w_down"))
            elif kind == "slstm":
                p = lambda name: self.spec(kind, "slstm", name)
                if col(p("r_gates")):   # h whole for the up projections
                    gathered(t, self.act(d), src=f"{src}.slstm.h",
                             phases=ph)
                self.proj_group(kind, ph, [("slstm", n) for n in
                                           ("w_i", "w_f", "w_z", "w_o")],
                                f"{src}.slstm")
                self.proj_group(kind, ph, [("slstm", "w_up_a"),
                                           ("slstm", "w_up_b")],
                                f"{src}.slstm.up", ("slstm", "w_down"))
            else:
                raise ValueError(kind)

    def moe(self, ph, src):
        cfg, t = self.cfg, self.t
        gate = self.spec("attn_moe", "moe", "experts_gate")
        if _has(gate[-3], "model"):     # [.., E, d, f]: EP over model
            dp = math.prod(self.sizes[a] for a in _dp_axes(self.sizes))
            groups, _, _, rows = dispatch_plan(
                self.b * dp * self.s, cfg.top_k, cfg.n_experts,
                cfg.capacity_factor)
            slot_bytes = groups * rows * cfg.d_model * self.it // (dp * self.m)
            expert_all_to_all(t, slot_bytes, src=f"{src}.moe.experts",
                              phases=ph)
            ph.fwd(t, "all-gather", self.act(cfg.d_model), "model",
                   f"{src}.moe.combined", last=True)
        if self.spec("attn_moe", "moe", "shared") is not None:
            self.proj_group("attn_moe", ph, [("moe", "shared", "w_gate"),
                                             ("moe", "shared", "w_up")],
                            f"{src}.moe.shared", ("moe", "shared", "w_down"))

    def embed_and_head(self):
        cfg, t, ph = self.cfg, self.t, self.ph
        s_text = self.s - (cfg.frontend_len if cfg.frontend != "none" else 0)
        act_text = self.b * s_text * cfg.d_model * self.it
        if _has(self.specs["embed"][0], "model"):
            vocab_embedding(t, act_text, src="embed", phases=ph)
        head_spec = (self.specs["lm_head"] if not cfg.tie_embeddings
                     else tuple(reversed(self.specs["embed"])))
        if not col(head_spec):
            return
        if self.kind == "train":
            for what in ("max", "sum_exp", "label"):
                ph.fwd(t, "all-reduce", self.b * s_text * F32, "model",
                       f"lm_head.loss_{what}", remat=False)
            ph.bwd(t, "all-reduce", act_text, "model", "lm_head")
        else:
            ph.fwd(t, "all-gather", self.b * cfg.vocab * F32, "model",
                   "lm_head.logits")

    def fsdp_and_dp(self, opt_specs):
        plan = layer_plan(self.cfg)
        n_shared = plan.count("shared_attn")
        for path, spec in _flat(self.specs):
            shape = tuple(_get(self.params, *path).shape)
            src = ".".join(path)
            tp_bytes = local_numel(shape, spec, self.sizes,
                                   without=("data",)) * self.it
            fsdp = sharded(spec, "data")
            if fsdp:
                layers = (shape[0] if path[0] == "stacks"
                          else n_shared if path[0] == "shared_attn" else 1)
                ph = self.ph_shared if path[0] != "stacks" else self.ph
                fsdp_gather(self.t, tp_bytes // (shape[0] if path[0] ==
                                                 "stacks" else 1),
                            layers, src=src, phases=ph)
            if self.kind != "train":
                continue
            grad = local_numel(shape, spec, self.sizes) * F32
            if fsdp:
                if "pod" in self.sizes:
                    self.t.add("all-reduce", grad, "pod", src, "update")
                continue
            mspec = _get(opt_specs, *path)
            grad_reduce(self.t, grad, tp_bytes,
                        zero=sharded(mspec, "data"), src=src)


def _dp_axes(sizes: dict) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in sizes else ("data",)


def step_collectives(cfg: ModelConfig, kind: str, params, specs, mesh, *,
                     batch: int, seq: int, n_micro: int = 1,
                     opt_specs=None, decode_specs=None) -> dict:
    """The collectives of one step of ``kind`` (train, prefill, decode) of
    ``cfg`` with the param tree ``params`` (meta tensors) under the spec
    tree ``specs`` on ``mesh`` (a ``DeviceMesh`` or a mapping of axis
    sizes): per device, summed over the step.  A train step
    rematerialises its blocks, as the dry-run's step does.  ``batch`` is a
    train step's microbatch (global), ``seq`` its positions (the frontend
    prefix included; 1 for decode); ``opt_specs`` the AdamW moments' specs
    (ZeRO-1), ``decode_specs`` the decode state's (SP)."""
    sizes = mesh if isinstance(mesh, dict) else axis_sizes(mesh)
    st = _Step(cfg, params, specs, sizes, kind, batch=batch, seq=seq,
               n_micro=n_micro, decode_specs=decode_specs)
    st.embed_and_head()
    for blk, n in Counter(layer_plan(cfg)).items():
        st.block(blk, n)
    st.fsdp_and_dp(opt_specs)
    return st.t.summary()


__all__ = ["Entry", "Tally", "summarize", "step_collectives", "tp_pair",
           "vocab_embedding", "grad_reduce", "fsdp_gather",
           "expert_all_to_all", "gathered"]
