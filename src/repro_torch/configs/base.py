"""Model configuration schema + input-shape suite.

Every assigned architecture is a ``ModelConfig`` instance (one file per
arch in this package).  ``reduced()`` derives the small same-family smoke
variant used by CPU tests; the full config is only ever lowered abstractly
by the dry-run.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    act: str = "swiglu"
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_shared_ff: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # hybrid (Zamba2-style: Mamba-2 backbone + one shared attn+FFN block)
    ssm_state: int = 0
    mamba_head_dim: int = 64
    shared_attn_every: int = 0
    # xLSTM
    slstm_every: int = 0        # sLSTM at layers i % k == k-1; 0 = none
    mlstm_proj_factor: float = 2.0
    # modality frontend stub (precomputed embeddings via input_specs)
    frontend: str = "none"      # none | vision | audio
    frontend_len: int = 0
    # capabilities
    sub_quadratic: bool = False  # can run long_500k
    dtype: str = "float32"
    # Megatron-style sequence parallelism on the residual stream.  Pays a
    # structural price (weight-grad partial-sum all-reduces in the scan
    # backward) in exchange for 1/TP activation memory — worth it only for
    # archs whose activations/params are HBM-critical; the launcher sets it
    # alongside FSDP (see launch/dryrun.py §Perf iteration 3).
    seq_parallel: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_params(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, l = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":        # xLSTM
            n_sl = sum(1 for i in range(l)
                       if self.slstm_every and i % self.slstm_every == self.slstm_every - 1)
            n_ml = l - n_sl
            di = int(d * self.mlstm_proj_factor)
            ml = n_ml * (d * 2 * di + 3 * di * di + di * 2 * self.n_heads + di * d)
            sl = n_sl * (4 * d * d + int(d * 4 / 3) * d * 3)
            return emb + ml + sl
        if self.family == "hybrid":
            d_inner = self.n_heads * self.mamba_head_dim
            per_mamba = d * (2 * d_inner + 2 * self.ssm_state + self.n_heads) \
                + d_inner * d
            n_shared = l // max(self.shared_attn_every, 1) if self.shared_attn_every else 0
            shared = d * (self.n_heads + 2 * self.n_kv_heads) * hd + \
                self.n_heads * hd * d + 3 * d * self.d_ff
            return emb + l * per_mamba + (shared if n_shared else 0)
        attn = l * d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.n_experts:
            ff = l * (self.n_experts * 3 * d * self.d_ff
                      + (3 * d * self.moe_shared_ff if self.moe_shared_ff else 0)
                      + d * self.n_experts)
        else:
            gated = self.act in ("swiglu", "geglu")
            ff = l * (3 if gated else 2) * d * self.d_ff
        return emb + attn + ff

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.n_experts:
            return self.n_params
        d, l = self.d_model, self.n_layers
        inactive = l * (self.n_experts - self.top_k) * 3 * d * self.d_ff
        return self.n_params - inactive

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 5),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256 if not self.n_experts else 64,
            vocab=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_shared_ff=128 if self.moe_shared_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            mamba_head_dim=32 if self.ssm_state else 64,
            shared_attn_every=2 if self.shared_attn_every else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            frontend_len=16 if self.frontend != "none" else 0,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, shape) is a valid cell; reason if not."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 524k-token decode is O(S) cache "
                       "per step with no sub-quadratic variant for this "
                       "config (skip noted in DESIGN.md §Arch-applicability)")
    return True, ""
