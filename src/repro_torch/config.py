"""Configuration system.

Families of dataclasses:

* :class:`ModelConfig` — architecture hyperparameters (one instance per
  architecture lives in ``repro_torch.configs``).
* :class:`ShapeConfig` — the benchmark input shapes (train / prefill /
  decode / long-context decode), in :data:`SHAPES`.
* :class:`ModestConfig` / :class:`TrainConfig` — the paper's protocol
  parameters (Table 2) and learning hyperparameters.
* :class:`MeshConfig` — the production device mesh (``launch.mesh``).
* :class:`HardwareSpec` — one card's peak rates and memory for the
  roofline (``repro_torch.roofline``): :data:`H100`.

Configs are plain frozen dataclasses so they hash, print, and round-trip
through the CLI (`--arch`, `--shape`, `--set key=value`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model architecture
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm", "cnn", "mf")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # one of FAMILIES
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0

    # --- MoE ---------------------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff_expert: int = 0
    moe_dense_ff: int = 0            # arctic-style dense residual FFN (0 = none)
    moe_group_size: int = 256        # GShard dispatch group
    moe_capacity_factor: float = 1.25

    # --- SSM / hybrid --------------------------------------------------------
    ssm_state: int = 0               # mamba/rwkv state expansion
    ssm_conv: int = 4                # depthwise conv width (hymba's mamba branch)

    # --- attention variants --------------------------------------------------
    window: int = 0                  # 0 = full attention; >0 = sliding window
    local_global_alt: bool = False   # gemma2: alternate local/global layers
    attn_softcap: float = 0.0        # gemma2 logit soft-capping
    final_softcap: float = 0.0

    # --- modality frontends (stubs per brief) --------------------------------
    encoder_layers: int = 0          # whisper encoder depth
    n_frames: int = 0                # whisper: stubbed mel-frame embeddings
    image_tokens: int = 0            # llava: stubbed patch embeddings per image
    anyres_tiles: int = 5            # llava-next anyres grid (tiles incl. base)

    # --- numerics / distribution ---------------------------------------------
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    participant_granularity: str = "data_rank"   # or "pod" for >~100B params
    remat: bool = True
    # §Perf levers (off in the paper-faithful baseline):
    act_shard: bool = False      # constrain residual stream over 'model'
    xent_chunk: int = 0          # sequence-chunked cross-entropy (0 = off)
    replicate_attention: bool = False  # MoE: no TP on attention params
    use_flash: bool = False      # hand-written flash-attention kernel

    citation: str = ""

    # --- CNN / MF (paper-reproduction models) --------------------------------
    cnn_channels: Tuple[int, ...] = ()
    cnn_classes: int = 0
    cnn_image: Tuple[int, int, int] = (0, 0, 0)
    mf_users: int = 0
    mf_items: int = 0
    mf_dim: int = 0

    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Rough parameter counts -- used for roofline MODEL_FLOPS = 6·N·D and
    # memory napkin math. Exact counts come from the real pytree.
    def approx_params(self) -> int:
        d, L, V = self.d_model, self.n_layers, self.vocab
        hd = self.resolved_head_dim()
        if self.family == "cnn":
            return 200_000
        if self.family == "mf":
            return (self.mf_users + self.mf_items) * self.mf_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "ssm":
            attn = 2 * d * d + 4 * d * self.ssm_state  # rwkv mixing approx
        if self.family == "moe":
            ff = 3 * d * self.moe_d_ff_expert * self.moe_num_experts
            ff += 3 * d * self.moe_dense_ff
            ff += d * self.moe_num_experts  # router
        else:
            ff = 3 * d * self.d_ff
        per_layer = attn + ff + 2 * d
        total = L * per_layer + V * d  # embed (+ lm head tied)
        if self.family == "audio":
            total += self.encoder_layers * (4 * d * d + 2 * d * self.d_ff + 2 * d)
        if self.family == "hybrid":
            total += L * (2 * d * self.ssm_state + d * d)
        return int(total)

    def approx_active_params(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.approx_params()
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim()
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        ff = 3 * d * self.moe_d_ff_expert * self.moe_top_k + 3 * d * self.moe_dense_ff
        return int(L * (attn + ff + 2 * d) + self.vocab * d)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# MoDeST protocol parameters (paper Table 2)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModestConfig:
    n_nodes: int = 100               # total population n
    sample_size: int = 10            # s — trainers per round
    n_aggregators: int = 2           # a — aggregators per sample (a = z + 1)
    success_fraction: float = 1.0    # sf — fraction of models to aggregate
    ping_timeout: float = 2.0        # Δt (seconds, simulated)
    activity_window: int = 20        # Δk (rounds)
    local_steps: int = 1             # E — local passes before push (FedAvg E)
    seed: int = 0
    # Trainer-side aggregator failover (§4 failover story): if round k+1
    # shows no progress after a trainer pushed its model, it re-samples
    # A^{k+1} (excluding the aggregators already tried) and re-sends.
    # "auto" enables it exactly when a fault fabric is attached — clean
    # sessions keep the golden-pinned trajectories byte-identical, while
    # every fault-injected run exercises the hardened path. True/False
    # force it on/off regardless.
    failover: object = "auto"        # "auto" | True | False
    # Secure aggregation: "masked"
    # seals every model push under pairwise masks with threshold-gated
    # Shamir recovery — only masked bit patterns travel, and the
    # aggregator unmasks only once >= t shares survive. None (default)
    # is the plain protocol: no extra messages, no extra bytes, golden
    # trajectories byte-identical to pre-secureagg builds.
    secure_agg: Optional[str] = None  # None | "masked"


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "sgd"           # sgd | momentum | adamw | yogi
    lr: float = 0.01
    momentum: float = 0.0
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    batch_size: int = 20             # paper: B = 20
    rounds: int = 100
    eval_every: int = 5
    # aggregator-side server optimizer (FedYogi/FedAdam style; "avg" = FedAvg)
    server_optimizer: str = "avg"
    server_lr: float = 1.0
    # dtype of the aggregation collective (§Perf: bfloat16 halves the
    # all-reduce; float32 is the paper-faithful baseline)
    agg_dtype: str = "float32"
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """The production mesh from the brief: ``data`` x ``model`` devices, or
    ``pods`` of them with ``multi_pod``. It sets the participant count of
    the mesh form and the sizes of the axes that ``sharding.ShardingPolicy``'s
    specs name; one card runs a mesh as entries that name it again and
    again (``launch.mesh.make_mesh_from_config``)."""

    multi_pod: bool = False
    data: int = 16
    model: int = 16
    pods: int = 2

    @property
    def shape(self):
        return ((self.pods, self.data, self.model) if self.multi_pod
                else (self.data, self.model))

    @property
    def axes(self):
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def n_devices(self):
        n = self.data * self.model
        return n * self.pods if self.multi_pod else n


# ---------------------------------------------------------------------------
# Hardware constants (roofline)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareSpec:
    """One card's peak rates and memory. The defaults are one NVIDIA H100
    SXM5 80GB HBM3 at its 700 W limit (NVIDIA's data sheet, dense rates;
    the INT32 row of the H100 architecture white paper: 64 lanes an SM x
    132 SMs x 1.98 GHz x 2, a multiply-add counted as two). The first four
    fields are the reference's."""

    peak_flops_bf16: float = 989e12      # bf16 dense, tensor cores
    hbm_bandwidth: float = 3.35e12       # bytes/s
    # bytes/s a card over NVLink 4 (18 links); no run on one card uses it
    ici_bandwidth: float = 900e9
    hbm_bytes: float = 80e9              # capacity
    peak_flops_fp32: float = 67e12       # fp32 outside the tensor cores
    peak_ops_int32: float = 33.5e12      # int32 outside the tensor cores
    n_sms: int = 132
    sm_clock_hz: float = 1.98e9          # boost clock


H100 = HardwareSpec()

# The reference's TPU v5e constants, kept only so that parity tests can
# hold the roofline's terms to the reference's; no port code uses them.
# The fields the reference does not have are 0 (not stated).
V5E = HardwareSpec(peak_flops_bf16=197e12, hbm_bandwidth=819e9,
                   ici_bandwidth=50e9, hbm_bytes=16e9, peak_flops_fp32=0.0,
                   peak_ops_int32=0.0, n_sms=0, sm_clock_hz=0.0)


def parse_overrides(pairs):
    """Parse ``--set key=value`` CLI overrides into a dict with literal types."""
    out = {}
    for p in pairs or ():
        k, _, v = p.partition("=")
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "True"):
            v = True
        if v in ("false", "False"):
            v = False
        out[k.strip()] = v
    return out
