"""Model, K-FAC and training configs (mirrors ``repro/configs/base.py``).

Field names and defaults match the reference for every field this port
reads.  A field that selects a mode the port does not have yet raises
``NotImplementedError`` when it is set to that mode.

Not carried over: ``kernel_backend`` and ``autotune`` chose between XLA and
the Pallas kernels and tuned Pallas tiles on a TPU.  The port chooses by
device instead: on a CUDA tensor the hand-written kernels run, on a CPU
tensor their plain PyTorch versions.  ``obs`` (telemetry) and the mesh
fields wait for later slices.

:class:`ModelConfig` (the LM architectures) is mirrored field for field;
which families the port's LM runs is decided by ``models/lm.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (transformer backbone families).

    ``family`` is one of: dense | moe | hybrid | ssm | vlm | audio.
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # --- attention variants ---
    attn_free: bool = False           # rwkv6: no attention at all
    sliding_window: int = 0           # gemma2: local window size (the even
                                      # pattern positions, models/lm.py)
    alt_local_global: bool = False    # gemma2: alternate local/global attention
    logit_softcap: float = 0.0        # gemma2 final-logit soft cap
    attn_softcap: float = 0.0         # gemma2 attention-score soft cap
    rope_theta: float = 10_000.0
    use_qk_norm: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                # MoE layer every N layers (others dense)
    moe_shared_expert: bool = False   # llama4-style shared expert alongside routed

    # --- hybrid (jamba) / ssm ---
    attn_every: int = 0               # jamba: 1 attention layer per this many
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2

    # --- rwkv6 ---
    rwkv_head_dim: int = 64

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0           # >0 -> enc-dec; n_layers = decoder layers
    encoder_seq: int = 1500           # number of (stubbed) audio frames

    # --- modality frontends (real conv stems, KFC-preconditioned) ---
    frontend: str = "none"            # none | patch | audio
    frontend_tokens: int = 0          # patch/frame token count after the stem
    n_mels: int = 80                  # audio: log-mel channels into the
                                      # Conv1D stem (k=3 s=1, then k=3 s=2)
    image_size: int = 0               # patch: square input image side
    patch_size: int = 0               # patch: Conv2D patchifier kernel=stride
    image_channels: int = 3           # patch: input image channels

    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    max_seq: int = 540_672

    # which shapes this arch supports (subset of SHAPES keys)
    skip_shapes: Tuple[str, ...] = ()

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        return (i % self.moe_every) == (self.moe_every - 1)

    def is_attn_layer(self, i: int) -> bool:
        """For hybrid archs, whether layer i is attention (else Mamba)."""
        if self.attn_free:
            return False
        if self.attn_every <= 1:
            return True
        # jamba: one attention layer per `attn_every` block, in the middle
        return (i % self.attn_every) == (self.attn_every // 2)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

# field -> the values this port supports so far
_PORTED_ONLY = {
    "inv_mode": ("blkdiag", "tridiag", "eigen"),
    "refresh_mode": ("serial", "staggered"),
}


@dataclass(frozen=True)
class KFACConfig:
    """The paper's optimizer hyper-parameters (section references in brackets)."""

    inv_mode: str = "blkdiag"         # blkdiag                 [S4.2]
                                      # | tridiag: block-tridiagonal
                                      # F̂⁻¹ = Ξᵀ Λ Ξ on chain models [S4.3]
                                      # | eigen (EKFAC, 1806.03884): amortized
                                      # factor eigenbases + per-step diagonal
    eigen_decay: float = 0.95         # eigen mode: EMA decay of the
                                      # eigenbasis second-moment diagonal s
    inverse_method: str = "ns"        # ns | eigh | solve       [S8 / App B]
    ns_iters: int = 12                # Newton-Schulz iterations (cold start)
    ns_hot_iters: int = 4             # when hot-started from previous inverse
                                      # (the staggered refresh's subsets)

    lambda_init: float = 150.0        # LM damping initial value  [S6.5]
    eta: float = 1e-5                 # l2 regularization coefficient [S13]
    t1: int = 5                       # lambda adaptation period  [S6.5]
    t2: int = 20                      # gamma adaptation period   [S6.6]
    t3: int = 20                      # inverse recompute period  [S8]
    omega1_base: float = 19.0 / 20.0  # lambda decay base         [S6.5]
    omega2_base: float = 19.0 / 20.0  # gamma decay base (sqrt)   [S6.6]

    decay_cap: float = 0.95           # epsilon = min(1 - 1/k, cap) [S5]
    tau1: float = 1.0                 # stats subsample fraction  [S8]
    tau2: float = 1.0                 # exact-F subsample fraction [S8];
                                      # read by no code, as in the reference

    use_momentum: bool = True         # (alpha, mu) from exact-F 2x2 solve [S7]
    use_rescale: bool = True          # exact-F alpha rescale     [S6.4]
    fixed_lr: float = 0.05            # used only when use_rescale=False

    fused_stats: bool = False         # contract the factor statistics
                                      # inside the passes [S5]
                                      # (core/fused.py; not on an LM yet)
    fixed_momentum: float = 0.0       # use_rescale=False only: heavy-ball
                                      # mu for the fused update chain
    clip_delta_norm: float = 0.0      # use_rescale=False only: global-norm
                                      # clip of the applied update (0 = off)
    kl_clip: float = 0.0              # use_rescale=False only: norm-constraint
                                      # max lr²·|Δᵀ∇| per step (0 = off)
    stats_period: int = 1             # update stats every N steps
    staggered_inverse: bool = False   # legacy alias for refresh_mode="staggered"
    refresh_mode: str = "serial"      # serial | staggered: how the T3 inverse
                                      # refresh is executed (staggered spreads
                                      # the blocks over T3 steps in groups
                                      # from distributed/plan.py); sharded |
                                      # overlap wait for the distributed slice

    def __post_init__(self):
        for name, ok in _PORTED_ONLY.items():
            if getattr(self, name) not in ok:
                raise NotImplementedError(
                    f"KFACConfig.{name}={getattr(self, name)!r} is not ported "
                    f"yet (only {' or '.join(map(repr, ok))})")
        if self.inverse_method not in ("ns", "eigh", "solve"):
            raise ValueError(f"unknown inverse_method {self.inverse_method!r}")

    def replace(self, **kw) -> "KFACConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop settings (the reference's, less the dtype, remat,
    gradient-accumulation and telemetry fields, which the port's trainer
    does not read)."""

    steps: int = 200
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    log_every: int = 10
    curvature_every: int = 0          # export a curvature bundle at steps
                                      # divisible by this AND by
                                      # checkpoint_every (0 = never)
