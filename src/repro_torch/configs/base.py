"""Model configuration schema + registry (the port's copy of the JAX
package's ``configs/base.py``; the same fields, defaults and smoke rule, so a
config means the same model in both packages)."""
from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["ModelConfig", "register", "get_config", "list_archs", "SHAPES",
           "ShapeSpec"]


def _round_up(n: int, k: int) -> int:
    return (n + k - 1) // k * k


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | rwkv6 | rglru | whisper
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    # attention
    rope_theta: float = 1e4
    attn_pattern: tuple[str, ...] = ("global",)   # cycled over layers
    window: int = 0                               # local / SWA window size
    qk_norm: bool = False
    logits_softcap: float = 0.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # hybrid (rglru)
    lru_width: int = 0
    conv1d_width: int = 4

    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_audio_frames: int = 1500

    # vlm
    m_rope: bool = False
    n_vision_tokens: int = 0

    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # numerics
    dtype: str = "bfloat16"

    # ---- performance knobs (hillclimb levers; defaults = paper-faithful
    # baseline). See EXPERIMENTS.md §Perf. -------------------------------
    # pad attention heads up to a multiple (0 = off). Padded heads are
    # masked to zero after PV, so the function is exactly the unpadded
    # model's; the win is head-sharding divisibility on 16-way meshes
    # (vs. head_dim sharding, whose contractions all-reduce every score
    # tensor).
    n_heads_padded: int = 0
    n_kv_heads_padded: int = 0
    # compute attention scores in bf16 on the HBM path (fp32 accumulate
    # stays in the PV matmul) — halves the dominant attention HBM traffic.
    scores_bf16: bool = False
    # streaming-attention block sizes. Larger q_chunk cuts the KV re-read
    # amplification (total KV traffic = (S/q_chunk) * T * Dh).
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024

    # reduced smoke-test override factory (set by register())
    _smoke: Callable | None = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 256 so the logit head shards over any mesh."""
        return _round_up(self.vocab, 256)

    @property
    def h_eff(self) -> int:
        return self.n_heads_padded or self.n_heads

    @property
    def kv_eff(self) -> int:
        return self.n_kv_heads_padded or self.n_kv_heads

    @property
    def attn_kinds(self) -> tuple[str, ...]:
        """Per-layer attention kind, pattern cycled to n_layers."""
        pat = self.attn_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied), the
        reference's formula."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        h, kv, dh = self.n_heads, self.n_kv_heads, self.d_head
        if self.family == "rwkv6":
            per_layer = 4 * d * d + 2 * d * f + d * d  # tmix (r,k,v,o,g) + cmix
            per_layer += 6 * 32 * d * 2 + d * dh  # lora decay/mix params (approx)
            return (v * d + self.n_layers * per_layer
                    + (0 if self.tie_embeddings else v * d))
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.family == "moe":
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            mlp = 3 * d * f
        layers = self.n_layers * (attn + mlp + 2 * d)
        if self.family == "whisper":
            layers += self.n_enc_layers * (attn + mlp + 2 * d)  # encoder
            layers += self.n_layers * (attn + 2 * d)            # cross-attn
        embed = v * d * (1 if self.tie_embeddings else 2)
        return layers + embed

    def smoke_config(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        if self._smoke is not None:
            return self._smoke(self)
        # enough layers to exercise the full attention pattern (and, for
        # rglru, at least one macro-block plus the recurrent tail)
        n_layers = max(2, len(self.attn_pattern))
        if self.family == "rglru":
            n_layers = 5
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=n_layers,
            d_model=64, n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=16, d_ff=128, vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            lru_width=64 if self.lru_width else 0,
            window=min(self.window, 32) if self.window else 0,
            n_enc_layers=2 if self.n_enc_layers else 0,
            n_audio_frames=24 if self.n_enc_layers else 0,
            n_vision_tokens=16 if self.n_vision_tokens else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import _ensure_loaded  # populate registry lazily
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}: this package has "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    from . import _ensure_loaded
    _ensure_loaded()
    return sorted(_REGISTRY)
