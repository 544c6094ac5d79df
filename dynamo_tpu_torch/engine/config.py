"""Model and engine configuration (copy of ``dynamo_tpu.engine.config``).

ModelSpec (with ``from_hf_config``), EngineConfig and PRESETS are copied
field for field so a configuration means the same thing in both packages.
EngineConfig adds one field, ``device``. Fields that select features this
port does not serve yet (tp/pp/sp, MoE, tiers) keep
their defaults; the runner rejects non-default values rather than ignore
them.
"""

from __future__ import annotations

import dataclasses
import json
import os

from dynamo_tpu_torch.engine.kv_quant import KV_SCALE_BYTES

# H100 SXM HBM3 rate (NVIDIA data sheet); DTPU_HBM_GBPS overrides per part.
DEFAULT_HBM_GBPS = 3350.0


@dataclasses.dataclass
class ModelSpec:
    name: str = "tiny-test"
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: int | None = None  # defaults to hidden_size // num_heads
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    qkv_bias: bool = False  # Qwen2 style
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 8192
    # MoE (Mixtral family): num_experts == 0 means dense FFN.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # Weight-only quantization: None (bf16) or "int8".
    quant: str | None = None

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def num_params(self) -> int:
        """Approximate parameter count."""
        h, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        d = self.head_dim
        attn = h * (self.num_heads * d) + 2 * h * (self.num_kv_heads * d) \
            + (self.num_heads * d) * h
        if self.num_experts:
            mlp = self.num_experts * 3 * h * i + h * self.num_experts
        else:
            mlp = 3 * h * i
        per_layer = attn + mlp + 2 * h
        embed = v * h * (1 if self.tie_word_embeddings else 2)
        return self.num_layers * per_layer + embed + h

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """bf16-pool bytes per token (k+v, all layers/heads)."""
        return (2 * self.num_layers * self.num_kv_heads * self.head_dim
                * dtype_bytes)

    def weight_read_step_ms(self, tp: int = 1, pp: int = 1,
                            hbm_gbps: float | None = None) -> float:
        """Lower bound on a decode step for this spec's shard: one full
        read of the shard's bf16 weights from device memory."""
        if hbm_gbps is None:
            hbm_gbps = float(os.environ.get("DTPU_HBM_GBPS",
                                            str(DEFAULT_HBM_GBPS)))
        per_weight = 1.0 if self.quant == "int8" else 2.0
        shard_bytes = self.num_params() * per_weight / max(1, tp * pp)
        return shard_bytes / (hbm_gbps * 1e9) * 1e3

    @classmethod
    def from_hf_config(cls, path: str) -> "ModelSpec":
        """Build from a HF config.json (local dir or file)."""
        if os.path.isdir(path):
            path = os.path.join(path, "config.json")
        with open(path) as fh:
            cfg = json.load(fh)
        return cls(
            name=cfg.get("_name_or_path",
                         os.path.basename(os.path.dirname(path))),
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg.get("num_key_value_heads",
                                 cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim"),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            qkv_bias=cfg.get("model_type") == "qwen2",
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            max_position_embeddings=cfg.get("max_position_embeddings", 8192),
            num_experts=cfg.get("num_local_experts", 0),
            num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
        )


# Presets (shapes from the public model cards).
PRESETS: dict[str, ModelSpec] = {
    "tiny-test": ModelSpec(name="tiny-test", vocab_size=512, hidden_size=128,
                           intermediate_size=352, num_layers=2, num_heads=4,
                           num_kv_heads=2, max_position_embeddings=2048),
    "qwen2.5-0.5b": ModelSpec(name="qwen2.5-0.5b", vocab_size=151936,
                              hidden_size=896, intermediate_size=4864,
                              num_layers=24, num_heads=14, num_kv_heads=2,
                              rope_theta=1000000.0, qkv_bias=True,
                              tie_word_embeddings=True),
    # Llama-3-8B per-layer shapes with 8 of 32 layers.
    "llama-3-8b-L8": ModelSpec(name="llama-3-8b-L8", vocab_size=128256,
                               hidden_size=4096, intermediate_size=14336,
                               num_layers=8, num_heads=32, num_kv_heads=8,
                               rope_theta=500000.0),
    "llama-3-8b": ModelSpec(name="llama-3-8b", vocab_size=128256,
                            hidden_size=4096, intermediate_size=14336,
                            num_layers=32, num_heads=32, num_kv_heads=8,
                            rope_theta=500000.0),
    "llama-3-70b": ModelSpec(name="llama-3-70b", vocab_size=128256,
                             hidden_size=8192, intermediate_size=28672,
                             num_layers=80, num_heads=64, num_kv_heads=8,
                             rope_theta=500000.0),
}


@dataclasses.dataclass
class EngineConfig:
    model: ModelSpec = dataclasses.field(
        default_factory=lambda: PRESETS["tiny-test"])
    # KV paging
    page_size: int = 16  # tokens per page (= kv_cache_block_size)
    num_pages: int | None = None  # None => size from free device memory
    hbm_kv_budget_frac: float = 0.6  # fraction of free memory for KV
    max_pages_per_seq: int = 512
    # Batching
    max_num_seqs: int = 32
    max_prefill_tokens: int = 8192
    prefill_buckets: tuple = (128, 256, 512, 1024, 2048, 4096, 8192)
    # Decode steps per dispatched window (tokens chain on the device; the
    # host sees sampled tokens once per window). "auto" sizes M from the
    # weight-read step estimate so M x step lands near
    # DTPU_WINDOW_TARGET_MS (default 75 ms).
    decode_window: int | str = 8
    pp_microbatch: bool = False
    ring_attention: bool = False
    warmup_windows: bool = False
    warmup_prefill_ladder: bool = False
    prefill_chunk_tokens: int | str = "auto"
    # Windows in flight before the host blocks on the oldest readback.
    pipeline_depth: int = 8
    tp: int = 1
    dp: int = 1
    pp: int = 1
    sp: int = 1
    # Numerics
    dtype: str = "bfloat16"
    quant_kv: str | None = None
    attention_backend: str = "auto"
    host_cache_pages: int = 0
    kv_disk_cache_dir: str | None = None
    disk_cache_pages: int = 4096
    kv_demote_low_watermark: float = 0.0
    kv_demote_high_watermark: float = 0.0
    spec_decode: str | None = None
    spec_k: int = 3
    ttft_budget_ms: float | None = None
    admission_reject_factor: float = 0.0
    brownout_spec_disable_level: int = 2
    max_adapters: int = 0
    lora_max_rank: int = 8
    expected_roofline_frac: float | None = None
    # Port only: the torch device every tensor of the engine lives on.
    # "cuda" raises when no GPU is present; tests pass "cpu".
    device: str = "cuda"

    def resolve_quant_kv(self) -> str | None:
        """The effective KV-pool quantization mode, with the DTPU_QUANT_KV
        env override applied."""
        env = os.environ.get("DTPU_QUANT_KV")
        if env is not None:
            env = env.strip().lower()
            return None if env in ("", "none", "off", "bf16") else env
        return self.quant_kv

    def kv_token_bytes(self) -> int:
        """Per-token bytes in the device KV pool (k+v, all layers/heads):
        bf16 = 2 bytes/value; int8 = 1 byte/value + a 4-byte f32 scale per
        (layer, head, token). The single source for pool sizing."""
        m = self.model
        if self.resolve_quant_kv() == "int8":
            per_head = m.head_dim + KV_SCALE_BYTES
        else:
            per_head = 2 * m.head_dim
        return 2 * m.num_layers * m.num_kv_heads * per_head

    def lora_target_shapes(self) -> dict[str, tuple[int, int]]:
        """(d_in, d_out) per LoRA target projection: the attention
        projections and the dense MLP's (the port has no MoE, whose
        expert weights the reference leaves untargeted). The one source
        of the stacks' shapes in the runner, the loader's padding and the
        adapter store's checks."""
        m = self.model
        d = m.head_dim
        return {
            "wq": (m.hidden_size, m.num_heads * d),
            "wk": (m.hidden_size, m.num_kv_heads * d),
            "wv": (m.hidden_size, m.num_kv_heads * d),
            "wo": (m.num_heads * d, m.hidden_size),
            "w_gate": (m.hidden_size, m.intermediate_size),
            "w_up": (m.hidden_size, m.intermediate_size),
            "w_down": (m.intermediate_size, m.hidden_size),
        }

    def bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if length <= b:
                return b
        return self.prefill_buckets[-1]

    def resolve_decode_window(self) -> int:
        """Resolve ``decode_window="auto"`` to a concrete M: the window
        period M x (weight-read step + 1 ms host overhead) is sized to
        DTPU_WINDOW_TARGET_MS."""
        if isinstance(self.decode_window, int):
            if self.decode_window < 1:
                raise ValueError(
                    f"decode_window must be >= 1, got {self.decode_window}")
            return self.decode_window
        if self.decode_window != "auto":
            raise ValueError(
                f"decode_window must be an int or 'auto', "
                f"got {self.decode_window!r}")
        target_ms = float(os.environ.get("DTPU_WINDOW_TARGET_MS", "75"))
        step_ms = self.model.weight_read_step_ms(self.tp, self.pp) + 1.0
        raw = target_ms / step_ms
        nice = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64)
        return min(nice, key=lambda m: abs(m - raw))

    def resolve_prefill_chunk_tokens(self) -> int:
        """Resolve ``prefill_chunk_tokens="auto"`` to the chunk budget: the
        prompt tokens the engine dispatches as prefill chunks per loop
        iteration before the next decode window.

        Cost model: a chunk of n tokens costs about max(1, n / knee)
        weight-read periods. Below the knee a chunk is bound by reading
        the weights once, above it by compute (linear in n); the knee is
        the device's operations per byte of weights read. 256 tokens is
        the JAX package's default, not a measurement of this card;
        DTPU_PREFILL_KNEE_TOK sets it per part. The budget is sized so one
        iteration's chunk work costs about one DTPU_WINDOW_TARGET_MS
        window period, then rounded down to a prefill bucket (chunks pad
        to buckets). DTPU_PREFILL_CHUNK_TOKENS overrides the field."""
        val = self.prefill_chunk_tokens
        env = os.environ.get("DTPU_PREFILL_CHUNK_TOKENS")
        if env:
            val = env if env.strip() == "auto" else int(env)
        if not isinstance(val, str):
            if val < 1:
                raise ValueError(
                    f"prefill_chunk_tokens must be >= 1, got {val}")
            return max(self.page_size, int(val))
        if val != "auto":
            raise ValueError(
                f"prefill_chunk_tokens must be an int or 'auto', "
                f"got {val!r}")
        target_ms = float(os.environ.get("DTPU_WINDOW_TARGET_MS", "75"))
        step_ms = self.model.weight_read_step_ms(self.tp, self.pp)
        knee = float(os.environ.get("DTPU_PREFILL_KNEE_TOK", "256"))
        raw = int(knee * max(1.0, target_ms / max(step_ms, 1e-6)))
        raw = min(raw, self.max_prefill_tokens, self.prefill_buckets[-1])
        fit = [b for b in self.prefill_buckets if b <= raw]
        return max(self.page_size, fit[-1] if fit else raw)

    @property
    def max_model_len(self) -> int:
        """Longest sequence (prompt plus generated tokens) the engine
        serves: the only bound on what it accepts."""
        return self.max_pages_per_seq * self.page_size

    @property
    def max_prompt_len(self) -> int:
        """Longest prefill one program takes (a whole prompt or one
        chunk). Longer prompts, and prompt rests after a prefix-cache
        hit, are prefilled in chunks of at most this many tokens; it does
        not bound what the engine accepts (``max_model_len`` does)."""
        return min(self.max_prefill_tokens, self.prefill_buckets[-1])
