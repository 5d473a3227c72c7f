"""whisper-large-v3 [audio; arXiv:2212.04356; unverified]

Encoder-decoder: 32 encoder + 32 decoder layers, d_model=1280 20H (MHA
kv=20) d_ff=5120 vocab=51866; LayerNorm, plain GELU, no RoPE (sinusoidal
encoder and learned decoder positions).  The conv/mel frontend is a stub:
the encoder takes precomputed frame embeddings [B, T, d].  Transcribed
from the JAX package's configs/whisper_large_v3.py.
"""
import torch

from repro_torch.configs import FULL_ATTN_SKIP, ArchSpec
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="whisper-large-v3",
    n_layers=32, enc_layers=32,
    d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866,
    rope="none", norm="layernorm", mlp_kind="gelu",
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=256, dtype=torch.float32,
)

SPEC = ArchSpec(
    name="whisper-large-v3", config=CONFIG, smoke=SMOKE,
    skip_shapes={"long_500k": FULL_ATTN_SKIP
                 + "; Whisper additionally has no 500k-decode semantics"},
    notes="enc-dec; frame frontend stubbed (precomputed embeddings)",
)
