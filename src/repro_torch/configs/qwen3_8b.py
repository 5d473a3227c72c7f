"""qwen3-8b [dense; hf:Qwen/Qwen3-8B; hf]

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936 -- per-head q/k
RMSNorm, RoPE theta 1e6, SwiGLU.  Transcribed from the JAX package's
configs/qwen3_8b.py.
"""
import torch

from repro_torch.configs import FULL_ATTN_SKIP, ArchSpec
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen3-8b",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab=151936,
    pattern=("attn",),
    rope="neox", rope_theta=1e6,
    qk_norm=True, qk_norm_kind="rmsnorm",
    norm="rmsnorm", mlp_kind="swiglu",
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, dtype=torch.float32,
)

SPEC = ArchSpec(
    name="qwen3-8b", config=CONFIG, smoke=SMOKE,
    skip_shapes={"long_500k": FULL_ATTN_SKIP},
    notes="dense GQA + qk-norm",
)
