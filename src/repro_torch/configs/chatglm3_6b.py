"""chatglm3-6b [dense; arXiv:2406.12793; hf]

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024 -- 2d/partial RoPE
(rotary on half the head dims, interleaved pairing, GLM convention), GQA
kv=2.  Transcribed from the JAX package's configs/chatglm3_6b.py.
"""
import torch

from repro_torch.configs import FULL_ATTN_SKIP, ArchSpec
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="chatglm3-6b",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab=65024,
    pattern=("attn",),
    rope="neox", rope_theta=1e4, rope_fraction=0.5, rope_interleaved=True,
    norm="rmsnorm", mlp_kind="swiglu",
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, dtype=torch.float32, remat=False,
)

SPEC = ArchSpec(
    name="chatglm3-6b", config=CONFIG, smoke=SMOKE,
    skip_shapes={"long_500k": FULL_ATTN_SKIP},
    notes="partial (2d) interleaved RoPE; extreme GQA kv=2",
)
