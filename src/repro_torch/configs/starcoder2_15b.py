"""starcoder2-15b [dense; arXiv:2402.19173; hf]

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152 -- GQA, RoPE,
LayerNorm + plain (non-gated) GELU MLP per StarCoder2.  Transcribed from
the JAX package's configs/starcoder2_15b.py.
"""
import torch

from repro_torch.configs import FULL_ATTN_SKIP, ArchSpec
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="starcoder2-15b",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab=49152,
    pattern=("attn",),
    rope="neox", rope_theta=1e5,
    norm="layernorm", mlp_kind="gelu",
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, dtype=torch.float32, remat=False,
)

SPEC = ArchSpec(
    name="starcoder2-15b", config=CONFIG, smoke=SMOKE,
    skip_shapes={"long_500k": FULL_ATTN_SKIP},
    notes="dense GQA kv=4; non-gated GELU MLP",
)
