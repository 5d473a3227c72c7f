"""arctic-480b [moe; hf:Snowflake/snowflake-arctic-base; hf]

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts
top-2 plus a parallel dense-residual FFN of 4864 per layer.  Transcribed
from the JAX package's configs/arctic_480b.py.
"""
import torch

from repro_torch.configs import FULL_ATTN_SKIP, ArchSpec
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="arctic-480b",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000,
    pattern=("attn",),
    n_experts=128, top_k=2, dense_ff=4864,
    moe_group_size=512, moe_capacity=1.25,
    rope="neox", rope_theta=1e4,
    norm="rmsnorm", mlp_kind="swiglu",
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=256, n_experts=4, dense_ff=96, moe_group_size=64,
    moe_capacity=8.0,  # no token ever drops, as the JAX package's SMOKE
    dtype=torch.float32, remat=False,
)

SPEC = ArchSpec(
    name="arctic-480b", config=CONFIG, smoke=SMOKE,
    skip_shapes={"long_500k": FULL_ATTN_SKIP},
    notes="128e top-2 MoE + dense residual FFN; expert-parallel over 'model'",
)
