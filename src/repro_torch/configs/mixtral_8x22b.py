"""mixtral-8x22b [moe; arXiv:2401.04088; hf]

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8 experts
top-2, sliding-window attention (window 4096).  Transcribed from the JAX
package's configs/mixtral_8x22b.py.
"""
import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768,
    pattern=("swa",), window=4096,
    n_experts=8, top_k=2,
    moe_group_size=512, moe_capacity=1.25,
    rope="neox", rope_theta=1e6,
    norm="rmsnorm", mlp_kind="swiglu",
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=256, n_experts=4, window=16, moe_group_size=64,
    moe_capacity=8.0,  # no-drop capacity, as the JAX package's SMOKE
    dtype=torch.float32,
)

SPEC = ArchSpec(
    name="mixtral-8x22b", config=CONFIG, smoke=SMOKE,
    notes="8e top-2 MoE, SWA(4096) ring cache -> long_500k runnable",
)
