"""zamba2-7b [hybrid; arXiv:2411.15242; unverified]

81L d_model=3584 Mamba2 backbone (ssm_state=64, headdim 64 -> d_inner=7168,
112 SSD heads) with a weight-SHARED attention+MLP block (32H, d_ff=14336)
applied over concat(hidden, embedding) at the top of every 6-layer cycle
(13 cycles + 3-layer tail = 14 invocations).  Per-invocation LoRA on the
shared block is omitted, as in the JAX package.  Transcribed from the JAX
package's configs/zamba2_7b.py.
"""
import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="zamba2-7b",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000,
    pattern=("mamba2",) * 6, shared_every=6,
    shared_n_heads=32, shared_d_ff=14336,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    rope="neox", rope_theta=1e4,
    norm="rmsnorm",
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=9, pattern=("mamba2",) * 3, shared_every=3,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    shared_n_heads=4, shared_d_ff=128, d_ff=128, vocab=256,
    ssm_state=16, ssm_head_dim=16,
    dtype=torch.float32,
)

SPEC = ArchSpec(
    name="zamba2-7b", config=CONFIG, smoke=SMOKE,
    notes="Mamba2 backbone + shared attn block every 6 layers; "
          "long_500k O(1) SSM state",
)
