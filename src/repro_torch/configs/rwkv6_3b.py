"""rwkv6-3b [ssm; arXiv:2404.05892; hf]

"Finch": 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536 --
data-dependent decay + token-shift time-mix, squared-ReLU channel-mix.
Attention-free O(1)-state decode.  Transcribed from the JAX package's
configs/rwkv6_3b.py.
"""
import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="rwkv6-3b",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab=65536,
    pattern=("rwkv6",), rwkv_head_dim=64,
    rope="none", norm="layernorm",
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    rwkv_head_dim=16, d_ff=128, vocab=256, dtype=torch.float32, remat=False,
)

SPEC = ArchSpec(
    name="rwkv6-3b", config=CONFIG, smoke=SMOKE,
    notes="attention-free linear recurrence; long_500k O(1) state",
)
