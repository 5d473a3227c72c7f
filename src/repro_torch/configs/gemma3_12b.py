"""gemma3-12b [dense; hf:google/gemma-3-1b-pt; unverified]

48L d_model=3840 16H (GQA kv=8) head_dim=256 (attention dim 4096 != d_model)
d_ff=15360 vocab=262144 -- 5:1 local(window 1024):global layer pattern,
qk-norm, GeGLU, tied + sqrt(d)-scaled embeddings, 128k-native context.
Transcribed from the JAX package's configs/gemma3_12b.py.
"""
import torch

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="gemma3-12b",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    rope="neox", rope_theta=1e6, rope_theta_local=1e4,
    qk_norm=True, qk_norm_kind="rmsnorm",
    norm="rmsnorm", mlp_kind="geglu",
    embed_scale=True, tie_embeddings=True,
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, window=8, dtype=torch.float32, remat=False,
)

SPEC = ArchSpec(
    name="gemma3-12b", config=CONFIG, smoke=SMOKE,
    notes="5:1 local:global; ring caches bound 40/48 layers at 500k decode",
)
