"""chameleon-34b [vlm; arXiv:2405.09818; unverified]

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 -- early-fusion VQ
image tokens.  The modality frontend is a stub, as in the JAX package: VQ
image tokens are ordinary vocabulary ids in an early-fusion model, so the
inputs are plain token ids.  qk-norm of the LayerNorm kind.  Transcribed
from the JAX package's configs/chameleon_34b.py.
"""
import torch

from repro_torch.configs import FULL_ATTN_SKIP, ArchSpec
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="chameleon-34b",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=65536,
    pattern=("attn",),
    rope="neox", rope_theta=1e4,
    qk_norm=True, qk_norm_kind="layernorm",
    norm="rmsnorm", mlp_kind="swiglu",
    dtype=torch.bfloat16,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab=256, dtype=torch.float32,
)

SPEC = ArchSpec(
    name="chameleon-34b", config=CONFIG, smoke=SMOKE,
    skip_shapes={"long_500k": FULL_ATTN_SKIP},
    notes="early-fusion VLM backbone; image tokenizer stubbed (token ids)",
)
