"""Shared layers of the LM zoo: dense, norms, per-head q/k norms, the MLPs
(swiglu, geglu, gelu, relu2), embeddings, rotary position embeddings and
the encoder's sinusoidal positions.

Functional, like the JAX package: parameters are plain dicts of tensors and
every function is `f(params, x, ...) -> y`.  The JAX package's sharding
annotations are no-ops on one device and are dropped.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "dense", "norm_init", "apply_norm", "qk_norm_init",
           "apply_qk_norm", "mlp_init", "mlp", "embed_init", "embed_lookup",
           "unembed", "rope_frequencies", "apply_rope",
           "sinusoidal_positions"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> dict:
    """Truncated-normal (+-2 sigma) fan-in init, drawn in f32 on the
    generator's device and cast to `dtype`."""
    s = 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return {"w": (w * s).to(dtype)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x [..., d_in] @ w [d_in, d_out], in the input dtype."""
    return torch.matmul(x, params["w"])


def norm_init(d: int, kind: str = "rmsnorm", dtype=torch.float32,
              device=None) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    raise ValueError(kind)


def apply_norm(params: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm / LayerNorm in f32, cast back to the input dtype.  eps is
    1e-6 for both kinds, as in the JAX package (PyTorch's LayerNorm default
    is 1e-5)."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"].to(torch.float32)
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = ((xf - mu) * torch.rsqrt(var + eps)
             * params["scale"].to(torch.float32)
             + params["bias"].to(torch.float32))
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


def qk_norm_init(head_dim: int, kind: str = "rmsnorm", dtype=torch.float32,
                 device=None) -> dict:
    """Per-head q/k norms (qwen3 / gemma3 RMS, chameleon LayerNorm)."""
    return {"q": norm_init(head_dim, kind, dtype, device),
            "k": norm_init(head_dim, kind, dtype, device)}


def apply_qk_norm(params: dict, q, k, kind: str = "rmsnorm"):
    return (apply_norm(params["q"], q, kind), apply_norm(params["k"], k, kind))


# --------------------------------------------------------------------------- #
# MLP (swiglu / geglu / gelu / relu2)
# --------------------------------------------------------------------------- #
def _gelu(x):
    """The tanh form, as jax.nn.gelu(approximate=True)."""
    return F.gelu(x, approximate="tanh")


_GATED = {"swiglu": F.silu, "geglu": _gelu}
_PLAIN = {"gelu": _gelu, "relu2": lambda x: torch.square(F.relu(x))}


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             kind: str = "swiglu", dtype=torch.float32) -> dict:
    p = {"up": dense_init(gen, d_model, d_ff, dtype),
         "down": dense_init(gen, d_ff, d_model, dtype)}
    if kind in _GATED:
        p["gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp(params: dict, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """Position-wise FFN, in the input dtype."""
    if kind in _GATED:
        h = _GATED[kind](dense(params["gate"], x)) * dense(params["up"], x)
    elif kind in _PLAIN:
        h = _PLAIN[kind](dense(params["up"], x))
    else:
        raise ValueError(kind)
    return dense(params["down"], h)


# --------------------------------------------------------------------------- #
# Embeddings
# --------------------------------------------------------------------------- #
def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32) -> dict:
    w = torch.randn((vocab, d_model), dtype=torch.float32, device=gen.device,
                    generator=gen)
    return {"w": (w * (1.0 / math.sqrt(d_model))).to(dtype)}


def embed_lookup(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [...] int -> [..., d]: a plain gather (the JAX package's
    one-hot matmul exists only under multi-device sharding rules)."""
    return params["w"][tokens]


class _MatmulF32Out(torch.autograd.Function):
    """x [N, d] @ w[V, d].T with f32 output from half-precision operands
    (`torch.mm(..., out_dtype=float32)`).  The backward takes the f32
    cotangent against the operands upcast to f32 and rounds each gradient
    once to its operand's dtype (JAX's transpose of a dot with
    `preferred_element_type=f32`, whose cotangent stays f32)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.mm(g, w.to(torch.float32)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(g.t(), x.to(torch.float32)).to(w.dtype)
        return gx, gw


def unembed(params: dict, x: torch.Tensor,
            scale: float | None = None) -> torch.Tensor:
    """x [..., d] -> f32 logits [..., V], times `scale` if given.

    A bf16 table on the card goes through one bf16 GEMM with an f32 output
    (`torch.mm(..., out_dtype=torch.float32)`): the product accumulates in
    f32, as the JAX package's `preferred_element_type=f32` asks, and the
    [V, d] table is neither copied nor cast per call -- the cost is that of
    the bf16 product alone.  Elsewhere (f32 tables, CPU tensors) both
    operands are taken in f32.  PyTorch has no derivative for the
    `out_dtype` product, so it runs inside `_MatmulF32Out`.
    """
    w = params["w"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if w.is_cuda and w.dtype in (torch.bfloat16, torch.float16) \
            and x2.dtype == w.dtype:
        logits = _MatmulF32Out.apply(x2, w)
    else:
        logits = torch.mm(x2.to(torch.float32), w.to(torch.float32).t())
    if scale is not None:
        logits = logits * scale
    return logits.reshape(*lead, w.shape[0])


# --------------------------------------------------------------------------- #
# Rotary position embeddings (neox, partial/interleaved)
# --------------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float, fraction: float = 1.0,
                     device=None):
    """Inverse frequencies (f32) for the rotated sub-dimension, and its
    width."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))
    return inv, rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 1e4, fraction: float = 1.0,
               interleaved: bool = False) -> torch.Tensor:
    """x: [B, T, H, dh], positions: [B, T] (absolute token positions).

    fraction < 1 rotates only the first `fraction * dh` dims (chatglm3);
    `interleaved` pairs (0,1), (2,3), ... instead of neox half-splitting.
    Angles and their cos/sin in f32; the rotation runs in the input dtype,
    with cos and sin cast to it first, as the JAX package does.
    """
    dh = x.shape[-1]
    inv, rot = rope_frequencies(dh, theta, fraction, x.device)
    ang = positions[..., None].to(torch.float32) * inv         # [B, T, rot/2]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    xr, xp = x[..., :rot], x[..., rot:]
    if interleaved:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    else:
        half = rot // 2
        x1, x2 = xr[..., :half], xr[..., half:]
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                            dim=-1)
    return torch.cat([rotated.to(x.dtype), xp], dim=-1)


def sinusoidal_positions(T: int, d: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """The Whisper encoder's fixed position table [T, d]: sin then cos of
    t * 10000^(-i / (half - 1)), computed in f32.  The divisor is
    max(half - 1, 1), not half, as in the JAX package."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / max(half - 1, 1))
    ang = (torch.arange(T, dtype=torch.float32, device=device)[:, None]
           * freq[None, :])
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
