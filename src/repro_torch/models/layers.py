"""Shared layers of the LM zoo, as far as RWKV-6 needs them.

Functional, like the JAX package: parameters are plain dicts of tensors and
every function is `f(params, x, ...) -> y`.  The JAX package's sharding
annotations are no-ops on one device and are dropped.
"""
from __future__ import annotations

import math

import torch

__all__ = ["dense_init", "dense", "norm_init", "apply_norm", "embed_init",
           "embed_lookup", "unembed"]


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


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32) -> dict:
    w = torch.randn((vocab, d_model), dtype=torch.float32, device=gen.device,
                    generator=gen)
    return {"w": (w * (1.0 / math.sqrt(d_model))).to(dtype)}


def embed_lookup(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [...] int -> [..., d]: a plain gather (the JAX package's
    one-hot matmul exists only under multi-device sharding rules)."""
    return params["w"][tokens]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x [..., d] -> f32 logits [..., V].

    A bf16 table on the card goes through one bf16 GEMM with an f32 output
    (`torch.mm(..., out_dtype=torch.float32)`): the product accumulates in
    f32, as the JAX package's `preferred_element_type=f32` asks, and the
    [V, d] table is neither copied nor cast per call -- the cost is that of
    the bf16 product alone.  Elsewhere (f32 tables, CPU tensors) both
    operands are taken in f32.
    """
    w = params["w"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if w.is_cuda and w.dtype in (torch.bfloat16, torch.float16) \
            and x2.dtype == w.dtype:
        logits = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        logits = torch.mm(x2.to(torch.float32), w.to(torch.float32).t())
    return logits.reshape(*lead, w.shape[0])
