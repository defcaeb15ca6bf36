"""Exact non-causal attention over (B, N, H, D) tensors: the plain PyTorch
versions (counterparts of ``vqgan_tpu/ops/chunked_attention.py`` and of
``jax.nn.dot_product_attention``) and the dispatch the AttnBlock calls.

``chunked_attention_forward`` and ``chunked_attention_backward`` are kernel
#3's plain versions (``csrc/attention.cu``): a CPU tensor runs them, and the
card tests hold the kernel against them. They scan k/v in chunks with an
online softmax, in fp32 throughout, so no more than (B, H, N, chunk) scores
exist at once; the backward recomputes the probabilities from the per-query
logsumexp, the only O(N) residual beside q, k, v and out.

``dense_attention`` is the AttnBlock's path for ``attn_chunk=0`` or a token
count within the chunk, as the JAX package computes it outside any Pallas
kernel: plain PyTorch, differentiated by autograd.
"""

from __future__ import annotations

import torch

IMPLS = ("auto", "pallas", "lax")


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, N, H, D) → (B, H, N, D) fp32."""
    return t.float().transpose(1, 2)


def _check_chunk(n: int, chunk: int) -> None:
    if chunk <= 0 or n % chunk:
        raise ValueError(f"chunk_size {chunk} must divide the token count {n}")


def chunked_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunk: int,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: out (B, N, H, D) in q's dtype (or ``out_dtype``), lse
    the fp32 (B, H, N) per-query logsumexp of the scaled scores. Scale D^-½;
    q is scaled before the products, as in the JAX ``_forward``."""
    b, n, h, d = q.shape
    _check_chunk(n, chunk)
    qf = _heads_first(q) * d ** -0.5
    o = torch.zeros_like(qf)
    m = torch.full(qf.shape[:-1], float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    for j in range(0, n, chunk):
        kb = _heads_first(k[:, j:j + chunk])
        vb = _heads_first(v[:, j:j + chunk])
        s = qf @ kb.transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + p @ vb
        m = m_new
    out = (o / l[..., None]).transpose(1, 2).to(out_dtype or q.dtype)
    return out, m + torch.log(l)


def chunked_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    chunk: int,
    grad_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` for the incoming gradient g of out, in q's, k's and
    v's dtypes (or ``grad_dtype``) (the JAX ``_bwd_rule``): delta = Σ dO·O
    in fp32 from out as stored, and P = exp(S − lse) recomputed chunk by
    chunk."""
    b, n, h, d = q.shape
    _check_chunk(n, chunk)
    scale = d ** -0.5
    qf = _heads_first(q)  # unscaled
    do = _heads_first(g)
    delta = (do * _heads_first(out)).sum(dim=-1)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j in range(0, n, chunk):
        kb = _heads_first(k[:, j:j + chunk])
        vb = _heads_first(v[:, j:j + chunk])
        s = (qf @ kb.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[..., None])
        dvs.append(p.transpose(-1, -2) @ do)
        dp = do @ vb.transpose(-1, -2)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + ds @ kb
        dks.append(ds.transpose(-1, -2) @ qf)
    return (dq.transpose(1, 2).to(grad_dtype or q.dtype),
            torch.cat(dks, dim=2).transpose(1, 2).to(grad_dtype or k.dtype),
            torch.cat(dvs, dim=2).transpose(1, 2).to(grad_dtype or v.dtype))


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax(Q·Kᵀ·D^-½)·V over (B, N, H, D), as ``jax.nn.dot_product_attention``
    computes it without a kernel: the logits accumulate in fp32 from the
    input dtype, the softmax is fp32, and the probabilities are cast to v's
    dtype before P·V, so the output has v's dtype. Differentiable."""
    d = q.shape[-1]
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * d ** -0.5
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def memory_efficient_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunk: int, impl: str = "auto"
) -> torch.Tensor:
    """Exact attention with O(N·D) residuals over (B, N, H, D), through the
    ``FlashAttention`` autograd Function: a CUDA tensor runs kernel #3
    forward and backward, a CPU tensor the chunked plain versions with k/v
    chunks of ``chunk`` tokens. ``impl`` keeps the JAX package's values and
    has no other effect (``VAEConfig`` says why)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    from vqgan_tpu_torch.ops.attention_cuda import FlashAttention

    return FlashAttention.apply(q, k, v, chunk)


def rounding_bounds(q, k, v, lse, rtol: float, with_bf16_products: bool, g=None, delta=None):
    """Per-entry bounds on how far kernel #3 may lie from the plain versions
    on the same inputs, for the card checks: ``{"out": ...}``, and with the
    gradient g of out and its delta = Σ g·out (B, H, N) also ``"dq"``,
    ``"dk"`` and ``"dv"``, each of its output's shape. Each output is a sum
    of products; two fp32 evaluations in other orders differ by at most
    ``rtol`` of Σ|terms|, and where the kernel rounds one factor to bf16 as
    the Pallas kernel does (P before P·V and before dV, dS before dK and dQ)
    by 2^-9 of Σ|terms| more. Σ|terms| is formed from P = exp(S − lse), |dS|
    ≤ P·(|dO|·|V|ᵀ + |delta|)·scale and the inputs' magnitudes, a block of
    queries at a time (~256 MB of fp32 scores each)."""
    b, n, h, d = q.shape
    scale = d ** -0.5
    c = rtol + (2.0 ** -9 if with_bf16_products else 0.0)
    qf, kf, vf = (_heads_first(t) for t in (q, k, v))
    ka, va = kf.abs(), vf.abs()
    terms = {"out": torch.empty_like(qf)}
    if g is not None:
        gf = _heads_first(g)
        terms.update(dq=torch.empty_like(qf), dk=torch.zeros_like(qf), dv=torch.zeros_like(qf))
    step = max(1, (1 << 26) // (b * h * n))
    for i in range(0, n, step):
        rows = slice(i, i + step)
        p = torch.exp((qf[:, :, rows] @ kf.transpose(-1, -2)) * scale - lse[:, :, rows, None])
        terms["out"][:, :, rows] = p @ va
        if g is None:
            continue
        ga = gf[:, :, rows].abs()
        terms["dv"] += p.transpose(-1, -2) @ ga
        ds = p.mul_((ga @ va.transpose(-1, -2)).add_(delta[:, :, rows, None].abs())).mul_(scale)
        terms["dq"][:, :, rows] = ds @ ka
        terms["dk"] += ds.transpose(-1, -2) @ qf[:, :, rows].abs()
    return {name: (c * t).transpose(1, 2) for name, t in terms.items()}
