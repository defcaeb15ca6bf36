"""Plain PyTorch fp32 GroupNorm (+ optional fused swish), forward and backward.

The counterpart of ``vqgan_tpu/ops/normalization.py`` (``_forward``) and of
the Pallas backward ``vqgan_tpu/ops/pallas/groupnorm.py::_pallas_gn_bwd``, in
the same channel-coefficient form:

    mean, var = E[x], E[x²] − mean²      per (batch, group), in fp32
    rstd = rsqrt(var + eps)
    ŷ = x · A_c + B_c ,  A = rstd·γ ,  B = β − mean·A
    y = ŷ · sigmoid(ŷ)                    when with_swish, else y = ŷ

cast back to the input's dtype. Channel c belongs to group c // (C / G), as
in torch's GroupNorm. The backward, from the input x, the incoming gradient g
and the per-(batch, group) mean and rstd:

    dŷ = g·σ(ŷ)·(1 + ŷ·(1 − σ(ŷ)))       in fp32 (with swish), else dŷ = g
    S0 = Σ_spatial dŷ ,  S1 = Σ_spatial dŷ·x                  per (batch, channel)
    dγ = Σ_batch r·(S1 − μ·S0) ,  dβ = Σ_batch S0
    m1 = Σ_group γ·S0 / n ,  m2 = r·Σ_group γ·S1 / n − μ·r·Σ_group γ·S0 / n
                                      (n = spatial size · channels per group)
    dx = dŷ·(rγ)_c + x·(−r²·m2)_c + (μ·r²·m2 − r·m1)_c

dŷ stays in fp32, as in the Pallas backward; the JAX package's XLA backward
rounds it to the input's dtype first (``vqgan_tpu/ops/normalization.py``,
``_group_norm_bwd``), which differs from this form by bf16 rounding only.

These are the references the CUDA kernels (``ops/groupnorm_cuda.py``) are
held against, and the path a tensor on the CPU takes. On the card a CUDA
tensor goes through the kernels.
"""

from __future__ import annotations

import torch


def _check_groups(c: int, num_groups: int) -> None:
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")


def group_norm_fp32_forward(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    with_swish: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GroupNorm(+swish) over x of shape (B, C, *spatial) with fp32
    statistics and arithmetic. Returns ``(y, mean, rstd)``: y in x's dtype and
    memory layout (a channels_last input gives a channels_last output), mean
    and rstd fp32 (B, G)."""
    b, c = x.shape[0], x.shape[1]
    _check_groups(c, num_groups)
    cg = c // num_groups
    xf = x.float().movedim(1, -1)  # (B, *spatial, C)
    xg = xf.reshape(b, -1, num_groups, cg)
    mean = xg.mean(dim=(1, 3))  # (B, G)
    var = xg.square().mean(dim=(1, 3)) - mean.square()
    rstd = torch.rsqrt(var + eps)
    a = rstd.repeat_interleave(cg, dim=-1) * weight.float()  # (B, C)
    bb = bias.float() - mean.repeat_interleave(cg, dim=-1) * a
    shape = (b,) + (1,) * (x.ndim - 2) + (c,)
    y = xf * a.view(shape) + bb.view(shape)
    if with_swish:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).movedim(-1, 1), mean, rstd


def group_norm_fp32(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    with_swish: bool = False,
) -> torch.Tensor:
    """The output of ``group_norm_fp32_forward`` alone."""
    return group_norm_fp32_forward(x, weight, bias, num_groups, eps, with_swish)[0]


def group_norm_fp32_backward(
    x: torch.Tensor,
    g: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    with_swish: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dγ, dβ) of GroupNorm(+swish) at x of shape (B, C, *spatial) for
    the incoming gradient g (same shape), given the forward's fp32 (B, G)
    mean and rstd. dx has x's dtype and memory layout; dγ and dβ are fp32."""
    b, c = x.shape[0], x.shape[1]
    _check_groups(c, num_groups)
    cg = c // num_groups
    xf = x.float().movedim(1, -1).reshape(b, -1, c)  # (B, S, C)
    gf = g.float().movedim(1, -1).reshape(b, -1, c)
    n_group = xf.shape[1] * cg
    r_c = rstd.repeat_interleave(cg, dim=-1)  # (B, C)
    m_c = mean.repeat_interleave(cg, dim=-1)
    scale = weight.float()[None, :]
    if with_swish:
        a = r_c * scale
        bb = bias.float()[None, :] - m_c * a
        y_hat = xf * a[:, None, :] + bb[:, None, :]
        sig = torch.sigmoid(y_hat)
        dy = gf * sig * (1.0 + y_hat * (1.0 - sig))
    else:
        dy = gf
    s0 = dy.sum(dim=1)  # (B, C)
    s1 = (dy * xf).sum(dim=1)

    d_scale = (r_c * (s1 - m_c * s0)).sum(dim=0)
    d_bias = s0.sum(dim=0)

    g_s0 = (scale * s0).reshape(b, num_groups, cg).sum(dim=-1)  # (B, G)
    g_s1 = (scale * s1).reshape(b, num_groups, cg).sum(dim=-1)
    m1 = g_s0 / n_group
    m2 = rstd * (g_s1 / n_group) - mean * rstd * (g_s0 / n_group)
    m1_c = m1.repeat_interleave(cg, dim=-1)
    m2_c = m2.repeat_interleave(cg, dim=-1)
    ca = r_c * scale
    cb = -r_c * r_c * m2_c
    cc = m_c * r_c * r_c * m2_c - r_c * m1_c
    dx = dy * ca[:, None, :] + xf * cb[:, None, :] + cc[:, None, :]
    dx = dx.to(x.dtype).reshape((b,) + tuple(x.shape[2:]) + (c,)).movedim(-1, 1)
    return dx, d_scale, d_bias


# ---------------------------------------------------------------------------
# The two-pass form, for a GroupNorm whose rows are split over ranks (the
# context axis: a clip's frames in blocks, ``parallel/context.py``): each
# rank's partial sums, which the caller sums across the ranks between the
# passes, then the normalisation; and the same seam backward. The plain
# versions of kernels #1's and #2's two-pass launches
# (``ops/groupnorm_cuda.py``), in the same coefficient form as above:
#
#   forward  sums (B, 2, G): Σx, Σx² of this rank's rows per (batch, group)
#            stats (B, 2, G): mean = Σx/n, rstd = rsqrt(Σx²/n − mean² + eps),
#            n the group's elements over every rank
#            y = x·A + B (+ swish) from the stats
#   backward gsums (B, 2, G): Σ γ·dŷ, Σ γ·dŷ·x̂ of this rank's rows (x̂ =
#            (x − mean)·rstd), and this rank's dγ = Σ dŷ·x̂, dβ = Σ dŷ
#            dx = dŷ·(rγ) + x·(−r²·m2) + (μ·r²·m2 − r·m1), m1 = Σγ·dŷ / n,
#            m2 = Σγ·dŷ·x̂ / n from the gsums summed over the ranks

def _grouped(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """(B, C, *spatial) → fp32 (B, S, G, C/G)."""
    b, c = x.shape[0], x.shape[1]
    _check_groups(c, num_groups)
    return x.float().movedim(1, -1).reshape(b, -1, num_groups, c // num_groups)


def group_norm_partial_sums(x: torch.Tensor, num_groups: int = 32) -> torch.Tensor:
    """fp32 (B, 2, G): Σx and Σx² of x's rows per (batch, group)."""
    xg = _grouped(x, num_groups)
    return torch.stack([xg.sum(dim=(1, 3)), xg.square().sum(dim=(1, 3))], dim=1)


def group_norm_stats_from_sums(sums: torch.Tensor, count: int, eps: float = 1e-6
                               ) -> torch.Tensor:
    """(B, 2, G) mean and rstd from the summed (B, 2, G) Σx, Σx² over
    ``count`` elements a group, as the one-pass forward forms them."""
    mean = sums[:, 0] / count
    var = sums[:, 1] / count - mean.square()
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=1)


def _coefficients(stats, weight, bias, c: int, num_groups: int):
    cg = c // num_groups
    mean_c = stats[:, 0].repeat_interleave(cg, dim=-1)  # (B, C)
    rstd_c = stats[:, 1].repeat_interleave(cg, dim=-1)
    a = rstd_c * weight.float()
    return mean_c, rstd_c, a, bias.float() - mean_c * a


def group_norm_apply(x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, num_groups: int = 32,
                     with_swish: bool = False) -> torch.Tensor:
    """y = x·A + B (+ swish) in x's dtype and layout from the (B, 2, G)
    mean and rstd."""
    b, c = x.shape[0], x.shape[1]
    _, _, a, bb = _coefficients(stats, weight, bias, c, num_groups)
    shape = (b,) + (1,) * (x.ndim - 2) + (c,)
    y = x.float().movedim(1, -1) * a.view(shape) + bb.view(shape)
    if with_swish:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).movedim(-1, 1)


def _d_yhat(xf, gf, a, bb, with_swish: bool):
    """dL/dŷ in fp32 from (B, S, C) x and g, the swish's ŷ recomputed."""
    if not with_swish:
        return gf
    y_hat = xf * a[:, None, :] + bb[:, None, :]
    sig = torch.sigmoid(y_hat)
    return gf * sig * (1.0 + y_hat * (1.0 - sig))


def group_norm_backward_partial(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                                weight: torch.Tensor, bias: torch.Tensor,
                                num_groups: int = 32, with_swish: bool = False
                                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(gsums, dγ, dβ)`` of x's rows: gsums the fp32 (B, 2, G) Σγ·dŷ and
    Σγ·dŷ·x̂, dγ = Σ dŷ·x̂ and dβ = Σ dŷ fp32 (C,)."""
    b, c = x.shape[0], x.shape[1]
    cg = c // num_groups
    mean_c, rstd_c, a, bb = _coefficients(stats, weight, bias, c, num_groups)
    xf = x.float().movedim(1, -1).reshape(b, -1, c)
    dy = _d_yhat(xf, g.float().movedim(1, -1).reshape(b, -1, c), a, bb, with_swish)
    x_hat = (xf - mean_c[:, None, :]) * rstd_c[:, None, :]
    s0 = dy.sum(dim=1)  # (B, C)
    s1 = (dy * x_hat).sum(dim=1)
    scale = weight.float()[None, :]
    gsums = torch.stack([(scale * s0).reshape(b, num_groups, cg).sum(-1),
                         (scale * s1).reshape(b, num_groups, cg).sum(-1)], dim=1)
    return gsums, s1.sum(dim=0), s0.sum(dim=0)


def group_norm_backward_dx(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                           gsums: torch.Tensor, count: int, weight: torch.Tensor,
                           bias: torch.Tensor, num_groups: int = 32,
                           with_swish: bool = False) -> torch.Tensor:
    """dx in x's dtype and layout from the summed (B, 2, G) gsums over
    ``count`` elements a group."""
    b, c = x.shape[0], x.shape[1]
    cg = c // num_groups
    mean_c, rstd_c, a, bb = _coefficients(stats, weight, bias, c, num_groups)
    xf = x.float().movedim(1, -1).reshape(b, -1, c)
    dy = _d_yhat(xf, g.float().movedim(1, -1).reshape(b, -1, c), a, bb, with_swish)
    m1 = (gsums[:, 0] / count).repeat_interleave(cg, dim=-1)
    m2 = (gsums[:, 1] / count).repeat_interleave(cg, dim=-1)
    r2m2 = rstd_c * rstd_c * m2
    ca, cb, cc = rstd_c * weight.float()[None, :], -r2m2, mean_c * r2m2 - rstd_c * m1
    dx = dy * ca[:, None, :] + xf * cb[:, None, :] + cc[:, None, :]
    return dx.to(x.dtype).reshape((b,) + tuple(x.shape[2:]) + (c,)).movedim(-1, 1)
