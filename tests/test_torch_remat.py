"""Rematerialization (``remat``, ``remat_policy``) in the port's models, on
the CPU.

A region recomputes in the backward what it did not keep, with the same ops
on the same inputs, so on the CPU the loss and every gradient are bitwise
those without remat, under both policies: for the 2D VAE of the HDR recipe's
kind (wavelet + HR) and for the tiny TVAE. The "conv" policy keeps every conv
output of its regions, so its backward runs no conv forward again, where
"full" runs some; the parameter names do not change (checkpoints carry
over); an unknown policy raises ValueError when remat is on, as the JAX
package's ``remat_with_policy``; without autograd a model with remat is a
plain forward.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vqgan_tpu_torch.config import TVAEConfig, VAEConfig
from vqgan_tpu_torch.models import ae, tae

WAVELET_HR = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
                  use_wavelet=True, decoder_also_perform_hr=True, reg_type="gaussian",
                  enc_dtype="float32", dec_dtype="float32")
TVAE_TINY = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
                 compute_dtype="float32", conv3d_impl="direct")
POLICIES = [(False, "full"), (True, "full"), (True, "conv")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops in one thread: beside the other test workers, a
    tiny model's ops spend far longer waiting for threads than computing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class ConvCount(TorchDispatchMode):
    """Counts ``aten.convolution`` calls (the forward convs) while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _run_2d(remat, policy):
    model = ae.init_vae(VAEConfig(**WAVELET_HR, remat=remat, remat_policy=policy),
                        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(2, 32, 32, 3, generator=gen) * 2 - 1
    proj = torch.randn(2, 64, 64, 3, generator=gen)
    eps = torch.randn(2, 16, 16, 8, generator=gen)
    z = model.encode(x)
    dec = model.decode(model.regularize(z, eps=eps))
    loss = (dec * proj).mean() + 0.1 * z.square().mean()
    with ConvCount() as count:
        loss.backward()
    return model, loss.detach(), count.n


def _run_3d(remat, policy):
    model = tae.init_tvae(TVAEConfig(**TVAE_TINY, remat=remat, remat_policy=policy),
                          torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(2, 4, 16, 16, 3, generator=gen) * 2 - 1
    z = model.encode(x)
    mean = z.chunk(2, dim=-1)[0]
    loss = (model.decode(mean).float() - x).square().mean() + 0.1 * z.square().mean()
    with ConvCount() as count:
        loss.backward()
    return model, loss.detach(), count.n


@pytest.mark.parametrize("run", [_run_2d, _run_3d], ids=["vae_wavelet_hr", "tvae"])
def test_remat_is_bitwise_the_plain_step(run):
    out = {(r, p): run(r, p) for r, p in POLICIES}
    ref_model, ref_loss, plain_convs = out[(False, "full")]
    ref = dict(ref_model.named_parameters())
    assert plain_convs == 0  # no region: the backward runs no forward conv
    for key in POLICIES[1:]:
        model, loss, _ = out[key]
        assert torch.equal(loss, ref_loss), key
        params = dict(model.named_parameters())
        assert set(params) == set(ref)  # the same names: checkpoints carry over
        for name, p in params.items():
            assert torch.equal(p.grad, ref[name].grad), (key, name)
    # "full" recomputes the regions' convs; "conv" keeps each conv output
    assert out[(True, "full")][2] > 0
    assert out[(True, "conv")][2] == 0


@pytest.mark.parametrize("cfg", [VAEConfig(**WAVELET_HR), TVAEConfig(**TVAE_TINY)],
                         ids=["vae", "tvae"])
def test_bad_remat_policy_raises(cfg):
    build = ae.VAE if isinstance(cfg, VAEConfig) else tae.TVAE
    with pytest.raises(ValueError, match="remat_policy"):
        build(type(cfg)(**{**cfg.__dict__, "remat": True, "remat_policy": "dots"}))
    build(type(cfg)(**{**cfg.__dict__, "remat": False, "remat_policy": "dots"}))


def test_remat_under_no_grad_is_the_plain_forward():
    """Serving: no autograd, no region; the output is bitwise the plain
    model's."""
    plain = ae.init_vae(VAEConfig(**WAVELET_HR), torch.Generator().manual_seed(0))
    remat = ae.init_vae(VAEConfig(**WAVELET_HR, remat=True, remat_policy="conv"),
                        torch.Generator().manual_seed(0))
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), ConvCount() as count:
        a = plain.decode(plain.encode(x)[..., :8])
        n_plain = count.n
        b = remat.decode(remat.encode(x)[..., :8])
    assert torch.equal(a, b)
    assert count.n == 2 * n_plain
