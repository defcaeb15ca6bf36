"""The serving kernels' operators (``vqgan_tpu_torch/ops/custom_ops.py``) on
the CPU: ``torch.library.opcheck`` on each (schema, fake implementation
against the real one, dispatch under ``torch.compile``'s AOT path with
dynamic shapes), the CPU implementation equal to the plain version, and the
checks that stay with the implementations.

``gn_forward`` at 4-D and 5-D channels-last inputs, fp32 and bf16, with and
without swish; ``attention_forward`` on q, k and v as strided views of one
qkv tensor, as the AttnBlock hands them over; ``nearest_codes`` with a
ragged N.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from vqgan_tpu_torch.ops import custom_ops
from vqgan_tpu_torch.ops.attention import chunked_attention_forward
from vqgan_tpu_torch.ops.normalization import group_norm_fp32_forward
from vqgan_tpu_torch.ops.vq import nearest_codes_plain


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gn_inputs(shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    fmt = torch.channels_last if len(shape) == 4 else torch.channels_last_3d
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dtype).contiguous(memory_format=fmt)
    w = 1 + 0.5 * torch.randn(c, generator=gen)
    b = 0.5 * torch.randn(c, generator=gen)
    return x, w, b


GN_CASES = [((2, 64, 8, 8), torch.float32, True), ((2, 64, 8, 8), torch.bfloat16, False),
            ((2, 64, 3, 4, 4), torch.float32, False), ((1, 96, 2, 4, 4), torch.bfloat16, True)]


@pytest.mark.parametrize("shape,dtype,swish", GN_CASES)
def test_gn_forward_opcheck(shape, dtype, swish):
    x, w, b = _gn_inputs(shape, dtype)
    torch.library.opcheck(custom_ops.gn_forward, (x, w, b, 32, 1e-6, swish))
    y, stats = custom_ops.gn_forward(x, w, b, 32, 1e-6, swish)
    ref, mean, rstd = group_norm_fp32_forward(x, w, b, 32, 1e-6, swish)
    assert y.dtype == dtype and y.stride() == ref.stride() and torch.equal(y, ref)
    assert torch.equal(stats, torch.stack((mean, rstd), dim=1))


def test_gn_forward_checks_what_arrives():
    """The CPU implementation refuses an NCHW input and a wrong dtype, as
    the CUDA one does; the fake checks the operands but not the layout,
    which a traced convolution's fake output may not tell."""
    x, w, b = _gn_inputs((2, 64, 8, 8), torch.float32)
    with pytest.raises(ValueError, match="channels_last"):
        custom_ops.gn_forward(x.contiguous(), w, b, 32, 1e-6, False)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        custom_ops.gn_forward(x.double(), w, b, 32, 1e-6, False)
    nchw = x.contiguous()
    with FakeTensorMode() as mode:
        fx, fw, fb = (mode.from_tensor(t) for t in (nchw, w, b))
        y, stats = custom_ops.gn_forward(fx, fw, fb, 32, 1e-6, False)
        assert y.is_contiguous(memory_format=torch.channels_last)
        assert tuple(stats.shape) == (2, 2, 32) and stats.dtype == torch.float32
        with pytest.raises(ValueError, match="divisible"):
            custom_ops.gn_forward(fx, fw, fb, 48, 1e-6, False)


def _qkv_views(b, n, heads, d, dtype, seed=0):
    """q, k, v as the AttnBlock makes them: views of one (B, N, 3C) tensor."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen).to(dtype)
    return qkv.reshape(b, n, 3, heads, d).unbind(2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_forward_opcheck_on_strided_views(dtype):
    q, k, v = _qkv_views(2, 64, 2, 16, dtype)
    assert not q.is_contiguous() and q.stride(1) == 3 * 2 * 16
    torch.library.opcheck(custom_ops.attention_forward, (q, k, v, 16))
    out, lse = custom_ops.attention_forward(q, k, v, 16)
    ref, ref_lse = chunked_attention_forward(q, k, v, 16)
    assert out.is_contiguous() and out.dtype == dtype
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


def test_attention_forward_refuses_mismatched_inputs():
    q, k, v = _qkv_views(1, 32, 2, 16, torch.float32)
    with pytest.raises(ValueError, match="does not match"):
        custom_ops.attention_forward(q, k[:, :16], v, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        custom_ops.attention_forward(q.double(), k.double(), v.double(), 16)


@pytest.mark.parametrize("n,k,d", [(300, 64, 8), (1, 7, 16)])
def test_nearest_codes_opcheck(n, k, d):
    rng = np.random.RandomState(n)
    z = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    cb = torch.from_numpy(rng.randn(k, d).astype(np.float32))
    torch.library.opcheck(custom_ops.nearest_codes, (z, cb))
    codes = custom_ops.nearest_codes(z, cb)
    assert codes.dtype == torch.int32 and torch.equal(codes, nearest_codes_plain(z, cb))
    with pytest.raises(ValueError, match="does not match"):
        custom_ops.nearest_codes(z, cb[:, :1].contiguous())
