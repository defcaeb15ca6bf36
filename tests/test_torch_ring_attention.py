"""The port's ring attention (``vqgan_tpu_torch/ops/ring_attention.py``) on
the CPU: gloo ranks under torchrun against JAX ``ring_attention`` under
``shard_map`` on as many host devices, and against dense attention.

One torchrun launch of tests/torch_dp_worker.py (4 ranks, one thread each)
runs the ring over every rank and over the pairs (0, 1) and (2, 3), each
rank holding its contiguous block of the global (B, N, H, D) q, k, v, with
the cotangent's block for the backward, in fp32 and bf16. The ring's blocks
concatenated in rank order are the forward and dq, dk, dv of the whole
sequence: in fp32 within 1e-5 (relative, plus 1e-6 of the largest entry)
of the JAX ring and of dense attention; in bf16 within kernel #3's stated
bounds (``ops/attention.py::rounding_bounds``, one bf16 ulp of each output
beside them) of the chunked plain version of one rank over the whole
sequence, which the CPU runs for kernel #3.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from vqgan_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from vqgan_tpu_torch.ops import ring_attention as ring
from vqgan_tpu_torch.ops.attention import (
    chunked_attention_backward,
    chunked_attention_forward,
    dense_attention,
    rounding_bounds,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
RANKS = 4
B, N, H, D = 2, 48, 2, 16
CHUNK = 6  # divides every rank's block at 2 and 4 ranks
RTOL = 1e-5
# kernel #3's fp32 summation-order allowance (chip_smoke.ATTN_RTOL)
ATTN_RTOL = 3e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    rng = np.random.RandomState(0)
    spec = {"ring": {name: rng.randn(B, N, H, D).astype(np.float32)
                     for name in ("q", "k", "v", "g")},
            "mesh": {"data": 1, "context": RANKS}}
    spec["ring"]["chunk"] = CHUNK
    path = os.path.join(str(tmp), "spec.pt")
    torch.save(spec, path)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(RANKS), WORKER, path, str(tmp)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-5000:]
    outs = [torch.load(os.path.join(str(tmp), f"rank{r}.pt"), weights_only=False)["ring"]
            for r in range(RANKS)]
    return spec["ring"], outs


def _joined(outs: list, n: int, dtype: str) -> dict:
    """The ring of ``n`` ranks (ranks 0..n-1) joined along the tokens."""
    return {k: torch.cat([outs[r][(n, dtype)][k] for r in range(n)], dim=1)
            for k in ("out", "dq", "dk", "dv")}


def _jax_ring(spec: dict, n: int) -> dict:
    mesh = Mesh(np.array(jax.devices()[:n]), ("context",))
    spec_p = P(None, "context", None, None)
    fn = jax.shard_map(lambda q, k, v: jax_ring_attention(q, k, v, "context"), mesh=mesh,
                       in_specs=(spec_p,) * 3, out_specs=spec_p)
    q, k, v, g = (jnp.asarray(spec[name]) for name in ("q", "k", "v", "g"))
    out, vjp = jax.vjp(fn, q, k, v)
    dq, dk, dv = vjp(g)
    return {name: torch.from_numpy(np.asarray(t))
            for name, t in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv))}


def _dense(spec: dict) -> dict:
    q, k, v = (torch.from_numpy(spec[name]).requires_grad_(True) for name in ("q", "k", "v"))
    out = dense_attention(q, k, v)
    out.backward(torch.from_numpy(spec["g"]))
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def _close(got: dict, want: dict, what: str) -> None:
    for name in ("out", "dq", "dk", "dv"):
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=RTOL,
                                   atol=1e-6 * scale, err_msg=f"{what} {name}")


@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_ring_attention(ranks, n):
    """fp32 at n ranks: the forward and dq, dk, dv against JAX
    ``ring_attention`` under ``shard_map`` over n host devices."""
    spec, outs = ranks
    _close(_joined(outs, n, "float32"), _jax_ring(spec, n), f"JAX ring, {n} ranks")


@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_dense_attention(ranks, n):
    """fp32 at n ranks: exact attention over the whole sequence."""
    spec, outs = ranks
    _close(_joined(outs, n, "float32"), _dense(spec), f"dense, {n} ranks")


def test_ring_of_the_pairs_is_each_pairs_own(ranks):
    """The pair (2, 3) rings over its own blocks: the same halves as the
    pair (0, 1), bit for bit (the two pairs run the same arithmetic)."""
    _, outs = ranks
    for dtype in ("float32", "bfloat16"):
        for r in (0, 1):
            for name in ("out", "dq", "dk", "dv"):
                assert torch.equal(outs[r][(2, dtype)][name], outs[r + 2][(2, dtype)][name])


@pytest.mark.parametrize("n", [2, 4])
def test_ring_bf16_within_kernel_bounds(ranks, n):
    """bf16 at n ranks against one rank's chunked plain version over the
    whole sequence in bf16 (the CPU's kernel #3): each output within
    ``rounding_bounds`` at ATTN_RTOL with bf16 products, doubled (both
    sides round), plus one bf16 ulp of the value for the final cast (the
    ring's partials of out and of dq, dk, dv stay fp32 until then)."""
    spec, outs = ranks
    got = _joined(outs, n, "bfloat16")
    q, k, v, g = (torch.from_numpy(spec[name]).to(torch.bfloat16)
                  for name in ("q", "k", "v", "g"))
    out, lse = chunked_attention_forward(q, k, v, CHUNK)
    dq, dk, dv = chunked_attention_backward(q, k, v, out, lse, g, CHUNK)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2)
    bounds = rounding_bounds(q, k, v, lse, ATTN_RTOL, True, g, delta)
    for name, want in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv)):
        tol = 2 * bounds[name] + 2.0 ** -7 * want.float().abs() + 1e-7
        err = (got[name] - want.float()).abs()
        assert bool((err <= tol).all()), (name, float((err / tol).max()))


@pytest.mark.parametrize("what", ["forward", "backward"])
def test_fp32_outputs_are_the_sums_before_the_cast(what):
    """A bf16 call with fp32 outputs (the ring's partials) gives the plain
    version's fp32 sums before the cast: cast to bf16 they are the bf16
    call's outputs bit for bit, and they hold what the cast drops."""
    from vqgan_tpu_torch.ops.attention_cuda import attention_backward, attention_forward

    rng = np.random.RandomState(2)
    q, k, v, g = (torch.from_numpy(rng.randn(1, 12, 2, 16).astype(np.float32)).to(torch.bfloat16)
                  for _ in range(4))
    out, lse = attention_forward(q, k, v, 4)
    if what == "forward":
        wide, wide_lse = attention_forward(q, k, v, 4, out_dtype=torch.float32)
        assert torch.equal(wide_lse, lse)
        pairs = [(wide, out)]
    else:
        pairs = list(zip(attention_backward(q, k, v, out, lse, g, 4, grad_dtype=torch.float32),
                         attention_backward(q, k, v, out, lse, g, 4)))
    for wide, narrow in pairs:
        assert wide.dtype == torch.float32 and narrow.dtype == torch.bfloat16
        assert torch.equal(wide.to(torch.bfloat16), narrow)
        assert not torch.equal(wide, narrow.float())


def test_merge_is_attention_over_the_union():
    """Merging two key blocks' (out, lse) by logsumexp gives the attention
    over both blocks (fp32, one process)."""
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(1, 8, 2, 16).astype(np.float32)) for _ in range(3))
    q = q[:, :4]
    out = lse = None
    for s in (slice(0, 4), slice(4, 8)):
        out, lse = ring.merge(out, lse, *chunked_attention_forward(q, k[:, s], v[:, s], 4))
    np.testing.assert_allclose(out.numpy(), dense_attention(q, k, v).numpy(), rtol=1e-5,
                               atol=1e-6)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * 16 ** -0.5
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(scores, -1).numpy(), rtol=1e-6)
