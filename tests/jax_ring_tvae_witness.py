"""Witnesses of the JAX package's ring TVAE at ``data=2,context=2`` on host
devices (ROADMAP.md, Queue 3): not a test, a script that prints them.

    python tests/jax_ring_tvae_witness.py

For two seeds, the tiny TVAE of tests/test_torch_context.py (ch 32, ch_mult
1,2, 2 clips of 4 frames at 16 px, fp32) as JAX ``TVAE(mesh,
ring_axis="context")`` at ``data=1,context=2``, ``data=2,context=1`` and
``data=2,context=2``, with ``x`` and the loss weight left unplaced and
placed by ``batch_sharding(mesh, 5)``, against the same TVAE on one device:
the decoded clip's and the latent's largest error, and of the parameter
gradients of Σ y·w_y + Σ z·w_z the worst leaf's error over its largest
entry (floored at 1e-4 of the largest gradient), the three worst leaves,
and the whole gradient's length over the one-device one. Then
``AttnBlock3D`` alone on the same meshes against itself on one device: dx
and its parameters' gradients. Runs on the CPU in about two minutes.
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from torch_parity import randomize_params  # noqa: E402
from vqgan_tpu.config import TVAEConfig  # noqa: E402
from vqgan_tpu.models.tae import TVAE, AttnBlock3D  # noqa: E402
from vqgan_tpu.parallel.mesh import batch_sharding, create_mesh  # noqa: E402

TINY = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
            compute_dtype="float32", conv3d_impl="direct")
B, T, R = 2, 4, 16
SHAPES = ({"data": 1, "context": 2}, {"data": 2, "context": 1}, {"data": 2, "context": 2})


def mesh_of(shape):
    return create_mesh(shape, devices=jax.devices()[:shape["data"] * shape["context"]])


def tvae_run(model, params, x, wy, wz):
    def loss(p):
        z = model.apply({"params": p}, x, method=model.encode)
        y = model.apply({"params": p}, z[..., :z.shape[-1] // 2], method=model.decode)
        return (y * wy).sum() + (z * wz).sum(), (y, z)

    (_, (y, z)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(y), np.asarray(z), jax.tree_util.tree_map(np.asarray, g)


def report(tag, got, want):
    (y, z, g), (y0, z0, g0) = got, want
    leaves = jax.tree_util.tree_leaves_with_path(g0)
    gl, gl0 = jax.tree_util.tree_leaves(g), [v for _, v in leaves]
    gmax = max(float(np.abs(v).max()) for v in gl0)
    rel = sorted(((float(np.abs(a - b).max() / (np.abs(b).max() + 1e-4 * gmax)),
                   jax.tree_util.keystr(p)) for a, b, (p, _) in zip(gl, gl0, leaves)),
                 reverse=True)
    a, b = (np.concatenate([v.ravel() for v in vs]) for vs in (gl, gl0))
    print(f"{tag}: y err {np.abs(y - y0).max():.3e} (|y| {np.abs(y0).max():.2f}), z err "
          f"{np.abs(z - z0).max():.3e}; gradients: worst leaf {rel[0][0]:.3e}, |g|/|g0| "
          f"{np.linalg.norm(a) / np.linalg.norm(b):.4f}; worst "
          + ", ".join(f"{p} {r:.2e}" for r, p in rel[:3]), flush=True)


def tvae_witness(seed):
    rng = np.random.RandomState(7 + seed)
    one = TVAE(cfg=TVAEConfig(**TINY))
    keys = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)}
    params = randomize_params(
        jax.eval_shape(one.init, keys, jnp.zeros((1, T, R, R, 3)))["params"], seed)
    x = jnp.asarray(rng.uniform(-1, 1, (B, T, R, R, 3)).astype(np.float32))
    wy = jnp.asarray(rng.randn(B, T, R, R, 3).astype(np.float32))
    wz = jnp.asarray(rng.randn(B, T // 2, R // 2, R // 2, 2 * TINY["z_channels"])
                     .astype(np.float32))
    want = tvae_run(one, params, x, wy, wz)
    for shape in SHAPES:
        mesh = mesh_of(shape)
        model = TVAE(cfg=TVAEConfig(**TINY), mesh=mesh, ring_axis="context")
        report(f"TVAE seed {seed} {shape}, x unplaced", tvae_run(model, params, x, wy, wz), want)
        placed = [jax.device_put(t, batch_sharding(mesh, 5)) for t in (x, wy)]
        report(f"TVAE seed {seed} {shape}, x and w_y by batch_sharding",
               tvae_run(model, params, *placed, wz), want)


def block_witness(seed):
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(B, 2, 4, 4, 64).astype(np.float32))
    w = jnp.asarray(rng.randn(B, 2, 4, 4, 64).astype(np.float32))
    one = AttnBlock3D()
    params = one.init(jax.random.PRNGKey(seed), x)["params"]

    def run(model):
        f = lambda p, x_: (model.apply({"params": p}, x_) * w).sum()  # noqa: E731
        return jax.jit(jax.grad(f, argnums=(0, 1)))(params, x)

    gp0, gx0 = run(one)
    for shape in SHAPES:
        gp, gx = run(AttnBlock3D(mesh=mesh_of(shape), ring_axis="context"))
        worst = max(float(jnp.abs(a - b).max() / jnp.abs(b).max()) for a, b in
                    zip(jax.tree_util.tree_leaves(gp), jax.tree_util.tree_leaves(gp0)))
        print(f"AttnBlock3D seed {seed} {shape}: dx err {float(jnp.abs(gx - gx0).max()):.2e} "
              f"(|dx| {float(jnp.abs(gx0).max()):.2f}); its parameters' gradients, worst leaf "
              f"{worst:.2e}", flush=True)


if __name__ == "__main__":
    for s in (0, 1):
        tvae_witness(s)
    for s in (0, 1):
        block_witness(s)
