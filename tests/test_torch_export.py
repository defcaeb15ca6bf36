"""The serving export (``vqgan_tpu_torch/export.py``) on the CPU: artifacts
traced at a tiny width, loaded back and held against the JAX package's
pipelines and the port's own, as ``tests/test_export.py`` holds the JAX
artifacts: the pipeline's outputs, one artifact at batches 1, 3 and 5, the
manifest, the Gaussian mean, VQ by code distance, the TVAE round trip, its
geometry check and VQ, uint8 input, the CLI from a ``.pt`` and from a port
trainer's run directory, and a loaded artifact that imports no model code.

The JAX params come from ``jax.eval_shape`` filled by numpy
(``torch_parity.randomize_params``) and reach the port through
``weights.jax_params_to_state_dict``; three JAX pipelines in all (identity,
VQ, TVAE), each built once. The JAX GroupNorm is its XLA form here
(``use_pallas_gn`` off): the Pallas one is held against the port in
``test_torch_inference.py``. On the CPU every operator of an artifact runs
its plain version, so the artifact and the port's pipeline agree to
rounding noise (EXPORT_ATOL, as ``chip_smoke.py`` phase 35 holds them on the
card).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.config import TVAEConfig as JaxTVAEConfig
from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.inference import TVAEPipeline as JaxTVAEPipeline
from vqgan_tpu.inference import VAEPipeline as JaxVAEPipeline
from vqgan_tpu.models.ae import VAE as JaxVAE
from vqgan_tpu.models.tae import TVAE as JaxTVAE
from vqgan_tpu_torch.config import TrainConfig, TVAEConfig, VAEConfig
from vqgan_tpu_torch.export import (
    ExportedTVAE,
    ExportedVAE,
    _load_export_weights,
    _main,
    export_tvae,
    export_vae,
)
from vqgan_tpu_torch.inference import TVAEPipeline, VAEPipeline
from vqgan_tpu_torch.weights import jax_params_to_state_dict, save_weights

from test_torch_inference import ATOL_FP32, MAX_BF16_DEC, MEAN_BF16_DEC
from torch_parity import distance_gap, randomize_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8)
ARCH_FLAGS = ["--vae_ch", "32", "--vae_ch_mult", "1,2", "--vae_num_res_blocks", "1",
              "--vae_z_channels", "8", "--vae_resolution", "16"]
# the artifact against the port's pipeline on the same device: the same ops
# on the same inputs
EXPORT_ATOL = 1e-6
VQ_K = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops in one thread, as the other port test files run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params(model, x_shape, seed):
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(seed),
                                         "sample": jax.random.PRNGKey(seed)},
                            jnp.zeros(x_shape))
    return randomize_params(shapes["params"], seed)


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 16, 16, 3), np.uint8)


def _clips(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 4, 16, 16, 3), np.uint8)


def _err(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b)


@pytest.fixture(scope="module")
def vae(tmp_path_factory):
    """The identity VAE (fp32 encoder, bf16 decoder): JAX params, the
    port's state dict, a reference-format .pt, the JAX pipeline, and the
    artifact the CLI writes from the .pt."""
    cfg = VAEConfig(**TINY)
    params = _jax_params(JaxVAE(cfg=JaxVAEConfig(**TINY)), (1, 16, 16, 3), 0)
    sd = jax_params_to_state_dict(params)
    tmp = tmp_path_factory.mktemp("vae")
    path = str(tmp / "vae.pt")
    save_weights(sd, path)
    out = str(tmp / "artifact")
    _main(["--checkpoint", path, "--out_dir", out, "--device", "cpu", *ARCH_FLAGS])
    jax_pipe = JaxVAEPipeline(JaxVAEConfig(**TINY),
                              jax.tree_util.tree_map(jnp.asarray, params))
    return dict(cfg=cfg, sd=sd, path=path, out=out, jax=jax_pipe,
                port=VAEPipeline(cfg, sd, device="cpu"), art=ExportedVAE.load(out))


def test_artifact_matches_the_jax_pipeline(vae):
    """Written by the CLI from a .pt: encode within the fp32 bound of JAX's,
    decode and reconstruct within the bf16 decoder's bounds, and both within
    EXPORT_ATOL of the port's pipeline."""
    art = vae["art"]
    assert art.device == torch.device("cpu")
    imgs = _images(2)
    z = art.encode(imgs)
    assert z.dtype == torch.float32 and tuple(z.shape) == (2, 8, 8, 8)
    z_ref = np.asarray(vae["jax"].encode(imgs))
    assert _err(z, z_ref).max() <= ATOL_FP32
    assert _err(z, vae["port"].encode(imgs)).max() <= EXPORT_ATOL
    dec = art.decode(z_ref)
    assert dec.dtype == np.float32 and dec.min() >= 0.0 and dec.max() <= 1.0
    for got, ref in ((dec, vae["jax"].decode(z_ref)),
                     (art.reconstruct(imgs), vae["jax"].reconstruct(imgs))):
        err = _err(got, ref)
        assert err.max() <= MAX_BF16_DEC and err.mean() <= MEAN_BF16_DEC, (err.max(), err.mean())
    assert _err(dec, vae["port"].decode(z_ref)).max() <= EXPORT_ATOL


@pytest.mark.parametrize("batch", [1, 3, 5])
def test_one_artifact_serves_any_batch(vae, batch):
    """The batch is symbolic: the artifact traced at batch 2 serves 1, 3 and
    5, clamped to ±8, equal to the port's pipeline at that batch."""
    art = vae["art"]
    imgs = _images(batch, seed=batch)
    z = art.encode(imgs)
    assert tuple(z.shape) == (batch, 8, 8, 8) and float(z.abs().max()) <= 8.0
    recon = art.decode(z)
    assert recon.shape == (batch, 16, 16, 3) and recon.min() >= 0.0 and recon.max() <= 1.0
    assert _err(z, vae["port"].encode(imgs)).max() <= EXPORT_ATOL
    assert _err(art.reconstruct(imgs), vae["port"].reconstruct(imgs)).max() <= EXPORT_ATOL


def test_manifest_keys(vae):
    """The JAX manifest's keys (``vqgan_tpu/export.py``), with the port's
    format, ``torch_version`` for ``jax_version`` and ``device`` for
    ``platforms``."""
    with open(os.path.join(vae["out"], "manifest.json")) as f:
        m = json.load(f)
    assert set(m) == {"format", "torch_version", "device", "vae_config", "reg_type",
                      "do_clamp", "clamp_th", "encode_input", "encode_output", "decode_input",
                      "decode_output", "io_dtype", "image_range_in", "image_range_out"}
    assert m["format"] == "vqgan_tpu_torch.export/v1"
    assert m["torch_version"] == torch.__version__ and m["device"] == "cpu"
    assert m["vae_config"] == json.loads(json.dumps(dataclasses.asdict(
        dataclasses.replace(vae["cfg"], vq_ema_decay=0.0, upsample_impl="direct"))))
    assert m["encode_input"] == ["b", 16, 16, 3] and m["encode_output"] == ["b", 8, 8, 8]
    assert m["decode_input"] == ["b", 8, 8, 8] and m["decode_output"] == ["b", 16, 16, 3]
    assert (m["reg_type"], m["do_clamp"], m["clamp_th"]) == ("identity_gaussian", True, 8.0)
    with pytest.raises(ValueError, match="format"):
        ExportedTVAE.load(vae["out"])


def test_uint8_float_and_single_inputs(vae):
    """uint8 [0, 255] and float [-1, 1] give the same latents; one image
    gains a batch dimension."""
    art = vae["art"]
    imgs = _images(2, seed=7)
    z = art.encode(imgs)
    assert torch.equal(art.encode(imgs.astype(np.float32) / 127.5 - 1.0), z)
    one = art.encode(imgs[0])
    assert tuple(one.shape) == (1, 8, 8, 8)
    assert _err(one[0], vae["port"].encode(imgs[0])[0]).max() <= EXPORT_ATOL


def test_gaussian_artifact_takes_the_mean(tmp_path):
    """reg_type "gaussian": encode returns the mean half of the encoder's
    2·z_channels. ``use_pallas_gn`` exports (the JAX export refuses it)."""
    cfg = VAEConfig(**TINY, reg_type="gaussian", use_pallas_gn=True)
    params = _jax_params(JaxVAE(cfg=JaxVAEConfig(**TINY, reg_type="gaussian")),
                         (1, 16, 16, 3), 2)
    sd = jax_params_to_state_dict(params)
    export_vae(cfg, sd, str(tmp_path), device="cpu")
    art = ExportedVAE.load(str(tmp_path))
    imgs = _images(1, seed=2)
    z = art.encode(imgs)
    assert tuple(z.shape) == (1, 8, 8, 8)
    port = VAEPipeline(cfg, sd, device="cpu")
    with torch.no_grad():
        moments = port.model.encode(port._to_model_input(imgs)).clamp(-8, 8)
    assert moments.shape[-1] == 16
    assert _err(z, moments[..., :8]).max() <= EXPORT_ATOL


@pytest.fixture(scope="module")
def vq_params():
    cfg = JaxVAEConfig(**TINY, reg_type="vq", vq_codebook_size=VQ_K, vq_ema_decay=0.0)
    params = _jax_params(JaxVAE(cfg=cfg), (1, 16, 16, 3), 4)
    # codes at the latents' scale, so the search has near neighbours to choose from
    params["reg"]["codebook"] = (
        0.5 * np.random.RandomState(4).randn(VQ_K, 8)).astype(np.float32)
    return cfg, params


def test_vq_artifact_by_code_distance(tmp_path, vq_params):
    """The VQ artifact's latents are codebook rows, its codes those of JAX's
    pipeline up to fp32 near-ties (``test_torch_inference.py``'s bound),
    and it equals the port's pipeline."""
    jax_cfg, params = vq_params
    cfg = VAEConfig(**TINY, reg_type="vq", vq_codebook_size=VQ_K, vq_ema_decay=0.0)
    sd = jax_params_to_state_dict(params)
    export_vae(cfg, sd, str(tmp_path), device="cpu")
    art = ExportedVAE.load(str(tmp_path))
    assert art.manifest["reg_type"] == "vq"
    jax_pipe = JaxVAEPipeline(jax_cfg, jax.tree_util.tree_map(jnp.asarray, params))
    port = VAEPipeline(cfg, sd, device="cpu")
    imgs = _images(2, seed=4)
    z = art.encode(imgs).numpy().reshape(-1, 8)
    z_ref = np.asarray(jax_pipe.encode(imgs)).reshape(-1, 8)
    cb = params["reg"]["codebook"]
    codes, ref = (np.argmin(((lat[:, None] - cb[None]) ** 2).sum(-1), axis=1)
                  for lat in (z, z_ref))
    np.testing.assert_allclose(z, cb[codes], atol=1e-6)
    with torch.no_grad():
        z_pre = port.model.encode(port._to_model_input(imgs)).clamp(-8, 8).numpy()
    gap, tol = distance_gap(z_pre.reshape(-1, 8), cb, codes, ref)
    shift = 2 * np.sqrt(8) * ATOL_FP32 * np.linalg.norm(cb[codes] - cb[ref], axis=-1)
    assert (gap <= tol + shift).all()
    assert (codes == ref).mean() >= 0.99
    assert _err(art.encode(imgs), port.encode(imgs)).max() <= EXPORT_ATOL
    assert _err(art.reconstruct(imgs), port.reconstruct(imgs)).max() <= EXPORT_ATOL


@pytest.fixture(scope="module")
def tvae_params():
    cfg = JaxTVAEConfig(**TINY, compute_dtype="float32")
    return _jax_params(JaxTVAE(cfg=cfg), (1, 4, 16, 16, 3), 0)


def test_tvae_artifact_matches_the_jax_pipeline(tmp_path, tvae_params):
    """The TVAE artifact (fp32) at batches 1 and 2 against JAX's
    ``TVAEPipeline``: the posterior mean within ATOL_FP32, the decode
    within it too; ``conv3d_impl`` pinned to "direct" in the manifest."""
    cfg = TVAEConfig(**TINY, compute_dtype="float32", conv3d_impl="pallas")
    sd = jax_params_to_state_dict(tvae_params)
    export_tvae(cfg, sd, str(tmp_path), frames=4, device="cpu")
    art = ExportedTVAE.load(str(tmp_path))
    m = art.manifest
    assert m["format"] == "vqgan_tpu_torch.export/v1-video"
    assert m["tvae_config"]["conv3d_impl"] == "direct"
    assert m["encode_input"] == ["b", 4, 16, 16, 3] and m["encode_output"] == ["b", 2, 8, 8, 8]
    jax_pipe = JaxTVAEPipeline(JaxTVAEConfig(**TINY, compute_dtype="float32"),
                               jax.tree_util.tree_map(jnp.asarray, tvae_params))
    for b in (1, 2):
        clips = _clips(b, seed=b)
        z = art.encode(clips)
        assert tuple(z.shape) == (b, 2, 8, 8, 8)
        z_ref = np.asarray(jax_pipe.encode(clips).astype(jnp.float32))
        assert _err(z, z_ref).max() <= ATOL_FP32
        recon = art.decode(z_ref)
        assert recon.shape == (b, 4, 16, 16, 3) and recon.min() >= 0.0 and recon.max() <= 1.0
        assert _err(recon, jax_pipe.decode(jnp.asarray(z_ref))).max() <= ATOL_FP32
        assert _err(art.reconstruct(clips), jax_pipe.reconstruct(clips)).max() <= ATOL_FP32


def test_tvae_rejects_bad_geometry(tmp_path):
    with pytest.raises(ValueError, match="frames"):
        export_tvae(TVAEConfig(**TINY), {}, str(tmp_path), frames=3, device="cpu")
    with pytest.raises(TypeError, match="TVAEConfig"):
        export_tvae(VAEConfig(**TINY), {}, str(tmp_path), frames=4, device="cpu")


def test_tvae_vq_artifact(tmp_path):
    """A VQ TVAE: every latent a codebook row, equal to the port's pipeline
    (bf16 compute, the default)."""
    cfg = TVAEConfig(**TINY, reg_type="vq", vq_codebook_size=VQ_K, vq_ema_decay=0.0)
    params = _jax_params(JaxTVAE(cfg=JaxTVAEConfig(**TINY, reg_type="vq",
                                                   vq_codebook_size=VQ_K, vq_ema_decay=0.0)),
                         (1, 4, 16, 16, 3), 9)
    sd = jax_params_to_state_dict(params)
    export_tvae(cfg, sd, str(tmp_path), frames=4, device="cpu")
    art = ExportedTVAE.load(str(tmp_path))
    clips = _clips(1, seed=9)
    z = art.encode(clips)
    cb = sd["reg.codebook"].to(torch.bfloat16).float().numpy()
    flat = z.numpy().reshape(-1, 8)
    assert float(((flat[:, None] - cb[None]) ** 2).sum(-1).min(axis=1).max()) == 0.0
    port = TVAEPipeline(cfg, sd, device="cpu")
    assert _err(z, port.encode(clips)).max() <= EXPORT_ATOL
    assert _err(art.reconstruct(clips), port.reconstruct(clips)).max() <= EXPORT_ATOL


def test_cli_from_a_trainer_run_directory(tmp_path):
    """``--checkpoint`` a port trainer's run directory: the latest step's
    full state, taken down to G's parameters; the artifact serves them."""
    from vqgan_tpu_torch.train.trainer import Trainer

    vae_cfg = VAEConfig(**TINY, enc_dtype="float32", dec_dtype="float32")
    cfg = TrainConfig(synthetic_data=True, batch_size=2, image_size=16, max_steps=2,
                      num_epochs=1, evaluate_every_n_steps=0, use_wandb=False,
                      ckpt_dir=str(tmp_path / "ckpt"), run_name="r", log_every=1,
                      warmup_steps=1, learning_rate_vae=0.032)
    trainer = Trainer(cfg, vae_cfg, device="cpu")
    trainer.train()
    run_dir = str(tmp_path / "ckpt" / "r")
    sd = _load_export_weights(run_dir)
    assert torch.equal(sd["encoder.conv_in.weight"],
                       trainer.state.g_model.state_dict()["encoder.conv_in.weight"].cpu())
    out = str(tmp_path / "artifact")
    _main(["--checkpoint", run_dir, "--out_dir", out, "--device", "cpu", *ARCH_FLAGS])
    art = ExportedVAE.load(out)
    port = VAEPipeline(dataclasses.replace(vae_cfg, dec_dtype="bfloat16"), sd, device="cpu")
    imgs = _images(2, seed=11)
    assert _err(art.reconstruct(imgs), port.reconstruct(imgs)).max() <= EXPORT_ATOL


def test_a_loaded_artifact_imports_no_model_code(vae):
    """A fresh process loads and calls the artifact: no module of
    ``vqgan_tpu_torch.models`` and no JAX is imported."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from vqgan_tpu_torch.export import ExportedVAE\n"
        f"art = ExportedVAE.load({vae['out']!r})\n"
        "out = art.reconstruct(np.zeros((2, 16, 16, 3), np.uint8))\n"
        "assert out.shape == (2, 16, 16, 3), out.shape\n"
        "bad = [m for m in sys.modules if m.startswith('vqgan_tpu_torch.models') or\n"
        "       m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vqgan_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_the_card_without_one_raises(vae, tmp_path, monkeypatch):
    """Asking for the card where there is none raises, to export or to load:
    nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        export_vae(vae["cfg"], vae["sd"], str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        ExportedVAE.load(vae["out"], device="cuda")


def test_export_where_fake_convolutions_lose_channels_last(vae, tmp_path, monkeypatch):
    """Under a symbolic batch, torch 2.11's fake convolution gives NCHW
    strides where the real output is channels-last (this torch does so when
    a shape has no hint, which the patch makes of every symbolic one). The
    trace must not refuse the GroupNorm operator for strides that the run
    will not have, and the artifact must still equal the pipeline."""
    from torch.fx.experimental import symbolic_shapes

    monkeypatch.setattr(symbolic_shapes, "has_guarding_hint",
                        lambda s: not isinstance(s, torch.SymInt))
    export_vae(vae["cfg"], vae["sd"], str(tmp_path), device="cpu")
    monkeypatch.undo()
    art = ExportedVAE.load(str(tmp_path))
    imgs = _images(3, seed=13)
    assert _err(art.reconstruct(imgs), vae["port"].reconstruct(imgs)).max() <= EXPORT_ATOL
