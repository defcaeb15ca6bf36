"""The port's host data path and logger against the JAX package's, on the
CPU: the synthetic loader and the transforms bit for bit, the streaming
``TarImageStream`` and the indexed ``IndexedTarDataset.batch_at`` on a tiny
PNG tar shard that the test writes (PNG is lossless, so cv2 and PIL decode
it alike), the device feed, the readers' refusal without an image decoder,
and ``MetricLogger``'s JSONL lines and PNG grids.
"""

import io
import json
import os
import sys
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from vqgan_tpu.data import indexed as jax_indexed
from vqgan_tpu.data import synthetic as jax_synthetic
from vqgan_tpu.data import tar_stream as jax_tar_stream
from vqgan_tpu.data import transforms as jax_transforms
from vqgan_tpu.utils.logging import MetricLogger as JaxMetricLogger
from vqgan_tpu_torch.data import indexed, synthetic, tar_stream, transforms
from vqgan_tpu_torch.data.loader import create_dataloader, device_prefetch
from vqgan_tpu_torch.utils.logging import MetricLogger, write_png

SIZES = [(48, 64), (80, 40), (24, 30), (64, 64), (33, 95), (70, 70)]


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in SIZES]


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """Two tar shards of PNG images (and a non-image member), written with
    the port's PNG writer."""
    root = tmp_path_factory.mktemp("shards")
    imgs = _images()
    paths = []
    for s in range(2):
        path = str(root / f"{s:05d}.tar")
        with tarfile.open(path, "w") as tf:
            for i, img in enumerate(imgs[s * 3:(s + 1) * 3]):
                png = str(root / f"{s}_{i}.png")
                write_png(png, img)
                tf.add(png, arcname=f"sample{s}{i}.png")
            info = tarfile.TarInfo("sample.json")
            data = b"{}"
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        paths.append(path)
    return str(root / "{00000..00001}.tar"), paths, imgs


@pytest.mark.parametrize("seed,batch,size", [(0, 2, 32), (5, 3, 48)])
def test_synthetic_loader_matches_jax(seed, batch, size):
    ours = synthetic.synthetic_dataloader(batch, size, seed=seed)
    theirs = jax_synthetic.synthetic_dataloader(batch, size, seed=seed)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("as_uint8", [False, True])
def test_transforms_match_jax(as_uint8):
    """Train: each sample's crop-or-resize coin and offsets from a given rng
    (the indexed path's) and from the shared seeded rng; eval: center crop
    512 then resize, down (INTER_AREA) and up (INTER_LINEAR)."""
    imgs = _images(1)
    ours = transforms.make_train_transform(32, seed=3, as_uint8=as_uint8)
    theirs = jax_transforms.make_train_transform(32, seed=3, as_uint8=as_uint8)
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(ours(img), theirs(img))
        np.testing.assert_array_equal(ours(img, rng=np.random.default_rng(i)),
                                      theirs(img, rng=np.random.default_rng(i)))
    for width in (32, 96):
        ours_e = transforms.make_eval_transform(width, as_uint8=as_uint8)
        theirs_e = jax_transforms.make_eval_transform(width, as_uint8=as_uint8)
        for img in imgs + [np.random.RandomState(2).randint(0, 256, (600, 520, 3), np.uint8)]:
            a, b = ours_e(img), theirs_e(img)
            assert a.dtype == (np.uint8 if as_uint8 else np.float32)
            np.testing.assert_array_equal(a, b)


def test_shard_helpers_match_jax():
    url = "/data/train-{00008..00012}.tar"
    assert tar_stream.expand_braces(url) == jax_tar_stream.expand_braces(url)
    assert tar_stream.expand_braces("a.tar") == ["a.tar"]
    shards = tar_stream.expand_braces(url)
    for p in range(3):
        assert tar_stream.split_shards(shards, p, 3) == jax_tar_stream.split_shards(shards, p, 3)


def test_tar_stream_matches_jax(shard):
    """The streaming reader in order (no shuffle, one worker, one pass):
    the same batches bit for bit, the non-image member skipped, the decoder
    stated. With the shuffle buffer, the same samples."""
    url, paths, _ = shard
    kw = dict(batch_size=2, num_workers=1, do_shuffle=False, loop=False)
    ours = tar_stream.TarImageStream(paths, transforms.make_eval_transform(40, as_uint8=True),
                                     **kw)
    theirs = jax_tar_stream.TarImageStream(
        paths, jax_transforms.make_eval_transform(40, as_uint8=True), **kw)
    assert ours.decoders == ("cv2", "PIL")
    a, b = list(ours), list(theirs)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x.shape == (2, 40, 40, 3) and x.dtype == np.uint8
        np.testing.assert_array_equal(x, y)
    shuffled = create_dataloader(url, 2, num_workers=2, just_resize=True, width=40,
                                 seed=1, loop=False, device_normalize=True)
    got = sorted(s.tobytes() for batch in shuffled for s in batch)
    assert got == sorted(s.tobytes() for batch in a for s in batch)


def test_indexed_batch_at_matches_jax(shard):
    """Position-addressed batches with the train transform's per-position
    rng: every step bit for bit, across the epoch boundary, with 2 workers."""
    url, paths, _ = shard
    ours = create_dataloader(url, 4, num_workers=2, width=32, seed=7, device_normalize=True,
                             indexed=True, start_step=1)
    theirs = jax_indexed.IndexedTarDataset(
        paths, jax_transforms.make_train_transform(32, 7, as_uint8=True), global_batch=4,
        seed=7, start_step=1, num_workers=2)
    assert isinstance(ours, indexed.IndexedTarDataset) and len(ours) == 6
    for step in range(4):
        np.testing.assert_array_equal(ours.batch_at(step), theirs.batch_at(step))
    first = next(iter(ours))
    np.testing.assert_array_equal(first, theirs.batch_at(1))


def test_readers_raise_without_an_image_decoder(shard, monkeypatch):
    """With neither cv2 nor PIL importable, the readers and the transforms
    raise at construction and name what is missing (the JAX reader would
    drop every sample and wait)."""
    url, paths, _ = shard
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="cv2.*PIL"):
        tar_stream.image_decoders()
    with pytest.raises(RuntimeError, match="no image decoder"):
        tar_stream.TarImageStream(paths, lambda img: img, batch_size=2)
    with pytest.raises(RuntimeError, match="no image decoder"):
        indexed.IndexedTarDataset(paths, lambda img: img, global_batch=2)
    with pytest.raises(ImportError, match="cv2"):
        transforms.make_train_transform(32)
    with pytest.raises(ImportError, match="cv2"):
        create_dataloader(url, 2)


def test_device_prefetch_keeps_order_and_dtype():
    batches = [np.full((2, 4, 4, 3), i, np.uint8) for i in range(5)]
    out = list(device_prefetch(iter(batches), "cpu", depth=3))
    assert len(out) == 5
    for i, t in enumerate(out):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8
        assert t.device.type == "cpu" and int(t[0, 0, 0, 0]) == i


def _lines(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def test_metric_logger_matches_jax(tmp_path):
    """The same JSONL lines (the ``_config`` header, then the finite scalars
    of each log call; non-finite and non-numeric values dropped) and PNG
    grids that decode to the same pixels."""
    config = {"ch": 32, "ch_mult": [1, 2], "reg_type": "gaussian"}
    rows = [({"a": 1.5, "b": np.float32(2.0), "c": float("nan"), "d": "text",
              "e": torch.tensor(3.25)}, 0),
            ({"eval/lpips": 0.25, "eval/psnr": np.float64(21.0)}, 4)]
    grid = np.random.RandomState(3).uniform(-0.2, 1.2, (20, 36, 3)).astype(np.float32)
    loggers = {}
    for name, cls in (("port", MetricLogger), ("jax", JaxMetricLogger)):
        out = str(tmp_path / name)
        lg = cls("r", "p", config=config, use_wandb=False, out_dir=out)
        for metrics, step in rows:
            lg.log(metrics, step)
        lg.log_images({"grid": grid}, 4, os.path.join(out, "eval"))
        lg.close()
        loggers[name] = out
    port, ref = (_lines(os.path.join(loggers[n], "metrics_r.jsonl")) for n in ("port", "jax"))
    assert port[0]["_config"] == ref[0]["_config"] == config
    assert port[1:] == ref[1:]
    assert port[1] == {"step": 0, "a": 1.5, "b": 2.0, "e": 3.25}
    a, b = (np.asarray(Image.open(os.path.join(loggers[n], "eval", "grid_step4.png")))
            for n in ("port", "jax"))
    assert a.dtype == np.uint8 and a.shape == (20, 36, 3)
    np.testing.assert_array_equal(a, b)


def test_write_png_refuses_other_arrays(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.uint8))
