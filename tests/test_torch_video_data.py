"""The port's clip reader (``vqgan_tpu_torch/data/video.py``) against the
JAX package's (``vqgan_tpu/data/video.py``), on the CPU: ``decode_clip`` on
``.npy``, ``.npz``, non-uint8 and wrong-rank members; ``video_transform``
for train (with a per-call rng and with the shared one) and eval, a looped
short clip among them; ``create_video_dataloader`` on a tar of clips with
one worker, unshuffled and shuffled, bit for bit, and ``close()`` stopping
its workers."""

import io
import shutil
import tarfile
import threading
import time

import numpy as np
import pytest

from vqgan_tpu.data import video as jax_video
from vqgan_tpu_torch.data import video


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _npz(*arrs) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, *arrs)
    return buf.getvalue()


def _clip(rng, t=6, h=20, w=24):
    return rng.randint(0, 256, (t, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("case", ["npy", "npz", "npz_empty", "float", "int16", "rank3",
                                  "gray", "garbage"])
def test_decode_clip_matches_jax(case):
    rng = np.random.RandomState(0)
    clip = _clip(rng)
    data = {
        "npy": _npy(clip),
        "npz": _npz(clip, _clip(rng, 2)),  # the first entry
        "npz_empty": _npz(),
        "float": _npy(clip.astype(np.float32) / 255.0),
        "int16": _npy(clip.astype(np.int16) * 2),
        "rank3": _npy(clip[0]),
        "gray": _npy(clip[..., :1]),
        "garbage": b"not a clip",
    }[case]
    ours, theirs = video.decode_clip(data), jax_video.decode_clip(data)
    if case in ("npy", "npz"):
        assert ours.dtype == np.uint8 and ours.shape == clip.shape
        np.testing.assert_array_equal(ours, clip)
        np.testing.assert_array_equal(ours, theirs)
    else:
        assert ours is None and theirs is None


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("t", [3, 9, 16])
def test_video_transform_matches_jax(train, t):
    """T = 3 loops the clip to 6 frames; 9 and 16 window it. 40x52 frames to
    16 px: stride 2, then a center crop."""
    clip = _clip(np.random.RandomState(t), t, 40, 52)
    ours = video.video_transform(5, 16, train=train, seed=3)
    theirs = jax_video.video_transform(5, 16, train=train, seed=3)
    assert ours.accepts_rng
    for i in range(3):  # the shared rng, draw after draw
        a, b = ours(clip), theirs(clip)
        assert a.shape == (5, 16, 16, 3) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    a = ours(clip, rng=np.random.default_rng(11))
    np.testing.assert_array_equal(a, theirs(clip, rng=np.random.default_rng(11)))
    assert -1.0 <= a.min() and a.max() <= 1.0
    with pytest.raises(ValueError, match="smaller than target"):
        ours(clip[:, :10])


@pytest.fixture(scope="module")
def clip_shard(tmp_path_factory):
    """One tar of 7 clips (24 x 20 x 24; five .npy, two .npz) and a member
    that is not a clip."""
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.RandomState(1)
    path = str(root / "00000.tar")
    with tarfile.open(path, "w") as tf:
        for i in range(7):
            clip = _clip(rng, 24, 20, 24)
            data, name = (_npz(clip), f"{i:03d}.npz") if i % 3 == 2 else (_npy(clip),
                                                                          f"{i:03d}.npy")
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        info = tarfile.TarInfo("readme.txt")
        info.size = 5
        tf.addfile(info, io.BytesIO(b"hello"))
    return path


def test_create_video_dataloader_matches_jax(clip_shard):
    """One worker, one pass: eval (unshuffled, center windows) and train
    (the shuffle buffer and random windows, from the same seed) give the
    JAX loader's batches bit for bit; the stream logs its decoder."""
    kw = dict(num_workers=1, seed=5, loop=False, process_index=0, process_count=1)
    for shuffle in (False, True):
        ours = video.create_video_dataloader(clip_shard, 2, 8, 16, do_shuffle=shuffle, **kw)
        theirs = jax_video.create_video_dataloader(clip_shard, 2, 8, 16, do_shuffle=shuffle,
                                                   **kw)
        assert ours.stream.decoders == ("decode_clip",)
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == 3  # 7 clips: 3 whole batches of 2
        for x, y in zip(a, b):
            assert x.dtype == np.float32 and x.shape[1:] == (8, 16, 16, 3)
            np.testing.assert_array_equal(x, y)


def test_close_stops_the_workers(clip_shard):
    """A looping stream of 2 workers (one shard each) gives one batch; after
    ``close()`` its worker threads are gone."""
    shutil.copy(clip_shard, clip_shard.replace("00000", "00001"))
    before = threading.active_count()
    src = video.create_video_dataloader(clip_shard.replace("00000", "{00000..00001}"), 2, 4,
                                        16, num_workers=2, seed=0)
    batch = next(src)
    assert batch.shape == (2, 4, 16, 16, 3)
    assert threading.active_count() == before + 2
    src.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
