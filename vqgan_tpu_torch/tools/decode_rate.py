"""The 2D train transform's images/s on one host thread: the native C++
pipeline (``data/native``) beside the cv2 decode and ``make_train_transform``.

    python -m vqgan_tpu_torch.tools.decode_rate [--size 512] [--iters 30] [--rounds 3]

Encodes one seeded 700x600 image as a JPEG (quality 90, blurred so it
compresses as a photo does) and as a PNG, then times, with cv2 held to one
thread, ``make_native_train_transform(size)`` on the bytes and the cv2
route (``cv2.imdecode``, BGR to RGB, ``make_train_transform(size)``): both
decode, random-crop at ``size`` and normalize to float32. The two run in
turn, ``rounds`` times ``iters`` calls each, and the median round counts.
Needs no card; where the native library does not build, prints its error
and the cv2 rates alone. Prints the host's CPU model, a line a format and
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import platform
import sys
import time

import numpy as np


def test_images(seed: int = 7) -> dict[str, bytes]:
    """One seeded 700x600 RGB image as PNG bytes (noise, incompressible)
    and JPEG bytes (blurred, quality 90)."""
    import cv2

    img = np.random.default_rng(seed).integers(0, 256, (600, 700, 3), dtype=np.uint8)
    png = cv2.imencode(".png", img[..., ::-1])[1].tobytes()
    jpeg = cv2.imencode(".jpg", cv2.GaussianBlur(img, (7, 7), 3)[..., ::-1],
                        [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
    return {"jpeg": jpeg, "png": png}


def decode_rates(size: int = 512, iters: int = 30, rounds: int = 3) -> dict:
    """{(format, "native" | "cv2"): images/s}, the median of ``rounds``
    rounds of ``iters`` calls on one thread; no "native" keys where the
    library does not build."""
    import cv2

    from vqgan_tpu_torch.data import native
    from vqgan_tpu_torch.data.transforms import (
        make_native_train_transform,
        make_train_transform,
    )

    threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    rates = {}
    try:
        for name, data in test_images().items():
            plain = make_train_transform(size, seed=0)

            def via_cv2(data=data, plain=plain):
                arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
                return plain(np.ascontiguousarray(arr[..., ::-1]))

            fns = {"cv2": via_cv2}
            if native.native_available():
                ours = make_native_train_transform(size, seed=0)
                fns["native"] = lambda data=data, ours=ours: ours(data)
            per_round = {label: [] for label in fns}
            for fn in fns.values():
                fn()
            for _ in range(rounds):
                for label, fn in fns.items():
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        fn()
                    per_round[label].append(iters / (time.perf_counter() - t0))
            for label, r in per_round.items():
                rates[(name, label)] = float(np.median(r))
    finally:
        cv2.setNumThreads(threads)
    return rates


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    from vqgan_tpu_torch.data import native

    built = native.native_available()
    print(f"host CPU: {cpu_model()}; native decoder "
          f"{'built' if built else f'unavailable: {native.build_error}'}")
    rates = decode_rates(args.size, args.iters, args.rounds)
    for name in ("jpeg", "png"):
        print(f"{name} 700x600 -> {args.size} px, one thread: "
              + ", ".join(f"{label} {rates[(name, label)]:.2f} images/s"
                          for label in ("native", "cv2") if (name, label) in rates))
    print(json.dumps({"size": args.size, "native_built": built,
                      "rates": {f"{n}/{lbl}": v for (n, lbl), v in rates.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
