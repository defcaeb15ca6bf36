"""The flagship training job's wall time a step, its loader's share and a
save's parts, on the card.

    python -m vqgan_tpu_torch.tools.time_job

Runs ``vqgan_tpu_torch.cli.main`` at the flagship width (``JOB``, the flags
of ``chip_smoke.py``'s ``TRAIN_JOB``: ch 256, ch_mult 1,2,4,4, batch 8 from
512 px synthetic images, the sampled Gaussian, hinge GAN + LeCam, full bf16)
for 12 steps with eval off, once with ``--log_every 1`` and once with 5, the
CLI's default (a logged step fetches its metrics, a sync). Adds no sync to
the loop. Prints, for each run: the job's wall time a step by the host clock
(the mean interval between consecutive calls of the step after the first
two), the
step's device time between CUDA events recorded around each call, the
loader's time to make a batch (``next`` of the train loader, on the loop's
thread), and the final save's parts: the call to ``Trainer.save`` that the
loop waits for (the host copy of the state), and the background
write of the reference ``.pt`` and the state's file that the loop's last
``wait`` joins. Then the card's name and power limit, and one JSON line.
Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

JOB = ["--vae_ch", "256", "--vae_ch_mult", "1,2,4,4", "--vae_num_res_blocks", "2",
       "--vae_z_channels", "16", "--vae_resolution", "256", "--batch_size", "8",
       "--image_size", "512", "--synthetic_data", "true", "--do_ganloss",
       "--disc_type", "hinge", "--use_lecam", "true", "--full_bf16", "true",
       "--reg_type", "gaussian", "--evaluate_every_n_steps", "0", "--use_wandb", "false"]
STEPS = 12


@contextlib.contextmanager
def instrumented(record: dict):
    """Times the step calls, the train loader's batches and the save's parts
    into ``record`` while active."""
    from vqgan_tpu_torch.train import checkpoint as ckpt_mod
    from vqgan_tpu_torch.train import trainer as trainer_mod

    real_make, real_loader = trainer_mod.make_train_step, trainer_mod.Trainer._make_loader
    real_save, real_wait = trainer_mod.Trainer.save, ckpt_mod.CheckpointManager.wait

    def make(*args, **kw):
        step = real_make(*args, **kw)

        def timed(state, batch, *rest):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            record["calls"].append(time.perf_counter())
            start.record()
            out = step(state, batch, *rest)
            end.record()
            record["events"].append((start, end))
            return out
        return timed

    def loader(self, train):
        it = real_loader(self, train)
        if not train:
            return it

        def timed_batches():
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                record["batch_s"].append(time.perf_counter() - t0)
                yield batch
        return timed_batches()

    def clocked(real, key, sync=False):
        def fn(*args, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kw)
            record[key].append(time.perf_counter() - t0)
            return out
        return fn

    trainer_mod.make_train_step = make
    trainer_mod.Trainer._make_loader = loader
    trainer_mod.Trainer.save = clocked(real_save, "ckpt_save_s", sync=True)
    ckpt_mod.CheckpointManager.wait = clocked(real_wait, "wait_s")
    try:
        yield record
    finally:
        trainer_mod.make_train_step = real_make
        trainer_mod.Trainer._make_loader = real_loader
        trainer_mod.Trainer.save, ckpt_mod.CheckpointManager.wait = real_save, real_wait


def run(log_every: int) -> dict:
    from vqgan_tpu_torch import cli

    record = {k: [] for k in ("calls", "events", "batch_s", "ckpt_save_s", "wait_s")}
    with tempfile.TemporaryDirectory() as tmp, instrumented(record):
        t0 = time.perf_counter()
        cli.main(JOB + ["--max_steps", str(STEPS), "--log_every", str(log_every),
                        "--ckpt_dir", tmp, "--run_name", "t"])
        seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    calls = record["calls"]
    dev = [s.elapsed_time(e) for s, e in record["events"]]
    # the last wait in the loop joins the final save's background write
    return {"log_every": log_every, "steps": STEPS, "call_s": seconds,
            "wall_ms": float(np.mean(np.diff(calls[2:]))) * 1e3,
            "device_ms": float(np.mean(dev[2:])),
            "batch_ms": float(np.mean(record["batch_s"][2:])) * 1e3,
            "ckpt_save_s": record["ckpt_save_s"], "background_write_s": record["wait_s"][-1]}


def main() -> int:
    if not torch.cuda.is_available():
        print("time_job needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    results = []
    for every in (1, 5):
        r = run(every)
        results.append(r)
        print(f"gaussian job, log every {every}: {r['wall_ms']:.1f} ms a step by the "
              f"host clock (steps 3-{STEPS}), {r['device_ms']:.1f} ms between CUDA "
              f"events; a batch {r['batch_ms']:.1f} ms on the loop's thread; the final save: "
              f"Trainer.save {r['ckpt_save_s'][-1]:.2f} s, then the background "
              f"write of the .pt and the state {r['background_write_s']:.2f} s; the call "
              f"{r['call_s']:.1f} s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"device": smi, "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
