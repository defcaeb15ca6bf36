"""One case of ``chip_smoke.py``'s phases 38-40 run at ``data=2`` and then
at ``fsdp=2`` in the same two ranks, several launches in a row, to see
whether the sharded step stays bitwise the whole one (phase 42's check) and
what the card's memory looked like when it did not.

    python -m vqgan_tpu_torch.tools.repeat_fsdp_case [--case "flagship vq"]
        [--launches 3] [--tf32 on|off]

Both ranks share the first card over gloo, as in the smoke, with cuDNN
deterministic and its benchmark off. Prints, per launch, rank and step,
whether the gathered state's digest equals the ``data=2`` run's, which
tensors differ, the caching allocator's OOM count so far (an allocation
that failed, such as a cuDNN plan's workspace, after which cuDNN tries
another plan), the card's free memory, the rank's peak reserved memory and
the step's ms by CUDA events in both layouts; then the card's name and
power limit. Writes the rows as JSON to ``--out`` when given. Needs a CUDA
device; run from the repository's root.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import json
import os
import sys
import tempfile

import torch

import chip_smoke as cs


def rank_main(spec_path: str) -> int:
    """One rank (under torchrun): ``chip_smoke.dp_ranks_main`` with each
    step's allocator readings added to its results."""
    real_run_case = cs.dp_run_case

    def run_case(case, rows, tape, record, after_step=None):
        readings = []

        def after(state):
            if after_step is not None:
                after_step(state)
            stats = torch.cuda.memory_stats()
            free, _ = torch.cuda.mem_get_info()
            peak = stats.get("reserved_bytes.all.peak", 0)
            readings.append({"ooms": stats.get("num_ooms", 0),
                             "retries": stats.get("num_alloc_retries", 0),
                             "free_gib": free / 2**30, "peak_reserved_gib": peak / 2**30})

        out = real_run_case(case, rows, tape, record, after)
        out["memory"] = readings
        return out

    cs.dp_run_case = run_case
    return cs.dp_ranks_main(spec_path)


def run(case: str, launches: int, tf32: bool) -> list[dict]:
    """``launches`` torchrun launches of two ranks, each running ``case``
    whole then sharded; one row per launch, rank and step."""
    rows = []
    for launch in range(launches):
        with tempfile.TemporaryDirectory() as tmp:
            spec = {"cases": [case], "fsdp_cases": [case], "dir": tmp, "tf32": tf32,
                    "models": cs.dp_models(), "mesh": cs.FSDP_MESH}
            spec_path = os.path.join(tmp, "spec.json")
            with open(spec_path, "w") as f:
                json.dump(spec, f)
            cs.dp_launch(["-m", "vqgan_tpu_torch.tools.repeat_fsdp_case", "--dp-ranks",
                          spec_path], cs.DP_RANKS, os.path.join(tmp, "launch.log"))
            ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                     for r in range(cs.DP_RANKS)]
        for r, rank in enumerate(ranks):
            sharded, whole = rank["fsdp"][case], rank["cases"][case]
            paths = sharded["digest_paths"]
            for i in range(cs.DP_STEPS):
                a, b = sharded["digests"][i], whole["digests"][i]
                differ = [paths[j // 2] for j in range(0, len(a), 2) if a[j:j + 2] != b[j:j + 2]]
                rows.append({"launch": launch, "rank": r, "step": i + 1, "bitwise": not differ,
                             "differ": differ[:20], "memory_data2": whole["memory"][i],
                             "memory_fsdp": sharded["memory"][i], "ms_data2": whole["ms"][i],
                             "ms_fsdp": sharded["ms"][i]})
                print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--dp-ranks":
        return rank_main(sys.argv[2])
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--case", default="flagship vq", choices=[*cs.DP_CASES, cs.DP_ACCUM])
    parser.add_argument("--launches", type=int, default=3)
    parser.add_argument("--tf32", choices=("on", "off"), default="on")
    parser.add_argument("--out", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("repeat_fsdp_case needs a CUDA device", file=sys.stderr)
        return 1
    card = cs._card()
    print(f"{card}; torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}")
    modules = [importlib.import_module(f"vqgan_tpu_torch.ops.{name}")
               for name in ("groupnorm_cuda", "vq_cuda", "attention_cuda", "conv3d_cuda")]
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:  # one nvcc a source
        for built in [pool.submit(m.library) for m in modules]:
            built.result()
    rows = run(args.case, args.launches, args.tf32 == "on")
    ooms = max(r[k]["ooms"] for r in rows for k in ("memory_data2", "memory_fsdp"))
    print(f"{args.case}: {sum(r['bitwise'] for r in rows)} of {len(rows)} rank-steps bitwise; "
          f"at most {ooms} allocator OOMs")
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
