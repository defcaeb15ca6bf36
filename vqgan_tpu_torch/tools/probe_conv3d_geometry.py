"""Which conv-tile geometries build for this card, and does each compute its
function (counterpart of ``tools/probe_mosaic_geometry.py``).

    python -m vqgan_tpu_torch.tools.probe_conv3d_geometry [--iters 20]

Builds ``csrc/geometry_probe.cu`` (kernel #7: one hand-written kernel per
case A-H of ``ops/geometry_probe.CASES``, ``sm_90a``) and prints one line per
case: built, or rejected with the compiler's message (then each case is
built alone, so that one refused geometry does not hide the others);
registers and local bytes per thread from ``cudaFuncGetAttributes``; the
largest absolute error against the case's plain PyTorch version on the same
inputs (``np.random.RandomState(0)``, drawn in the JAX tool's order), OK or
WRONG at rtol = atol = 2e-2 as the JAX tool judges; and the kernel's ms by
CUDA events (``--iters`` launches after 3 warm-ups; 0 skips the timing).
fp32 matmuls run without TF32. Exits 1 unless every case builds and is OK.
Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, Optional

import torch

from vqgan_tpu_torch.ops import geometry_probe_cuda as gpc
from vqgan_tpu_torch.ops.geometry_probe import ATOL, CASES, RTOL, Case, make_inputs


@dataclasses.dataclass
class CaseResult:
    case: Case
    built: bool
    message: str = ""  # the compiler's refusal when not built
    num_regs: int = 0
    local_bytes: int = 0
    shared_bytes: int = 0
    max_abs_err: float = float("nan")
    ok: bool = False
    ms: Optional[float] = None

    def line(self) -> str:
        if not self.built:
            return f"{self.case.name}: rejected - {self.message}"
        ms = "" if self.ms is None else f", {self.ms:.4f} ms"
        return (f"{self.case.name}: built, {self.num_regs} registers, {self.local_bytes} B "
                f"local, {self.shared_bytes} B shared; max abs err {self.max_abs_err:.3e}, "
                f"{'OK' if self.ok else 'WRONG'} at {RTOL:g}{ms}")


def cuda_ms(fn: Callable[[], object], iters: int, warmup: int = 3) -> float:
    """Mean ms of ``fn`` over ``iters`` calls by CUDA events, after warm-ups."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _compiler_message(err: Exception) -> str:
    lines = [ln.strip() for ln in str(err).splitlines() if "error" in ln.lower()]
    return " | ".join(lines[:3])[:300] or str(err)[-300:]


def run_probe(iters: int = 20, device: str = "cuda",
              log: Callable[[str], None] = print) -> list[CaseResult]:
    """Build, check and time every case on ``device`` (a CUDA device); logs
    one line per case and returns the results. Each case's kernel runs once
    for its check and, with ``iters`` > 0, 3 + ``iters`` times more to time
    it."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("probe_conv3d_geometry needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in fp32
    inputs = {k: torch.from_numpy(v).to(device) for k, v in make_inputs().items()}
    libs, messages = {}, {}
    try:
        lib = gpc.library()
        libs = {case.letter: lib for case in CASES}
    except RuntimeError as whole:
        log(f"the whole source was rejected; building each case alone: "
            f"{_compiler_message(whole)}")
        for case in CASES:
            try:
                libs[case.letter] = gpc.build_case_alone(case)
            except RuntimeError as err:
                messages[case.letter] = _compiler_message(err)
    results = []
    for case in CASES:
        if case.letter not in libs:
            results.append(CaseResult(case, built=False, message=messages[case.letter]))
            log(results[-1].line())
            continue
        lib = libs[case.letter]
        a, b = (inputs[k] for k in case.inputs)
        got = gpc.probe_case(case, a, b, lib)
        ref = case.plain(a, b)
        res = CaseResult(case, built=True, **gpc.attributes(case, lib),
                         max_abs_err=float((got - ref).abs().max()),
                         ok=bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL)))
        if iters > 0:
            res.ms = cuda_ms(lambda: gpc.probe_case(case, a, b, lib), iters)
        results.append(res)
        log(res.line())
    return results


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_conv3d_geometry needs a CUDA device", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}")
    results = run_probe(args.iters)
    return 0 if all(r.built and r.ok for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
