"""One rank of the port's data-parallel CPU checks (not a test file; as
tests/multiprocess_worker.py is for the JAX package).

``python tests/torch_dp_worker.py SPEC OUT`` under torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``):
joins the gloo group through ``init_distributed``, then runs what the spec
(a ``torch.save``'d dict, made by tests/test_torch_data_parallel.py) asks:

  - ``gradnorm``: GradNorm's backward on this rank's rows of a global
    (x, cotangent) pair, in the global and the ``mean_shard_norm`` modes;
  - ``cases``: the 2D or 3D GAN step on this rank's rows of each step's
    global batch, with the global draws (``run_case``), replaying the loss
    head's decisions that the one-process run of the same case recorded
    (``OUT/tape{i}.pt``, waited for: the test writes each as its run ends);
    after every step the ranks' whole train states are compared bit for bit;
  - ``trainer``: for each flag list, a ``Trainer`` built from the ``train``
    CLI's flags (a later one resumes from what the earlier ones saved), its
    state as built and after ``train()``, and whether its trained modules
    hold their whole parameters after ``train()``.

With ``mesh`` in the spec (tests/test_torch_fsdp.py: ``{"data": 1,
"fsdp": 2}``) the ranks form that mesh and each case runs twice, the
state whole on every rank (the data-parallel layout) and sharded over the
fsdp axis, each run recording after every step its gathered state
(``state_dict_of``) and the bytes the rank holds at rest; the sharded
run's states are compared bit for bit with the whole run's here
(``same_as_whole``), and only the whole run's shapes are written (its
trees on the meta device: D's VGG16 makes a tree ~200 MB).

Each rank writes ``OUT/rank{r}.pt``. ``run_case`` with ``group=None`` is the
one-process step on the global batch, which the test runs beside.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from vqgan_tpu_torch.config import TrainConfig, TVAEConfig, VAEConfig
from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, TubeletDiscriminator
from vqgan_tpu_torch.losses.lpips import LPIPS
from vqgan_tpu_torch.models.ae import VAE
from vqgan_tpu_torch.models.tae import TVAE
from vqgan_tpu_torch.ops.gradnorm import gradnorm
from vqgan_tpu_torch.parallel.fsdp import shard_state
from vqgan_tpu_torch.parallel.mesh import create_mesh, init_distributed, replicas_equal
from vqgan_tpu_torch.train.checkpoint import state_dict_of
from vqgan_tpu_torch.train.state import create_train_state, state_tensors
from vqgan_tpu_torch.train.step import StepDraws, make_train_step
from vqgan_tpu_torch.train.step3d import Step3DDraws, make_train_step_3d_gan


def _rows(x: np.ndarray, rank: int, n: int) -> np.ndarray:
    b = x.shape[0] // n
    return x[rank * b:(rank + 1) * b]


def _draws(kind: str, d: dict):
    """The step's draws from the spec's plain values (ε global)."""
    d = {k: (torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v)
         for k, v in d.items()}
    return Step3DDraws(**d) if kind == "3d" else StepDraws(**d)


def run_case(case: dict, group=None, rank: int = 0, n: int = 1, tape=None,
             mesh=None, trees: bool = False, context=None) -> dict:
    """The case's steps on rank ``rank``'s rows of each global batch
    (``group=None``: one process, the whole batch). Returns each step's
    metrics and whether the ranks' states were bitwise equal after it, step
    1's first moments of G and D, and the final G params, VQ and Polyak
    EMAs. ``case["gradnorm_shards"]``: the ranks the global batch is
    split over (JAX's ``n_data``), for ``mean_shard_norm``. Under
    ``grad_accum`` the global batch is microbatch-major (``train/step.py``):
    one process takes the batch's rows in ``case["one_process_order"]``.

    ``tape``: a ``chip_smoke.DecisionTape`` of the loss head's decisions
    (LPIPS's and D's ReLU masks and max-pool argmaxes) over all the steps:
    one process records them on it, a rank replays its rows of them, so that
    the two runs differ by rounding alone.

    ``mesh``: the state sharded over its fsdp axis (``shard_state``); the
    ranks' blocks are then compared across its replica group (with
    ``trees`` and no mesh, the ranks are not compared). ``trees``:
    each step's gathered state (``out["trees"]``) and the bytes held at rest
    (``held_bytes``) are kept, and the moments and final tensors read from
    the gathered trees.

    ``context`` (a 3D case): the group of ranks that split this rank's
    clips' frames; ``rank`` and ``n`` are then the data index and extent,
    and the rank takes its T block of its clips (tests/test_torch_context.py)."""
    cfg = TrainConfig(**case["train"])
    shards = case["gradnorm_shards"]
    three_d = case["kind"] == "3d"
    if three_d:
        model_cfg = TVAEConfig(**case["model"])
        vae = TVAE(model_cfg, context=context)
    else:
        model_cfg = VAEConfig(**case["model"])
        vae = VAE(model_cfg)
    disc = (TubeletDiscriminator(case["tubelet_frames"]) if three_d and cfg.disc_3d == "tubelet"
            else PatchDiscriminator())
    lpips = LPIPS()
    vae.load_state_dict(case["sd"]["g"], strict=True)
    disc.load_state_dict(case["sd"]["d"], strict=True)
    lpips.load_state_dict(case["sd"]["lpips"], strict=True)
    state = create_train_state(cfg, vae, disc, model_cfg.ch, vq_ema=case.get("vq_ema"))
    if mesh is not None:
        shard_state(state, mesh)
    if three_d:
        step = make_train_step_3d_gan(cfg, model_cfg, vae, disc, lpips,
                                      gradnorm_shards=shards, group=group, context=context)
    else:
        step = make_train_step(cfg, model_cfg, vae, disc, lpips, gradnorm_shards=shards,
                               group=group)
    out = {"metrics": [], "replicas_equal": [], "vq_ema_steps": []}
    head = {"lpips": lpips, "disc": disc}
    with (contextlib.nullcontext() if tape is None else tape.recording(head) if group is None
          else tape.rows(rank, n).replaying(head)):
        _steps(case, step, state, vae, disc, group, rank, n, out, mesh, trees, context)
    if trees:
        out["param_names"] = {"g": [k for k, _ in vae.named_parameters()],
                              "d": [k for k, _ in disc.named_parameters()]}
        final = out["trees"][-1]
        out["params"] = {k: final["g_model"][k] for k, _ in vae.named_parameters()}
        out["vq_ema"], out["g_ema"] = final["vq_ema"], final["g_ema"]
        return out
    out["params"] = {k: v.detach().clone() for k, v in vae.named_parameters()}
    out["vq_ema"] = None if state.vq_ema is None else {k: v.clone()
                                                       for k, v in state.vq_ema.items()}
    out["g_ema"] = None if state.g_ema is None else {k: v.clone()
                                                     for k, v in state.g_ema.items()}
    return out


def _moments(tree: dict, side: str, model, opt) -> dict:
    """The first moments of a gathered tree's optimizer by parameter name."""
    ids = [i for g in tree[f"{side}_opt"]["param_groups"] for i in g["params"]]
    names = {p: name for name, p in model.named_parameters()}
    params = [p for g in opt.param_groups for p in g["params"]]
    per = tree[f"{side}_opt"]["state"]
    return {names[p]: per[i]["exp_avg"] for i, p in zip(ids, params) if i in per}


def _steps(case, step, state, vae, disc, group, rank, n, out, mesh=None,
           trees: bool = False, context=None) -> None:
    three_d = case["kind"] == "3d"
    order = case.get("one_process_order")
    for i, (batch, d) in enumerate(zip(case["batches"], case["draws"])):
        if group is None and order is not None:
            batch = batch[order]
        x = _rows(batch, rank, n)
        if context is not None:
            t = x.shape[1] // dist.get_world_size(context)
            x = x[:, dist.get_rank(context) * t:(dist.get_rank(context) + 1) * t]
        x = torch.from_numpy(np.ascontiguousarray(x))
        draws = _draws(case["kind"], d)
        if three_d:
            state, m = step(state, x, draws)
        else:
            state, m = step(state, x, 0, draws)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if trees:
            held = state_tensors(state)
            out.setdefault("held_bytes", []).append(sum(t.numel() * t.element_size()
                                                        for t in held))
            if mesh is not None:  # the whole layout's ranks: the data-parallel test's
                whole = replicas_equal(state_tensors(state, sharded=False), group)
                blocks = replicas_equal(state_tensors(state, sharded=True), mesh.replica_group)
                out["replicas_equal"].append(whole and blocks)
            out.setdefault("trees", []).append(state_dict_of(state))
            if i == 0:
                tree = out["trees"][0]
                out["exp_avg_g"] = _moments(tree, "g", vae, state.g_opt)
                out["exp_avg_d"] = _moments(tree, "d", disc, state.d_opt)
            if state.vq_ema is not None:
                out["vq_ema_steps"].append(out["trees"][-1]["vq_ema"])
            continue
        out["replicas_equal"].append(replicas_equal(state_tensors(state), group))
        if state.vq_ema is not None:
            out["vq_ema_steps"].append({k: v.clone() for k, v in state.vq_ema.items()})
        if i == 0:
            for side, model, opt in (("g", vae, state.g_opt), ("d", disc, state.d_opt)):
                out[f"exp_avg_{side}"] = {name: opt.state[p]["exp_avg"].clone()
                                          for name, p in model.named_parameters()
                                          if p in opt.state}


def run_gradnorm(spec: dict, group, rank: int, n: int) -> dict:
    """x.grad of this rank's rows through GradNorm, in each mode."""
    out = {}
    for mode in ("global", "mean_shard_norm"):
        x = torch.from_numpy(_rows(spec["x"], rank, n)).requires_grad_(True)
        g = torch.from_numpy(_rows(spec["g"], rank, n))
        y = gradnorm(x, spec["weight"], group, 1, global_norm=mode == "global")
        (y * g).sum().backward()
        out[mode] = x.grad.clone()
    return out


def run_trainer(argv: list[str]) -> dict:
    """A ``Trainer`` from the ``train`` flags (a ``Trainer3D`` from the
    ``train3d`` flags after "train3d"): its state as built (restored where
    the run dir holds one), then ``train()``, then its state."""
    from vqgan_tpu_torch import cli
    from vqgan_tpu_torch.train.checkpoint import state_dict_of
    from vqgan_tpu_torch.train.trainer import Trainer
    from vqgan_tpu_torch.train.trainer3d import Trainer3D

    if argv[0] == "train3d":
        kw = vars(cli.build_parser_3d().parse_args(argv[1:]))
        cfg, tvae_cfg = cli.configs_3d(kw)
        trainer = Trainer3D(cfg, tvae_cfg, frames=kw["frames"], device="cpu")
    else:
        cfg, vae_cfg = cli.configs(vars(cli.build_parser().parse_args(argv)))
        trainer = Trainer(cfg, vae_cfg, device="cpu")
    built = state_dict_of(trainer.state)
    trainer.train()
    trained = state_dict_of(trainer.state)
    equal = replicas_equal(state_tensors(trainer.state, sharded=False), trainer.mesh.group)
    # the modules the caller keeps: G (and D) whole again on every rank
    modules = {"g_model": trainer.vae if hasattr(trainer, "vae") else trainer.model,
               "d_model": trainer.disc}
    whole = all(tuple(p.shape) == tuple(trained[key][name].shape)
                for key, module in modules.items() if module is not None
                for name, p in module.named_parameters())
    return {"built": built, "trained": trained, "whole_after_train": whole,
            "replicas_equal": equal, "local_batch": trainer.local_batch,
            "mesh": trainer.mesh.shape, "logs": trainer.logger.is_master}


def same_tree(a, b) -> bool:
    """Two state trees equal, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return a == b


def meta_tree(tree):
    """``tree`` with each tensor replaced by an empty one of its shape and
    dtype on the meta device."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: meta_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_tree(v) for v in tree)
    return tree


def _tape(path: str, timeout_s: float = 600.0):
    """The DecisionTape the test writes to ``path``, once it is there."""
    from chip_smoke import DecisionTape

    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"no {path} after {timeout_s} s")
        time.sleep(0.05)
    tape = DecisionTape()
    tape.calls = torch.load(path, weights_only=True)
    return tape


def _block(x: np.ndarray, group, dim: int) -> torch.Tensor:
    """This rank's block of ``group``'s split of x along ``dim``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    return torch.from_numpy(np.ascontiguousarray(
        np.take(x, np.arange(r * size, (r + 1) * size), axis=dim)))


def run_ring(spec: dict, groups: dict) -> dict:
    """Ring attention over each group of ``groups`` ({ranks: group}) on its
    blocks of the spec's global (B, N, H, D) q, k, v and cotangent g, in
    each dtype: this rank's out, dq, dk, dv (fp32 copies)."""
    from vqgan_tpu_torch.ops.ring_attention import ring_attention

    out = {}
    for ranks, group in groups.items():
        if dist.get_rank() not in ranks:
            continue
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, k, v = (_block(spec[name], group, 1).to(dt).requires_grad_(True)
                       for name in ("q", "k", "v"))
            o = ring_attention(q, k, v, group, spec["chunk"])
            o.backward(_block(spec["g"], group, 1).to(dt))
            out[(len(ranks), dtype)] = {"out": o.detach().float(), "dq": q.grad.float(),
                                        "dk": k.grad.float(), "dv": v.grad.float()}
    return out


def run_context_units(spec: dict, mesh) -> dict:
    """The context axis's pieces on this rank's T blocks of the spec's
    global tensors: ``halo_t`` over every rank and its backward for a
    cotangent; the two-pass GroupNorm over every rank, forward and
    backward; the tiny TVAE's forward and parameter gradients at
    data=1,context=2 (the ranks of this rank's context group) and at
    data=2,context=2 (every rank)."""
    from vqgan_tpu_torch.ops.groupnorm_cuda import context_group_norm
    from vqgan_tpu_torch.parallel.context import halo_t

    world = mesh.group
    out = {}
    for before, after in ((1, 1), (0, 1)):
        x = _block(spec["halo_x"], world, 2).contiguous(
            memory_format=torch.channels_last_3d).requires_grad_(True)
        y = halo_t(x, before, after, world)
        cot = spec["halo_g"][(before, after)][dist.get_rank()]
        y.backward(torch.from_numpy(cot))
        out[("halo", before, after)] = {"y": y.detach(), "dx": x.grad}
    for swish in (False, True):
        x = _block(spec["gn_x"], world, 2).contiguous(
            memory_format=torch.channels_last_3d).requires_grad_(True)
        w, b = (torch.from_numpy(spec[k]).requires_grad_(True) for k in ("gn_w", "gn_b"))
        y = context_group_norm(x, w, b, 32, 1e-6, swish, world)
        y.backward(_block(spec["gn_g"], world, 2).contiguous(
            memory_format=torch.channels_last_3d))
        out[("gn", swish)] = {"y": y.detach(), "dx": x.grad, "dw": w.grad, "db": b.grad}
    for layout, group, rows in (("d1c2", mesh.context_group, (0, 1)),
                                ("d2c2", world, (mesh.data_index, mesh.n_data))):
        model = TVAE(TVAEConfig(**spec["tvae"]), context=mesh.context_group)
        model.load_state_dict(spec["tvae_sd"], strict=True)
        x = _block(_rows(spec["tvae_x"], *rows), mesh.context_group, 1)
        z = model.encode(x)
        y = model.decode(z[..., :z.shape[-1] // 2])
        loss = (y * _block(_rows(spec["tvae_wy"], *rows), mesh.context_group, 1)).sum() + (
            z * _block(_rows(spec["tvae_wz"], *rows), mesh.context_group, 1)).sum()
        loss.backward()
        grads = {k: p.grad for k, p in model.named_parameters()}
        for g in grads.values():
            dist.all_reduce(g, group=group)
        out[("tvae", layout)] = {"y": y.detach(), "z": z.detach(), "grads": grads}
    return out


def main() -> None:
    torch.set_num_threads(1)
    spec_path, out_dir = sys.argv[1], sys.argv[2]
    init_distributed("cpu")
    spec = torch.load(spec_path, weights_only=False)
    axes = spec.get("mesh", {"data": -1})
    mesh = create_mesh(axes, context="context" in axes)
    rank, n = mesh.rank, mesh.world_size
    out = {}
    if "ring" in spec:
        groups = {tuple(range(mesh.world_size)): mesh.group}
        for pair in ((0, 1), (2, 3)):  # every rank makes every group
            groups[pair] = dist.new_group(list(pair))
        out["ring"] = run_ring(spec["ring"], groups)
    if "context_units" in spec:
        out["context_units"] = run_context_units(spec["context_units"], mesh)
    for i, case in enumerate(spec.get("context_cases", ())):
        tape = _tape(os.path.join(out_dir, f"ctx_tape{i}.pt"))
        if case["layout"] == "d1c2":
            got = run_case(case, mesh.context_group, 0, 1, tape, context=mesh.context_group)
        else:
            got = run_case(case, mesh.group, mesh.data_index, mesh.n_data, tape,
                           context=mesh.context_group)
        if rank != 0:  # the others' moments and params: shapes only (D's are ~60 MB)
            got = meta_tree(got)
        out[case["name"]] = got
    if "gradnorm" in spec:
        out["gradnorm"] = run_gradnorm(spec["gradnorm"], mesh.group, rank, n)
    for i, case in enumerate(spec.get("cases", ())):
        tape = _tape(os.path.join(out_dir, f"tape{i}.pt"))
        if "mesh" in spec:
            runs = {layout: run_case(case, mesh.group, rank, n, tape,
                                     mesh if layout == "fsdp" else None, True)
                    for layout in ("data", "fsdp")}
            whole, sharded = runs["data"], runs["fsdp"]
            sharded["same_as_whole"] = [same_tree(a, b) for a, b in
                                        zip(sharded.pop("trees"), whole["trees"])]
            whole["trees"] = [meta_tree(t) for t in whole["trees"]]
            out[case["name"]] = runs
            continue
        out[case["name"]] = run_case(case, mesh.group, rank, n, tape)
    out["trainer"] = [run_trainer(argv) for argv in spec.get("trainer", ())]
    if "context_cases" in spec and rank != 0:  # rank 0's trees stand for every rank's
        out["trainer"] = [{k: meta_tree(v) if k in ("built", "trained") else v
                           for k, v in run.items()} for run in out["trainer"]]
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
