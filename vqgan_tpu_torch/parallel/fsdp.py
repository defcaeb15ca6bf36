"""The ``fsdp`` mesh axis: the train state sharded at rest across the ranks
of a data index (counterpart of ``vqgan_tpu/parallel/mesh.py``'s
``state_shardings`` under ``jit``).

JAX lays every >= 2-D leaf of the train state (G's and D's parameters, both
AdamW moments, the Polyak EMA of G, the VQ EMA sums) out over ``fsdp`` by
``_param_spec`` and lets XLA gather a weight before its use and
reduce-scatter its gradient. ``FSDP`` does the same with the two
collectives of ``parallel/mesh.py``, so that one implementation runs on the
CPU over gloo, on one card shared by several ranks over gloo and on a host
with a card a rank over NCCL:

  - at rest a rank holds, of each tensor ``param_spec`` splits, its block
    along the split dim (rank ``fsdp_index`` of F holds block
    ``fsdp_index``); the 1-D tensors whole. The module's parameter is that
    block (``p.data``), and the optimizers, the Polyak EMA and the VQ sums
    keep theirs, so AdamW and the EMA update step on the blocks;
  - a gather (``gather_``) gives each module its full parameters: each owner
    broadcasts its blocks over the fsdp group, in buckets of at most
    ``BUCKET_BYTES`` of blocks, so each byte crosses the group once;
  - the step's gradients are summed across every rank by the all_reduce
    ``reduce_gradients`` already makes; then each rank keeps its block of
    each parameter and gradient (``shard_``) and the optimizer steps on
    them. AdamW and the EMAs are elementwise, so a sharded update is the
    unsharded one bit for bit on the same gradients.

A train step therefore starts with ``begin_step`` (G and D gathered, the VQ
sums whole), steps each optimizer on the blocks (D is gathered again after
its step: G's loss runs through the updated D) and ends with ``end_step``;
between steps a rank holds 1/F of each sharded tensor. Gathering a module
at a time inside forward and backward (FSDP2's prefetch) is not done here:
a step's peak holds the full G and D. A state held whole (``fsdp`` 1) has
the layout ``Whole``, whose methods do nothing, so the steps, checkpoints
and trainers call the same methods in either layout.

A checkpoint is the unsharded tree (``gather_tree``; every rank of the
group takes part), and a loaded tree is cut to this rank's blocks
(``shard_tree``), so a file moves between layouts.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Iterator, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from vqgan_tpu_torch.parallel.mesh import Mesh, _buckets, _on_backend, param_spec, rows_layout

if TYPE_CHECKING:
    from vqgan_tpu_torch.train.state import TrainState

@dataclasses.dataclass(frozen=True)
class Plan:
    """One sharded tensor: the dim split over fsdp, the full shape, and the
    strides a gathered copy takes: the whole tensor's own (a parameter's
    channels-last layout, which the convolutions and kernels read; a
    convolution may pick another algorithm for other strides of the same
    shape, so the gathered copy keeps them exactly)."""

    dim: int
    shape: tuple[int, ...]
    stride: tuple[int, ...]

    def block_shape(self, n: int) -> tuple[int, ...]:
        return self.shape[:self.dim] + (self.shape[self.dim] // n,) + self.shape[self.dim + 1:]


class Whole:
    """The layout of a train state held whole on every rank (``fsdp`` 1):
    nothing to gather or cut. ``FSDP`` overrides each method."""

    sharded = False

    def is_block(self, p: Optional[nn.Parameter] = None, path: Optional[str] = None) -> bool:
        """Whether the parameter ``p`` (or the state path ``path``,
        "g_model.<name>", "vq_ema.sums") is held as this rank's block."""
        return False

    def begin_step(self, state: "TrainState") -> None:
        """A train step's start: G and D whole, the VQ sums whole."""

    def end_step(self, state: "TrainState") -> None:
        """A train step's end: every sharded tensor back to its block."""

    def gather_models(self, state: "TrainState") -> None:
        """G's and D's parameters whole (collective under fsdp)."""

    def gather_(self, model: nn.Module) -> None:
        """Every sharded parameter of ``model`` whole (collective)."""

    def shard_(self, model: nn.Module) -> None:
        """Every sharded parameter of ``model``, and its gradient, cut to
        this rank's block."""

    def assign_(self, p: nn.Parameter, value: torch.Tensor) -> None:
        """``p`` takes the whole ``value``: its block where ``p`` is a block."""
        p.data.copy_(value)

    def shard_vq(self, vq_ema: Optional[dict]) -> Optional[dict]:
        """The VQ EMA statistics with the sums cut to this rank's block."""
        return vq_ema

    def gather_named(self, tensors: Mapping[str, torch.Tensor], keep: bool = True,
                     prefix: str = "g_model") -> Optional[dict[str, torch.Tensor]]:
        """A dict of G's parameters by name (the module's or the Polyak
        EMA), whole (collective under fsdp); None with ``keep=False``."""
        return dict(tensors) if keep else None

    def gather_tree(self, state: "TrainState", tree: dict, host: bool = True,
                    keep: bool = True) -> Optional[dict]:
        """A ``checkpoint.state_tree`` with every sharded tensor whole
        (collective under fsdp); None with ``keep=False``."""
        return tree if keep else None

    def shard_tree(self, state: "TrainState", tree: dict) -> dict:
        """A whole tree (a checkpoint of any layout) cut to this rank's
        blocks."""
        return tree


class FSDP(Whole):
    """The fsdp layout of one train state on one rank (``mesh.n_fsdp`` > 1).
    ``register(state)`` plans G's and D's parameters and cuts the state to
    this rank's blocks; the train steps and the trainers call the rest."""

    sharded = True

    def __init__(self, mesh: Mesh):
        if mesh.n_fsdp < 2:
            raise ValueError(f"mesh {mesh.shape}: no fsdp axis to shard over")
        self.mesh = mesh
        self.n = mesh.n_fsdp
        self.index = mesh.fsdp_index
        self.group = mesh.fsdp_group
        self.ranks = mesh.fsdp_ranks()
        self.plans: dict[str, Plan] = {}  # by state path, "g_model.<param>", "vq_ema.sums"
        self._param_path: dict[nn.Parameter, str] = {}

    # -- the rule --------------------------------------------------------

    def plan_for(self, name: str, t: torch.Tensor) -> Optional[Plan]:
        """The plan of a full tensor named ``name``, None where
        ``param_spec`` keeps it whole."""
        spec = param_spec(tuple(t.shape), self.mesh.shape, rows=rows_layout(name))
        if "fsdp" not in spec:
            return None
        return Plan(spec.index("fsdp"), tuple(t.shape), tuple(t.stride()))

    def plan_of(self, p: nn.Parameter) -> Optional[Plan]:
        path = self._param_path.get(p)
        return None if path is None else self.plans[path]

    def is_block(self, p: Optional[nn.Parameter] = None, path: Optional[str] = None) -> bool:
        return (self.plan_of(p) if p is not None else self.plans.get(path)) is not None

    def block(self, full: torch.Tensor, plan: Plan) -> torch.Tensor:
        """This rank's block of ``full`` (a new tensor)."""
        size = plan.shape[plan.dim] // self.n
        return full.narrow(plan.dim, self.index * size, size).clone()

    # -- the state -------------------------------------------------------

    def register(self, state: "TrainState") -> None:
        """Plan every parameter of G and D, then keep this rank's block of
        each sharded tensor of ``state`` (parameters, optimizer moments,
        Polyak EMA, VQ sums); ``state.layout`` becomes this layout. The
        state must be whole and equal on the ranks of the group."""
        with torch.no_grad():
            for prefix, model in (("g_model", state.g_model), ("d_model", state.d_model)):
                if model is None:
                    continue
                for name, p in model.named_parameters():
                    plan = self.plan_for(name, p)
                    if plan is not None:
                        self.plans[f"{prefix}.{name}"] = plan
                        self._param_path[p] = f"{prefix}.{name}"
            if state.vq_ema is not None:
                plan = self.plan_for("sums", state.vq_ema["sums"])
                if plan is not None:
                    self.plans["vq_ema.sums"] = plan
            for model, opt in ((state.g_model, state.g_opt), (state.d_model, state.d_opt)):
                if model is not None:
                    self.shard_(model)
                    self._shard_moments(opt)
            if state.g_ema is not None:
                state.g_ema = {n: self._cut(f"g_model.{n}", v) for n, v in state.g_ema.items()}
            state.vq_ema = self.shard_vq(state.vq_ema)
        state.layout = self

    def _cut(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """``t``'s block where ``path`` is sharded and ``t`` is whole."""
        plan = self.plans.get(path)
        if plan is None or tuple(t.shape) != plan.shape:
            return t
        return self.block(t, plan)

    def _shard_moments(self, opt: torch.optim.Optimizer) -> None:
        for p, per in opt.state.items():
            plan = self.plan_of(p)
            if plan is None:
                continue
            for k, v in per.items():
                if isinstance(v, torch.Tensor) and tuple(v.shape) == plan.shape:
                    per[k] = self.block(v, plan)

    def begin_step(self, state: "TrainState") -> None:
        self.gather_models(state)
        state.vq_ema = self.gather_vq(state.vq_ema)

    def gather_models(self, state: "TrainState") -> None:
        self.gather_(state.g_model)
        if state.d_model is not None:
            self.gather_(state.d_model)

    def end_step(self, state: "TrainState") -> None:
        self.shard_(state.g_model)
        if state.d_model is not None:
            self.shard_(state.d_model)
        state.vq_ema = self.shard_vq(state.vq_ema)

    # -- modules ---------------------------------------------------------

    def _sharded(self, model: nn.Module) -> list[tuple[nn.Parameter, Plan]]:
        return [(p, self.plans[self._param_path[p]]) for p in model.parameters()
                if p in self._param_path]

    @torch.no_grad()
    def gather_(self, model: nn.Module) -> None:
        """Collective over the fsdp group; whole parameters stay."""
        todo = [(p, plan) for p, plan in self._sharded(model) if tuple(p.shape) != plan.shape]
        for (p, _), full in zip(todo, self.gather([p.data for p, _ in todo],
                                                  [plan for _, plan in todo])):
            p.data = full

    @torch.no_grad()
    def shard_(self, model: nn.Module) -> None:
        """No communication; blocks stay."""
        for p, plan in self._sharded(model):
            if tuple(p.shape) != plan.shape:
                continue
            grad, p.grad = p.grad, None
            p.data = self.block(p.data, plan)
            if grad is not None:
                p.grad = self.block(grad, plan)

    def assign_(self, p: nn.Parameter, value: torch.Tensor) -> None:
        plan = self.plan_of(p)
        if plan is not None and tuple(p.shape) != plan.shape:
            value = self.block(value, plan)
        p.data.copy_(value)

    def gather_vq(self, vq_ema: Optional[dict]) -> Optional[dict]:
        plan = self.plans.get("vq_ema.sums")
        if vq_ema is None or plan is None or tuple(vq_ema["sums"].shape) == plan.shape:
            return vq_ema
        return {**vq_ema, "sums": self.gather([vq_ema["sums"]], [plan])[0]}

    def shard_vq(self, vq_ema: Optional[dict]) -> Optional[dict]:
        if vq_ema is None:
            return None
        return {**vq_ema, "sums": self._cut("vq_ema.sums", vq_ema["sums"])}

    def gather_named(self, tensors: Mapping[str, torch.Tensor], keep: bool = True,
                     prefix: str = "g_model") -> Optional[dict[str, torch.Tensor]]:
        """The tensors given stay as they are; with ``keep=False`` this rank
        only serves its blocks."""
        names = [n for n, t in tensors.items() if f"{prefix}.{n}" in self.plans
                 and tuple(t.shape) != self.plans[f"{prefix}.{n}"].shape]
        full = self.gather([tensors[n].detach() for n in names],
                           [self.plans[f"{prefix}.{n}"] for n in names], keep=keep)
        if not keep:
            return None
        out = dict(tensors)
        out.update(zip(names, full))
        return out

    # -- checkpoints -----------------------------------------------------

    def _tree_slots(self, state: "TrainState", tree: dict
                    ) -> Iterator[tuple[dict, object, Plan]]:
        """(container, key, plan) of each sharded tensor of a
        ``checkpoint.state_tree``."""
        for prefix, opt in (("g_model", state.g_opt), ("d_model", state.d_opt)):
            if tree.get(prefix) is None:
                continue
            for name in tree[prefix]:
                if f"{prefix}.{name}" in self.plans:
                    yield tree[prefix], name, self.plans[f"{prefix}.{name}"]
            saved = tree[prefix.replace("model", "opt")]
            ids = [i for g in saved["param_groups"] for i in g["params"]]
            params = [p for g in opt.param_groups for p in g["params"]]
            for i, p in zip(ids, params):
                plan = self.plan_of(p)
                per = saved["state"].get(i)
                if plan is None or per is None:
                    continue
                for k, v in per.items():
                    if isinstance(v, torch.Tensor) and v.ndim == len(plan.shape):
                        yield per, k, plan
        if tree.get("g_ema") is not None:
            for name in tree["g_ema"]:
                if f"g_model.{name}" in self.plans:
                    yield tree["g_ema"], name, self.plans[f"g_model.{name}"]
        if tree.get("vq_ema") is not None and "vq_ema.sums" in self.plans:
            yield tree["vq_ema"], "sums", self.plans["vq_ema.sums"]

    def gather_tree(self, state: "TrainState", tree: dict, host: bool = True,
                    keep: bool = True) -> Optional[dict]:
        """In new containers (the state's own dicts stay as they are); the
        gathered tensors on the host with ``host``, else left where
        gathered; tensors already whole (G and D after ``gather_models``)
        stay. Collective over the fsdp group; with ``keep=False`` this rank
        takes part, drops each bucket as it is done and gets None."""
        tree = _own_containers(tree)
        slots = [(c, k, plan) for c, k, plan in self._tree_slots(state, tree)
                 if tuple(c[k].shape) == plan.block_shape(self.n)]
        full = self.gather([c[k] for c, k, _ in slots], [plan for _, _, plan in slots],
                           host=host, keep=keep)
        if not keep:
            return None
        for (container, key, _), value in zip(slots, full):
            container[key] = value
        return tree

    def shard_tree(self, state: "TrainState", tree: dict) -> dict:
        """In new containers."""
        tree = _own_containers(tree)
        for container, key, plan in list(self._tree_slots(state, tree)):
            if tuple(container[key].shape) != plan.shape:
                raise ValueError(f"checkpoint tensor {key} has shape "
                                 f"{tuple(container[key].shape)}, the model's {plan.shape}")
            container[key] = self.block(container[key], plan)
        return tree

    # -- the collective --------------------------------------------------

    def gather(self, blocks: list[torch.Tensor], plans: list[Plan], host: bool = False,
               keep: bool = True) -> list[Optional[torch.Tensor]]:
        """Whole tensors from every rank's blocks: the blocks in buckets
        (``mesh._buckets``), each owner's blocks of a bucket broadcast from it
        as one flat tensor. With
        ``host`` each whole tensor is copied to the CPU as its bucket is
        done, so the device holds one bucket's at a time; with ``keep=False``
        none is built (None), this rank only serving its blocks."""
        out: list[Optional[torch.Tensor]] = [None] * len(blocks)
        index = {id(t): i for i, t in enumerate(blocks)}
        for tensors in _buckets(blocks):
            run = [index[id(t)] for t in tensors]
            ref = blocks[run[0]]
            fulls = {i: torch.empty_strided(plans[i].shape, plans[i].stride, dtype=ref.dtype,
                                            device=ref.device) for i in run} if keep else {}
            sizes = [blocks[i].numel() for i in run]
            for j, src in enumerate(self.ranks):
                if j == self.index:
                    flat = torch.cat([blocks[i].reshape(-1) for i in run])
                else:
                    flat = torch.empty(sum(sizes), dtype=ref.dtype, device=ref.device)
                staged = _on_backend(flat, self.group)
                dist.broadcast(staged, src, group=self.group)
                for i, part in zip(fulls, staged.split(sizes)):
                    plan = plans[i]
                    size = plan.shape[plan.dim] // self.n
                    fulls[i].narrow(plan.dim, j * size, size).copy_(
                        part.view(plan.block_shape(self.n)))
            for i, full in fulls.items():
                out[i] = full.cpu() if host else full
        return out


def _own_containers(tree: dict) -> dict:
    """A copy of a ``checkpoint.state_tree``'s dicts down to its tensors: an
    optimizer's ``state_dict()`` and the EMAs share their dicts with the
    live state."""
    tree = dict(tree)
    for key in ("g_model", "d_model", "g_ema", "vq_ema"):
        if tree.get(key) is not None:
            tree[key] = dict(tree[key])
    for key in ("g_opt", "d_opt"):
        if tree.get(key) is not None:
            tree[key] = {**tree[key], "state": {i: dict(per)
                                                for i, per in tree[key]["state"].items()}}
    return tree


def shard_state(state: "TrainState", mesh: Mesh) -> "TrainState":
    """``state`` sharded over the mesh's fsdp axis (``FSDP.register``), or
    as it is (``Whole``) where the axis is 1."""
    if mesh.n_fsdp > 1:
        FSDP(mesh).register(state)
    return state
