"""The port's ``fsdp`` mesh axis on the CPU: two gloo ranks under torchrun
holding the train state sharded at rest, against the same ranks with the
state whole (the ``data=2`` layout), one process on the global batch, and
the JAX package's sharding rule and step.

JAX shards every >= 2-D leaf of the train state over ``fsdp``
(``vqgan_tpu/parallel/mesh.py::_param_spec``, ``state_shardings``) and
gathers the weights for the step; the port's ranks do the same with a
broadcast per owner and the step's own gradient all_reduce
(``vqgan_tpu_torch/parallel/fsdp.py``). One torchrun launch of
tests/torch_dp_worker.py (2 ranks, one thread each, mesh ``data=1,
fsdp=2``) runs each of tests/test_torch_data_parallel.py's cases (2D
Gaussian, 2D VQ with revival, 3D GAN, 2D ``grad_accum`` 2) twice, whole and
sharded, replaying the one-process run's loss-head decisions, two steps
each; then three ``Trainer`` runs move checkpoints across layouts and a
``train3d`` run trains at ``fsdp=-1``. A second launch of 4 ranks at
``data=2,fsdp=2`` (two replicas of each block) runs the ``Trainer`` for 2
steps and resumes it for a third. This process runs the one-process cases
meanwhile (``_run_cases``):

  - the sharded run's gathered state equals the whole run's bit for bit
    after each step, and stays within tests/test_torch_train_step.py's
    bounds of the one-process step;
  - each rank holds at rest exactly the bytes the rule gives;
  - a save at ``fsdp=2`` restores bit for bit in one process, a save at
    ``data=2`` restores bit for bit at ``fsdp=2``, and a save at
    ``data=2,fsdp=2`` at the same mesh;
  - after ``train()`` the trainers' modules hold their whole parameters;
  - ``param_spec`` agrees with JAX's ``_param_spec`` on every parameter of
    tiny 2D and 3D models and their discriminators.

Marked slow (a JAX compile of ~25 s): the 2D Gaussian case against the JAX
step with its state sharded on a ``data=1,fsdp=2`` mesh.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.config import TVAEConfig as JaxTVAEConfig
from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.losses.discriminator import PatchDiscriminator as JaxDisc
from vqgan_tpu.losses.discriminator import TubeletDiscriminator as JaxTubelet
from vqgan_tpu.models.ae import VAE as JaxVAE
from vqgan_tpu.models.tae import TVAE as JaxTVAE
from vqgan_tpu.parallel.mesh import _param_spec
from vqgan_tpu.parallel.mesh import create_mesh as jax_create_mesh
from vqgan_tpu_torch.parallel.mesh import create_mesh, param_spec, rows_layout
from vqgan_tpu_torch.weights import jax_disc_params_to_state_dict, jax_params_to_state_dict

import test_torch_data_parallel as dp_test
import torch_dp_worker
from test_torch_train_step import TINY_VAE

RANKS = 2
MESH = {"data": 1, "fsdp": 2}
# the second launch: two data replicas of two blocks each
GRID_RANKS = 4
GRID = {"data": 2, "fsdp": 2}
CASES = ("2d-global", "2d-vq", "3d-gan", "2d-accum")


def _trainer_argv(ckpt: str, run: str, mesh: str, max_steps: int) -> list[str]:
    return ["--device", "cpu", "--vae_ch", "32", "--vae_ch_mult", "1,2",
            "--vae_num_res_blocks", "1", "--vae_z_channels", "8", "--vae_resolution", "32",
            "--image_size", "32", "--batch_size", "4", "--synthetic_data", "true",
            "--max_steps", str(max_steps), "--evaluate_every_n_steps", "2",
            "--eval_batches", "1", "--log_every", "1", "--use_wandb", "false",
            "--ema_decay", "0.5", "--mesh_shape", mesh, "--ckpt_dir", ckpt,
            "--run_name", run]


def _trainer3d_argv(ckpt: str) -> list[str]:
    return ["train3d", "--device", "cpu", "--vae_ch", "32", "--vae_ch_mult", "1,2",
            "--vae_num_res_blocks", "1", "--vae_z_channels", "4", "--vae_resolution", "16",
            "--frames", "4", "--batch_size", "2", "--max_steps", "2",
            "--evaluate_every_n_steps", "2", "--eval_batches", "1", "--use_wandb", "false",
            "--log_every", "1", "--mesh_shape", "data=1,fsdp=-1", "--ckpt_dir", ckpt,
            "--run_name", "fsdp3d"]


@pytest.fixture(scope="module")
def fsdp(tmp_path_factory):
    """(the cases, the one-process runs, each rank's output, the checkpoint
    dir, each rank's output of the 4-rank launch): one launch runs the
    cases whole and sharded, then the trainers: ``fsdp=2`` for 2 steps,
    ``data=2`` for 2 steps, ``fsdp=2`` resuming the latter to step 3, and
    ``train3d`` at ``fsdp=-1``; the 4-rank launch, meanwhile, the trainer
    at ``data=2,fsdp=2`` for 2 steps and resumed to step 3. The checkpoints
    (~200 MB each: D's VGG16 and its moments) are deleted after the
    module."""
    torch.set_num_threads(1)
    cases = [c for c in dp_test._cases(jax_side=False) if c["name"] in CASES]
    tmp = tmp_path_factory.mktemp("fsdp")
    ckpt = str(tmp / "ckpt")
    grid = dp_test._launch({"mesh": GRID, "trainer": [
        _trainer_argv(ckpt, "grid", "data=2,fsdp=2", 2),
        _trainer_argv(ckpt, "grid", "data=2,fsdp=2", 3)]}, tmp / "grid", nproc=GRID_RANKS)
    trainer = [_trainer_argv(ckpt, "sharded", "data=1,fsdp=2", 2),
               _trainer_argv(ckpt, "whole", "data=2", 2),
               _trainer_argv(ckpt, "whole", "data=1,fsdp=2", 3),
               _trainer3d_argv(ckpt)]
    try:
        one, ranks = dp_test._run_cases(cases, tmp, mesh=MESH, trainer=trainer)
    except BaseException:
        grid[0].kill()
        raise
    yield {c["name"]: c for c in cases}, one, ranks, ckpt, dp_test._collect(grid)
    shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the mesh and the rule


def test_unported_axes_still_raise():
    """``tensor`` above 1 (for either job), ``context`` above 1 for the 2D
    job and ``fsdp`` with ``context`` both above 1 for the 3D job raise
    naming their ROADMAP items; ``fsdp`` above 1 asks for ranks, as
    ``data`` does."""
    for axis, item in (("tensor", "tensor sharding"), ("context", "context: the 2D halo")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md, Queue 1: {item}"):
            create_mesh({"data": 1, axis: 2})
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1: tensor sharding"):
        create_mesh({"data": 1, "tensor": 2}, context=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1: fsdp x context"):
        create_mesh({"data": 1, "fsdp": 2, "context": 2}, context=True)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        create_mesh({"data": 1, "context": 2}, context=True)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        create_mesh({"data": 1, "fsdp": 2})
    mesh = create_mesh({"data": 1, "fsdp": -1})
    assert mesh.shape == {"data": 1, "fsdp": 1} and mesh.n_data == 1 and mesh.n_fsdp == 1


def _marked(tree, counter):
    """A tree of ShapeDtypeStructs as numpy arrays, each filled with its
    leaf number (a converter's transposes keep a constant array)."""
    if isinstance(tree, dict):
        return {k: _marked(v, counter) for k, v in tree.items()}
    counter.append(tuple(tree.shape))
    return np.full(tree.shape, len(counter) - 1, np.float32)


def _jax_trees() -> list[tuple[str, dict, callable]]:
    x2 = jnp.zeros((1, 32, 32, 3))
    x3 = jnp.zeros((1, 4, 16, 16, 3))
    key = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)}
    vq = JaxVAEConfig(**TINY_VAE, reg_type="vq", vq_codebook_size=32)
    tiny3d = dict(dp_test.TINY_3D, reg_type="vq", vq_codebook_size=32)
    return [
        ("vae", jax.eval_shape(JaxVAE(cfg=vq).init, key, x2)["params"],
         jax_params_to_state_dict),
        ("tvae", jax.eval_shape(JaxTVAE(cfg=JaxTVAEConfig(**tiny3d)).init, key, x3)["params"],
         jax_params_to_state_dict),
        ("disc", jax.eval_shape(JaxDisc().init, jax.random.PRNGKey(1), x2)["params"],
         jax_disc_params_to_state_dict),
        ("tubelet", jax.eval_shape(JaxTubelet().init, jax.random.PRNGKey(1),
                                   jnp.zeros((1, 3, 16, 16, 3)))["params"],
         jax_disc_params_to_state_dict),
    ]


# a torch weight's dim d is JAX's dim PERM[ndim][d] (weights.py's transposes)
PERM = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


@pytest.mark.parametrize("axes", [{"data": 2, "fsdp": 2, "tensor": 2}, {"data": 2, "fsdp": 4}])
def test_param_spec_matches_jax(eight_devices, axes):
    """For every parameter of a tiny VQ VAE, a tiny VQ TVAE, the patch D
    and the tubelet D (its depthwise temporal mixers), ``param_spec`` on
    the port's shape is JAX ``_param_spec`` on the JAX shape, dim for dim
    through the converters' transposes; and on the VQ sums (K, D)."""
    mesh = jax_create_mesh(dict(axes), devices=eight_devices)
    extents = dict(mesh.shape)
    sharded = 0
    for what, shapes, convert in _jax_trees():
        leaves: list = []
        sd = convert(_marked(shapes, leaves))
        assert len(sd) == len(leaves), what
        for name, t in sd.items():
            jax_shape = leaves[int(t.reshape(-1)[0])]
            want = tuple(_param_spec(jax_shape, mesh))
            want += (None,) * (len(jax_shape) - len(want))
            perm = PERM.get(t.ndim, tuple(range(t.ndim)))
            got = param_spec(tuple(t.shape), extents, rows=rows_layout(name))
            assert got == tuple(want[perm[d]] for d in range(t.ndim)), (what, name)
            sharded += "fsdp" in got
    for k, d in ((32, 8), (64, 16), (3, 4)):
        want = tuple(_param_spec((k, d), mesh))
        assert param_spec((k, d), extents, rows=True) == want + (None,) * (2 - len(want))
    assert sharded > 50


# ---------------------------------------------------------------------------
# the steps


def same(a, b) -> bool:
    return dp_test.same(a, b)


@pytest.mark.parametrize("name", CASES)
def test_sharded_step_is_the_whole_step_bitwise(fsdp, name):
    """After each of the two steps the sharded run's gathered state (G and
    D, both AdamW states, the Polyak and VQ EMAs, the anchors, the
    generator) is the whole run's bit for bit on both ranks (compared in
    the ranks, ``torch_dp_worker.same_tree``), with the same metrics; the
    whole tensors are equal on both ranks and the blocks on the ranks of a
    block (here one a block)."""
    _, _, ranks, _, _ = fsdp
    for r in ranks:
        whole, sharded = r[name]["data"], r[name]["fsdp"]
        assert sharded["same_as_whole"] == [True] * dp_test.STEPS, name
        assert sharded["metrics"] == whole["metrics"]
        assert sharded["replicas_equal"] == [True] * dp_test.STEPS
    assert same(ranks[0][name]["fsdp"]["params"], ranks[1][name]["fsdp"]["params"])


@pytest.mark.parametrize("name", CASES)
def test_sharded_step_makes_the_one_process_step(fsdp, name):
    """The sharded two-rank run against one process on the global batch:
    the metric curve, step 1's moments of G and D and the VQ statistics at
    tests/test_torch_train_step.py's bounds."""
    _, one, ranks, _, _ = fsdp
    dp_test._check_run(ranks[0][name]["fsdp"], one[name], vq=name == "2d-vq")


def _rule_bytes(tree: dict, param_names: dict, n: int) -> int:
    """The bytes a rank's blocks save against the whole state of ``tree``
    (a gathered ``state_dict_of``; ``param_names``: G's and D's parameters
    in order), by the rule: each sharded parameter, its AdamW moments and
    its Polyak EMA lose (n - 1) / n of their bytes, and so do the VQ
    sums."""
    saved = 0

    def cut(name: str, t: torch.Tensor) -> int:
        spec = param_spec(tuple(t.shape), {"fsdp": n}, rows=rows_layout(name))
        return t.numel() * t.element_size() * (n - 1) // n if "fsdp" in spec else 0

    for side in ("g", "d"):
        model = tree[f"{side}_model"]
        names = param_names[side]  # the optimizer's order
        opt = tree[f"{side}_opt"]
        ids = [i for g in opt["param_groups"] for i in g["params"]]
        for i, name in zip(ids, names):
            saved += cut(name, model[name])
            per = opt["state"].get(i, {})
            saved += sum(cut(name, per[k]) for k in ("exp_avg", "exp_avg_sq") if k in per)
    for name, t in (tree["g_ema"] or {}).items():
        saved += cut(name, t)
    if tree["vq_ema"] is not None:
        saved += cut("sums", tree["vq_ema"]["sums"])
    return saved


@pytest.mark.parametrize("name", CASES)
def test_each_rank_holds_its_blocks_at_rest(fsdp, name):
    """Between steps a sharded rank holds exactly the whole layout's bytes
    less what the rule shards away; the saving is most of the state."""
    _, _, ranks, _, _ = fsdp
    for r in ranks:
        whole, sharded = r[name]["data"], r[name]["fsdp"]
        for i in range(dp_test.STEPS):
            cut = _rule_bytes(whole["trees"][i], whole["param_names"], RANKS)
            assert sharded["held_bytes"][i] == whole["held_bytes"][i] - cut
            assert cut > 0.4 * whole["held_bytes"][i]


# ---------------------------------------------------------------------------
# checkpoints across layouts


def test_sharded_save_resumes_in_one_process(fsdp):
    """The ``fsdp=2`` job's step-2 save (written by rank 0 alone, gathered
    from both ranks) restores in one process bit for bit as the ranks'
    gathered state ended."""
    from vqgan_tpu_torch import cli
    from vqgan_tpu_torch.train.checkpoint import state_dict_of
    from vqgan_tpu_torch.train.trainer import Trainer

    _, _, ranks, ckpt, _ = fsdp
    first = [r["trainer"][0] for r in ranks]
    assert [r["mesh"] for r in first] == [{"data": 1, "fsdp": 2}] * RANKS
    assert [r["local_batch"] for r in first] == [2, 2]
    assert same(first[0]["trained"], first[1]["trained"]) and first[0]["trained"]["step"] == 2
    assert [r["whole_after_train"] for r in first] == [True] * RANKS
    assert sorted(os.listdir(os.path.join(ckpt, "sharded", "state"))) == [
        "step_00000001.pt", "step_00000002.pt"]
    assert os.path.exists(os.path.join(ckpt, "sharded", "eval", "test_images_step1.png"))
    argv = _trainer_argv(ckpt, "sharded", "data=-1", 3)
    cfg, vae_cfg = cli.configs(vars(cli.build_parser().parse_args(argv)))
    trainer = Trainer(cfg, vae_cfg, device="cpu")
    assert not trainer.state.layout.sharded and trainer.mesh.world_size == 1
    assert same(state_dict_of(trainer.state), first[0]["trained"])


def test_whole_save_resumes_sharded(fsdp):
    """The ``data=2`` job's step-2 save restores at ``fsdp=2`` bit for bit
    on both ranks (their gathered states), which train step 3; rank 0
    alone wrote every file."""
    _, _, ranks, ckpt, _ = fsdp
    whole = [r["trainer"][1] for r in ranks]
    resumed = [r["trainer"][2] for r in ranks]
    assert [r["mesh"] for r in resumed] == [{"data": 1, "fsdp": 2}] * RANKS
    for r in range(RANKS):
        assert same(resumed[r]["built"], whole[0]["trained"])
    assert same(resumed[0]["trained"], resumed[1]["trained"])
    assert resumed[0]["trained"]["step"] == 3
    assert [r["logs"] for r in resumed] == [True, False]
    assert sorted(os.listdir(os.path.join(ckpt, "whole", "state"))) == [
        "step_00000001.pt", "step_00000002.pt", "step_00000003.pt"]


def test_sharded_trainer3d(fsdp):
    """``train3d --mesh_shape data=1,fsdp=-1`` over 2 ranks: one clip a
    rank, 2 steps, eval and saves; the ranks' gathered states agree."""
    _, _, ranks, ckpt, _ = fsdp
    runs = [r["trainer"][3] for r in ranks]
    assert [r["mesh"] for r in runs] == [{"data": 1, "fsdp": 2}] * RANKS
    assert [r["local_batch"] for r in runs] == [1, 1]
    assert same(runs[0]["trained"], runs[1]["trained"]) and runs[0]["trained"]["step"] == 2
    assert [r["whole_after_train"] for r in runs] == [True] * RANKS
    assert sorted(os.listdir(os.path.join(ckpt, "fsdp3d", "state"))) == [
        "step_00000001.pt", "step_00000002.pt"]


def test_two_replicas_of_each_block_train_save_and_resume(fsdp):
    """``--mesh_shape data=2,fsdp=2`` over 4 ranks: the replicas of a block
    (ranks 0 and 2, ranks 1 and 3) are checked equal at start-up and after
    the restore, one image a rank; 2 steps with an eval and saves, then a
    resume to step 3 that restores the step-2 save bit for bit on every
    rank; every rank ends in the same gathered state with its modules
    whole, and rank 0 alone logs and writes."""
    _, _, _, ckpt, grid = fsdp
    for run in range(2):
        got = [r["trainer"][run] for r in grid]
        assert [r["mesh"] for r in got] == [GRID] * GRID_RANKS
        assert [r["local_batch"] for r in got] == [1] * GRID_RANKS
        assert [r["logs"] for r in got] == [True] + [False] * (GRID_RANKS - 1)
        assert [r["whole_after_train"] for r in got] == [True] * GRID_RANKS
        assert all(same(r["trained"], got[0]["trained"]) for r in got[1:])
        assert got[0]["trained"]["step"] == 2 + run
    first, resumed = ([r["trainer"][run] for r in grid] for run in range(2))
    for r in range(GRID_RANKS):
        assert same(resumed[r]["built"], first[0]["trained"])
    assert sorted(os.listdir(os.path.join(ckpt, "grid", "state"))) == [
        "step_00000001.pt", "step_00000002.pt", "step_00000003.pt"]


# ---------------------------------------------------------------------------
# against the JAX step with its state sharded over fsdp


@pytest.fixture(scope="module")
def fsdp_jax(tmp_path_factory):
    """The 2D Gaussian case with JAX params and the JAX step's draws, run
    whole and sharded by the two ranks."""
    torch.set_num_threads(1)
    cases = [c for c in dp_test._cases(jax_side=True) if c["name"] == "2d-global"]
    _, ranks = dp_test._run_cases(cases, tmp_path_factory.mktemp("fsdp_jax"), mesh=MESH)
    return cases[0], ranks


def _jax_run_sharded(case: dict, devices) -> dict:
    """``dp_test._jax_run`` for a 2D case with the JAX train state laid out
    by ``state_shardings`` and the batch by ``batch_sharding`` on a
    ``data=1,fsdp=2`` mesh of two CPU devices (JAX's ``n_data`` 2)."""
    from vqgan_tpu.config import TrainConfig as JaxTrainConfig
    from vqgan_tpu.losses.lpips import LPIPS as JaxLPIPS
    from vqgan_tpu.parallel.mesh import batch_sharding, state_shardings
    from vqgan_tpu.train.state import create_train_state as jax_state
    from vqgan_tpu.train.state import make_discriminator_optimizer as jax_d_opt
    from vqgan_tpu.train.state import make_generator_optimizer as jax_g_opt
    from vqgan_tpu.train.step import make_train_step as jax_step_2d
    from test_torch_train_step import _mu_tree

    mesh = jax_create_mesh(dict(MESH), devices=devices)
    jp = case["jax"]
    cfg_j = JaxTrainConfig(**case["train"])
    model_cfg = JaxVAEConfig(**case["model"])
    model = JaxVAE(cfg=model_cfg)
    state = jax.jit(lambda g, d: jax_state(cfg_j, g, d, model_cfg.ch,
                                           jax.random.PRNGKey(dp_test.RNG0))[0])(jp["g"], jp["d"])
    state = jax.device_put(state, state_shardings(state, mesh))
    specs = [s.spec for s in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda a: a.sharding, state.g_params))]
    assert sum("fsdp" in tuple(s) for s in specs) > 10
    g_tx, d_tx = jax_g_opt(cfg_j, model_cfg.ch, jp["g"]), jax_d_opt(cfg_j)
    step = jax.jit(jax_step_2d(cfg_j, model_cfg, model, JaxDisc(), JaxLPIPS(), g_tx, d_tx,
                               gradnorm_shards=mesh.shape["data"] * mesh.shape["fsdp"]),
                   static_argnums=(3,))
    out = {"metrics": []}
    with mesh:
        for i, batch in enumerate(case["batches"]):
            x = jax.device_put(jnp.asarray(batch), batch_sharding(mesh))
            state, m = step(state, x, jp["lpips"], 0)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                out["exp_avg_g"] = jax_params_to_state_dict(_mu_tree(jax.device_get(state.g_opt)))
                out["exp_avg_d"] = jax_disc_params_to_state_dict(
                    _mu_tree(jax.device_get(state.d_opt)))
    out["params"] = jax_params_to_state_dict(jax.device_get(state.g_params))
    out["vq_ema"] = None
    return out


@pytest.mark.slow
def test_sharded_step_makes_the_jax_step_on_an_fsdp_mesh(fsdp_jax, eight_devices):
    """The port's ``fsdp=2`` run against the JAX step whose state XLA keeps
    sharded over ``fsdp`` (JAX's own draws, ``gradnorm_shards`` 2): the
    metric curve and step 1's moments at tests/test_torch_train_step.py's
    bounds; the port's two layouts bitwise."""
    case, ranks = fsdp_jax
    run = ranks[0]["2d-global"]
    assert run["fsdp"]["same_as_whole"] == [True] * dp_test.STEPS
    dp_test._check_run(run["fsdp"], _jax_run_sharded(case, eight_devices[:2]), vq=False)
