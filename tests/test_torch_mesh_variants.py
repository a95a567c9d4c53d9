"""The last mesh gaps of the port held against the JAX package: LoRA on a
mesh, the Wan2.1 DiT under tensor parallelism and a multiview net under
context parallelism.

Four gloo ranks (tests/torch_dist_util.py, one start for the file) run, on
the same seeded NumPy inputs and weights that go through the JAX package:

- LoRA over test_parallel.py:162's tiny DiT (128 channels, 4 heads of 32;
  JAX's init perturbed by 0.05 N(0, 1) so that every adapted layer counts,
  JAX's adapters with ``b`` drawn nonzero) at fsdp 2 x tp 2 and at fsdp 2
  x cp 2 under Ulysses and ring: 3 trainer steps with EMA, fed JAX's
  draws, against JAX's one-device LoRA trainer (adapters merged into the
  base inside its step): losses, adapters and EMA at 1e-5, the base
  bit-equal on every rank;
- a DCP save of the fsdp 2 x tp 2 LoRA state after one step (adapters,
  EMA, moments, step; not the base), restored into a fresh wrapper: its
  next step, which reads the moments, equals the unbroken run's exactly
  (bf16 moments, whose rounding draws are saved too);
- training/train.py::launch with ``model.use_lora`` at fsdp_shard_size 2 x
  cp_size 2 on the mock data, 1 iteration saved (DCP) and resumed to 2,
  against the one-process launch saved and resumed alike;
- the Wan2.1 DiT (i2v, 4 heads) at tp 2 x fsdp 2: 3 trainer steps against
  the port's one-device steps at 1e-5 (the JAX trainer cannot drive Wan,
  ROADMAP C9); and on the virtual 8-device mesh JAX's own rule
  (``param_shardings``) at tp 2 against its unsharded forward at 2e-5.
  The port's Wan forward at tp 2 x fsdp 2 against JAX is
  tests/test_torch_mesh.py::test_parallelize_refuses_whole_width_norms_under_tp;
- the multiview DiT (3 views of 4 latent frames, view embeddings, 4
  caption tokens a view, with and without cross-view attention) at cp 4,
  each rank's slab of 3 frames crossing a view boundary, under Ulysses
  and ring, against JAX's unsharded forward at test_parallel.py:106's
  2e-4; JAX's own multiview net at cp 4 on the virtual mesh against its
  unsharded forward at the same bound (the check that JAX's route is
  right before the port's is held to it); and one training step of the
  cross-view net at fsdp 2 x cp 2 (slabs of 6 frames over views of 4)
  against the port's one-device step at 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_mesh import LATENT, LAUNCH, TRAIN_OPT, TRAIN_TOL, _batches, _jnet, _one_process_launch
from test_torch_mesh import jax_wan_forward, wan_tp_pair
from test_torch_training import jax_draws

from cosmos_predict2_tpu.conditioning.conditioner import make_condition as j_make_condition
from cosmos_predict2_tpu.models.video2world import RFModelConfig as JRFConfig
from cosmos_predict2_tpu.models.video2world import Video2WorldModel as JModel
from cosmos_predict2_tpu.networks import wan_dit as jwd
from cosmos_predict2_tpu.networks.dit import MiniTrainDIT as JDiT
from cosmos_predict2_tpu.parallel.mesh import make_mesh as j_make_mesh
from cosmos_predict2_tpu.parallel.mesh import param_shardings
from cosmos_predict2_tpu.training import lora as jlora
from cosmos_predict2_tpu.training.optim import OptimizerConfig as JOptimizerConfig
from cosmos_predict2_tpu.training.trainer import Trainer as JTrainer
from cosmos_predict2_tpu.training.trainer import TrainerConfig as JTrainerConfig
from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, Video2WorldModel
from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT
from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
from cosmos_predict2_tpu_torch.training.trainer import Trainer, TrainerConfig
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch, jax_lora_params_to_torch
from torch_dist_util import NamedRanks, _draws, _Record, start_ranks, wan_train
from torch_variants_util import jit_init, noisy_params, port_config, seeded_jax_params, tiny_jax_config

RANK, ALPHA = 4, 8.0
MV_TOL = 2e-4  # test_parallel.py:106's atol for a forward under cp
WAN_TOL = 2e-5  # test_parallel.py:135's
LORA_MESHES = {"fsdp2-tp2": ((1, 2, 1, 2), "ulysses"), "fsdp2-cp2-ulysses": ((1, 2, 2, 1), "ulysses"),
               "fsdp2-cp2-ring": ((1, 2, 2, 1), "ring")}
VIEWS, PER_VIEW = 3, 4  # 12 latent frames: 3 a rank at cp 4, 6 at cp 2, crossing views of 4
MV_LATENT = (1, 16, VIEWS * PER_VIEW, 4, 4)
CROSS_VIEW = ((1, 2), (0, 2), (0, 1))
MV_NETS = {"view embedding": {}, "cross-view": dict(enable_cross_view_attn=True, cross_view_attn_map=CROSS_VIEW)}
LORA_LAUNCH = LAUNCH + ["model.use_lora=True", "model.lora_rank=4", "data_train.batch_size=2"]


def _mv_config(fields: dict, **over):
    return tiny_jax_config(n_views=VIEWS, tokens_per_view=4, rope_enable_fps_modulation=False, model_channels=128,
                           num_heads=4, adaln_lora_dim=16, concat_view_embedding=True, view_condition_dim=4,
                           **fields, **over)


def _mv_inputs():
    rng = np.random.default_rng(5)
    return (rng.standard_normal(MV_LATENT).astype(np.float32), np.asarray([500.0], np.float32),
            rng.standard_normal((1, VIEWS * 4, 64)).astype(np.float32))


def _set_b(tree, rng):
    """``b`` ~ 0.05 N(0, 1) in place on every adapter of a JAX adapter tree."""
    for v in tree.values():
        if isinstance(v, dict) and set(v) == {"a", "b"}:
            v["b"] = (0.05 * rng.standard_normal(v["b"].shape)).astype(np.float32)
        elif isinstance(v, dict):
            _set_b(v, rng)


def _jax_lora_run(jmodel, params, lora):
    """JAX's one-device LoRA trainer, 3 steps with EMA: (losses, adapters, EMA)."""
    wrap = jlora.LoRAModelWrapper(jmodel, jax.tree.map(jnp.asarray, params), rank=RANK, alpha=ALPHA)
    trainer = JTrainer(JTrainerConfig(max_iter=3, logging_iter=10, save_iter=0, seed=0, ema_enabled=True,
                                      optimizer=JOptimizerConfig(**TRAIN_OPT)), wrap)
    losses = []

    class Capture:
        def __getattr__(self, name):
            if name == "on_training_step_end":
                return lambda trainer, state, metrics, iteration: losses.append(float(metrics["loss"]))
            return lambda *a, **k: None

    trainer.callbacks.callbacks.append(Capture())

    def batches():
        for latents, emb in _batches():
            x = jnp.asarray(latents)
            yield x, j_make_condition(jnp.asarray(emb)).replace(gt_frames=x)

    state = trainer.train(trainer.init_state(jax.tree.map(jnp.asarray, lora)), batches())
    flat = lambda tree: {n: t.numpy() for n, t in jax_lora_params_to_torch(jax.tree.map(np.asarray, tree)).items()}
    return losses, flat(state.params), flat(state.ema_params)


def _mv_train_case():
    """The cross-view multiview net's weights, one global batch of 2 and the
    port's draws for it."""
    jcfg = _mv_config(MV_NETS["cross-view"])
    x, t, ctx = _mv_inputs()
    tcfg = port_config(jcfg)
    sd = {n: a.numpy() for n, a in jax_dit_params_to_torch(
        jax.tree.map(np.asarray, seeded_jax_params(jcfg, x, t, ctx, seed=2)), tcfg).items()}
    rng = np.random.default_rng(6)
    latents = rng.standard_normal((2,) + MV_LATENT[1:]).astype(np.float32)
    emb = (0.5 * rng.standard_normal((2, VIEWS * 4, 64))).astype(np.float32)
    model = Video2WorldModel(RFModelConfig(net=tcfg, state_t=VIEWS * PER_VIEW), MiniTrainDIT(tcfg))
    d = model.sample_train_draws(torch.Generator().manual_seed(7), latents.shape)
    draws = {f.name: None if getattr(d, f.name) is None else getattr(d, f.name).numpy() for f in dataclasses.fields(d)}
    return tcfg, sd, [(latents, emb)], [draws]


def _wan_batches():
    out = []
    for i in range(3):
        rng = np.random.default_rng(10 + i)
        out.append((rng.standard_normal((2, 16, 2, 8, 8)).astype(np.float32),
                    (0.5 * rng.standard_normal((2, 512, 32))).astype(np.float32),
                    (0.5 * rng.standard_normal((2, 257, 48))).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def setup():
    """The JAX side: the LoRA base and adapters with JAX's one-device run
    and draws, the Wan pair, the multiview nets and their unsharded
    forwards."""
    jnet = _jnet()
    jmodel = JModel(JRFConfig(net=jnet, state_t=2))
    params = noisy_params(jit_init(jmodel.init_params, jax.random.PRNGKey(0), LATENT, text_len=8), seed=4)
    lora = jax.tree.map(np.asarray, jlora.init_lora_params(jax.random.PRNGKey(1), params, rank=RANK))
    _set_b(lora, np.random.default_rng(2))
    draws = []
    for it in range(3):
        d = jax_draws(jmodel, 0, it, LATENT)[0]
        draws.append({f.name: None if getattr(d, f.name) is None else getattr(d, f.name).numpy()
                      for f in dataclasses.fields(d)})
    tcfg = port_config(jnet)
    sd = {n: t.numpy() for n, t in jax_dit_params_to_torch(params, tcfg).items()}
    x, t, ctx = _mv_inputs()
    mv = {}
    for name, fields in MV_NETS.items():
        jcfg = _mv_config(fields)
        mv_params = seeded_jax_params(jcfg, x, t, ctx, seed=1)
        tcfg_mv = port_config(jcfg)
        mv[name] = dict(jcfg=jcfg, params=mv_params, cfg=tcfg_mv, want=np.asarray(JDiT(jcfg).apply(mv_params, x, t, ctx)),
                        sd={n: a.numpy() for n, a in jax_dit_params_to_torch(jax.tree.map(np.asarray, mv_params),
                                                                               tcfg_mv).items()})
    return dict(jmodel=jmodel, params=params, lora=lora, draws=draws, tcfg=tcfg, sd=sd,
                port_lora={n: t.numpy() for n, t in jax_lora_params_to_torch(lora).items()}, mv=mv,
                mv_inputs=(x, t, ctx), wan=wan_tp_pair())


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Every case of this file on four gloo ranks, in one start; the JAX-only
    tests run first, while the ranks work (their results are waited for at
    the first look)."""
    tmp = tmp_path_factory.mktemp("mesh_variants")
    cases = {}
    lora = dict(cfg=setup["tcfg"], state_dict=setup["sd"], lora=setup["port_lora"], batches=_batches(),
                draws=setup["draws"], rank=RANK, alpha=ALPHA)
    for name, (sizes, strategy) in LORA_MESHES.items():
        cases[f"lora {name}"] = ("mesh_lora_train", dict(lora, sizes=sizes, strategy=strategy))
    cases["lora_dcp"] = ("mesh_lora_resume", dict(lora, batches=_batches()[:2], sizes=(1, 2, 1, 2),
                                                  ckpt=str(tmp / "lora_dcp"),
                                                  optimizer=OptimizerConfig(moments_dtype="bfloat16", **TRAIN_OPT)))
    mesh_launch = LORA_LAUNCH + ["fsdp_shard_size=2", "cp_size=2"]
    cases["launch_lora_resume"] = ("launch_run", dict(overrides=mesh_launch + ["trainer.max_iter=1"],
                                                      ckpt_dir=str(tmp / "lora_ckpt"), resume_overrides=mesh_launch))
    _, _, wan_cfg, wan_sd, _ = setup["wan"]
    cases["wan_train"] = ("wan_train", dict(cfg=wan_cfg, state_dict=wan_sd, batches=_wan_batches(),
                                            sizes=(1, 2, 1, 2)))
    x, t, ctx = setup["mv_inputs"]
    for name, net in setup["mv"].items():
        for strategy in ("ulysses", "ring"):
            cases[f"mv {name} {strategy}"] = ("dit_forward", dict(cfg=dataclasses.replace(net["cfg"], cp_strategy=strategy),
                                                                  state_dict=net["sd"], x=x, t=t, ctx=ctx))
    mv_cfg, mv_sd, mv_batches, mv_draws = _mv_train_case()
    cases["mv_train"] = ("mesh_train", dict(cfg=mv_cfg, state_dict=mv_sd, batches=mv_batches, draws=mv_draws,
                                            sizes=(1, 2, 2, 1), state_t=VIEWS * PER_VIEW))
    started = NamedRanks(list(cases), start_ranks(tmp, 4, list(cases.values())))
    yield started
    started.ranks.results()  # reaps the processes even when no test looked


@pytest.fixture(scope="module")
def jax_lora(setup):
    return _jax_lora_run(setup["jmodel"], setup["params"], setup["lora"])


def test_jax_wan_param_shardings_at_tp2_match_unsharded(setup, ranks):
    """JAX's own rule on the Wan DiT at fsdp 2 x tp 2 (the virtual mesh):
    q / k / v / k_img / v_img and ffn_0 column parallel, o and ffn_2 row
    parallel, GSPMD summing the whole-width norms' squares; the forward
    matches its unsharded run."""
    jcfg, jparams, _, _, inputs = setup["wan"]
    want = jax_wan_forward(jcfg, jparams, inputs)
    mesh = j_make_mesh(1, 2, 1, 2, devices=jax.devices()[:4])
    with jax.set_mesh(mesh):
        shardings = param_shardings(jparams, mesh)
        q = shardings["params"]["blocks_0"]["self_attn"]["q"]["kernel"].spec
        assert q == P("fsdp", "tp")
        sharded = jax.device_put(jparams, shardings)
        args = [jnp.asarray(inputs[k]) for k in ("x", "t", "ctx", "y", "clip")]
        got = jax.jit(lambda p, x, t, ctx, y, clip: jwd.WanModel(jcfg).apply(
            p, x, t, ctx, y_B_C_T_H_W=y, frame_cond_crossattn_emb=clip))(sharded, *args)
    np.testing.assert_allclose(np.asarray(got), want, atol=WAN_TOL, rtol=WAN_TOL)


@pytest.mark.parametrize("strategy", ["ulysses", "ring"])
def test_jax_multiview_under_cp_matches_unsharded(setup, ranks, strategy):
    """JAX's multiview net with cross-view attention and view embeddings at
    cp_axis="cp", cp 4 on the virtual mesh (latent T sharded: slabs of 3
    frames over views of 4), against its unsharded forward at 2e-4: JAX's
    route is right, so the port is held to it (no C12). (It asks for
    ``ranks`` so that the rank processes work meanwhile.)"""
    net = setup["mv"]["cross-view"]
    x, t, ctx = setup["mv_inputs"]
    cp = dataclasses.replace(net["jcfg"], cp_axis="cp", cp_strategy=strategy)
    mesh = j_make_mesh(1, 1, 4, 1, devices=jax.devices()[:4])
    with jax.set_mesh(mesh):
        xs = jax.device_put(x, NamedSharding(mesh, P(None, None, "cp")))
        got = jax.jit(lambda p, a: JDiT(cp).apply(p, a, t, ctx))(net["params"], xs)
    np.testing.assert_allclose(np.asarray(got), net["want"], atol=MV_TOL)


@pytest.mark.parametrize("mesh", list(LORA_MESHES))
def test_mesh_lora_training_matches_jax(ranks, jax_lora, mesh):
    """3 trainer steps of LoRA over the frozen DiT sharded on the mesh,
    every rank's global losses and rank 0's adapters and EMA gathered
    whole, against JAX's one-device LoRA trainer; the base stays bit-equal
    on every rank; the adapters follow their layers over tp (a column
    projection's B and a row projection's A split, the other whole)."""
    want_losses, want_params, want_ema = jax_lora
    shares = ranks[f"lora {mesh}"]
    for losses, norms, _, base, _, _ in shares:
        np.testing.assert_allclose(losses, want_losses, rtol=TRAIN_TOL)
        assert norms == shares[0][1] and base
    _, _, placements, _, params, ema = shares[0]
    assert params.keys() == want_params.keys() == ema.keys()
    for n in want_params:
        np.testing.assert_allclose(params[n], want_params[n], atol=TRAIN_TOL, rtol=TRAIN_TOL, err_msg=n)
        np.testing.assert_allclose(ema[n], want_ema[n], atol=TRAIN_TOL, rtol=TRAIN_TOL, err_msg=n)
    for proj in ("self_attn.q_proj", "cross_attn.k_proj", "mlp.layer1"):  # (dp, fsdp x cp, tp)
        assert placements[f"blocks.0.{proj}.lora_A"] == ("R", "R", "R")
        assert placements[f"blocks.0.{proj}.lora_B"] == ("R", "R", "S(0)")
    for proj in ("self_attn.output_proj", "mlp.layer2"):
        assert placements[f"blocks.0.{proj}.lora_A"] == ("R", "R", "S(1)")
        assert placements[f"blocks.0.{proj}.lora_B"] == ("R", "R", "R")


def test_mesh_lora_dcp_resume_equals_unbroken(ranks):
    """The DCP route of a LoRA state at fsdp 2 x tp 2 saves the adapters,
    their EMA, the bf16 moments (with their rounding draws) and the step,
    and not the base; a fresh wrapper restored from it takes the next
    step (whose update reads the moments) exactly as the unbroken run, on
    every rank."""
    for saved, (unbroken, resumed) in ranks["lora_dcp"]:
        assert saved == ["ema_params", "grad_acc", "opt_step", "optimizer", "optimizer_extra", "params", "scheduler",
                         "step"]
        assert unbroken[0] == resumed[0] and len(unbroken[0]) == 1
        assert unbroken[3:] == resumed[3:] == (2, 2)
        for group in (1, 2):
            assert unbroken[group].keys() == resumed[group].keys()
            assert all(k.endswith((".lora_A", ".lora_B")) for k in unbroken[group])
            for n, a in unbroken[group].items():
                np.testing.assert_array_equal(resumed[group][n], a, err_msg=n)


def test_mesh_lora_launch_matches_one_process_and_resumes(ranks, tmp_path):
    """launch with model.use_lora at fsdp_shard_size 2 x cp_size 2 (the base
    sharded, then wrapped; every rank draws the adapters from the same
    generator), 1 iteration, saved (DCP) and resumed to 2 (its loader
    starting over, as JAX's launch does): the global losses are the
    one-process launch's, saved (torch.save) and resumed alike."""
    want = _one_process_launch(LORA_LAUNCH + ["trainer.max_iter=1"], ckpt_dir=str(tmp_path / "ckpt"),
                               resume_overrides=LORA_LAUNCH)
    assert len(want) == 2 and want[1] != want[0]
    for losses in ranks["launch_lora_resume"]:
        np.testing.assert_allclose(losses, want, rtol=TRAIN_TOL)


def test_wan_tp_training_matches_one_device(setup, ranks):
    """3 trainer steps of the Wan Video2World model (i2v, the trainer's own
    draws of the global batch) at tp 2 x fsdp 2 against the port's
    one-device run: losses and grad norms on every rank, rank 0's
    parameters gathered whole."""
    _, _, cfg, sd, _ = setup["wan"]
    want_losses, want_norms, want_params = wan_train(cfg, sd, _wan_batches())
    for losses, norms, _ in ranks["wan_train"]:
        np.testing.assert_allclose(losses, want_losses, rtol=TRAIN_TOL)
        np.testing.assert_allclose(norms, want_norms, rtol=TRAIN_TOL)
    params = ranks["wan_train"][0][2]
    assert params.keys() == want_params.keys()
    for n, w in want_params.items():
        np.testing.assert_allclose(params[n], w, atol=TRAIN_TOL, rtol=TRAIN_TOL, err_msg=n)


@pytest.mark.parametrize("strategy", ["ulysses", "ring"])
@pytest.mark.parametrize("net", list(MV_NETS))
def test_multiview_cp_forward_matches_jax(setup, ranks, net, strategy):
    """The port's multiview net at cp 4: each rank's slab of 3 latent frames
    crosses a view boundary (views of 4), so its per-view cross-attention
    runs a segment a view, and cross-view attention moves to the
    head-sharded layout; every rank's gathered output against JAX's
    unsharded forward."""
    want = setup["mv"][net]["want"]
    for got in ranks[f"mv {net} {strategy}"]:
        np.testing.assert_allclose(got, want, atol=MV_TOL)


def test_multiview_cp_training_step_matches_one_device(ranks):
    """One trainer step of the cross-view multiview net at fsdp 2 x cp 2
    (each rank one sample's slab of 6 frames: a whole view and half of
    the next) against the port's one-device step on the whole batch."""
    cfg, sd, batches, draws = _mv_train_case()
    net = MiniTrainDIT(cfg)
    net.load_state_dict({n: torch.from_numpy(a) for n, a in sd.items()}, strict=True)
    net.train().requires_grad_(True)
    model = Video2WorldModel(RFModelConfig(net=cfg, state_t=VIEWS * PER_VIEW), net)
    rec = _Record()
    trainer = Trainer(TrainerConfig(max_iter=1, logging_iter=100, save_iter=0, seed=0, ema_enabled=True,
                                    optimizer=OptimizerConfig(**TRAIN_OPT)), model, callbacks=[rec],
                      draw_fn=lambda it, x0: _draws(draws[it]))
    latents, emb = batches[0]
    x = torch.from_numpy(latents)
    state = trainer.train(trainer.init_state(), [(x, make_condition(torch.from_numpy(emb)).replace(gt_frames=x))])
    for losses, norms, _, _ in ranks["mv_train"]:
        np.testing.assert_allclose(losses, rec.losses, rtol=TRAIN_TOL)
        np.testing.assert_allclose(norms, rec.norms, rtol=TRAIN_TOL)
    params = ranks["mv_train"][0][2]
    for n, p in state.params.items():
        np.testing.assert_allclose(params[n], p.detach().numpy(), atol=TRAIN_TOL, rtol=TRAIN_TOL, err_msg=n)
