"""The variants' training steps held against the JAX package on the CPU
(fp32, seeded weights, JAX's draws fed in): Wan2.1's and EDM's
``training_step``, the action-conditioned and multiview training steps,
the DiT's ``view_indices_B_T``, the two training experiment names' configs
and launch (the action name's refusal, ROADMAP C8), and the trainer over
the Wan and EDM models (which the JAX trainer cannot drive, C9).

Tolerances: 1e-4 relative on the losses, as tests/test_torch_training.py;
gradients per parameter within 1e-4 relative L2 and 2.5e-4 of the
gradient's largest entry, as there; 1e-5 relative L2 on a DiT forward, as
tests/torch_variants_util.py.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.conditioning import conditioner as jcond
from cosmos_predict2_tpu.configs.defaults import make_config as jax_make_config
from cosmos_predict2_tpu.models import action_conditioned as jac
from cosmos_predict2_tpu.models import edm as jedm
from cosmos_predict2_tpu.models import multiview as jmv
from cosmos_predict2_tpu.models import wan_video2world as jwv
from cosmos_predict2_tpu.models.video2world import RFModelConfig as JRFConfig
from cosmos_predict2_tpu.models.video2world import Video2WorldModel as JModel
from cosmos_predict2_tpu.networks import wan_dit as jwd
from cosmos_predict2_tpu.networks.dit import PRESETS
from cosmos_predict2_tpu.networks.dit import MiniTrainDIT as JDiT
from cosmos_predict2_tpu.training.trainer import Trainer as JTrainer
from cosmos_predict2_tpu.training.trainer import TrainerConfig as JTrainerConfig
from cosmos_predict2_tpu.utils.checkpoint_convert import convert_wan_dit_state_dict as jax_convert_wan
from cosmos_predict2_tpu_torch.conditioning import conditioner as tcond
from cosmos_predict2_tpu_torch.configs.defaults import make_config
from cosmos_predict2_tpu_torch.models import action_conditioned as tac
from cosmos_predict2_tpu_torch.models import edm as tedm
from cosmos_predict2_tpu_torch.models import multiview as tmv
from cosmos_predict2_tpu_torch.models import wan_video2world as twv
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, TrainDraws
from cosmos_predict2_tpu_torch.networks import wan_dit as twd
from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
from cosmos_predict2_tpu_torch.training.trainer import Trainer, TrainerConfig
from cosmos_predict2_tpu_torch.utils.checkpoint_convert import convert_wan_dit_state_dict
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch
from torch_variants_util import REL_L2, jit_init, noisy_params, port_net, rel_l2, seeded_jax_params, tiny_jax_config

LOSS_REL = 1e-4
GRAD_REL_L2 = 1e-4
GRAD_MAX = 2.5e-4
TRAINING_NAMES = ("ac_reason_embeddings_rectified_flow_2b_256_320", "predict2_multiview_post_train_waymo")


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _assert_grads(got: dict, want: dict) -> None:
    """Every parameter's gradient against JAX's, both by the port's names."""
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) <= GRAD_MAX * scale, (name, float((g - w).abs().max()), scale)
        assert float((g - w).norm()) <= GRAD_REL_L2 * max(float(w.norm()), 1e-12), name


def _rf_draws(jmodel: JModel, rng, shape) -> TrainDraws:
    """JAX Video2WorldModel.training_step's draws for ``rng`` (no dropout:
    the step is called directly, as the JAX tests call it)."""
    B = shape[0]
    rng_eps, rng_t, rng_k, _ = jax.random.split(rng, 4)
    return TrainDraws(text_keep=torch.ones(B, dtype=torch.bool), use_video=torch.tensor(True),
                      num_conditional_frames=t(jmodel.sample_num_conditional_frames(rng_k, B)).long(),
                      eps=t(jax.random.normal(rng_eps, shape, dtype=jnp.float32)),
                      u=t(jmodel.rectified_flow.sample_train_time(rng_t, B)))


def _dit_step_matches_jax(jmodel, params, tmodel, x0, jc, tc, rng) -> None:
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.training_step(p, rng, jnp.asarray(x0), jc), has_aux=True))(params)
    net = tmodel.net.requires_grad_(True)
    loss, _ = tmodel.training_step(t(x0), tc, _rf_draws(jmodel, rng, x0.shape))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_REL)
    _assert_grads(dict(net.named_parameters()), jax_dit_params_to_torch(jax.tree.map(np.asarray, jgrads), net.cfg))


# -------------------------------- Wan2.1 --------------------------------


def _wan_reference_state_dict(cfg: twd.WanConfig, seed: int) -> dict:
    """A released-layout state dict drawn with NumPy on the port module's
    shapes (no padding-mask channel in the patch embedding)."""
    with torch.device("meta"):
        net = twd.WanModel(cfg)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in net.state_dict().items():
        shape = (v.shape[0], cfg.in_dim * 4) if k == "patch_embedding.weight" else tuple(v.shape)
        noise = rng.standard_normal(shape).astype(np.float32)
        if k.endswith("modulation"):
            sd[k] = noise / np.sqrt(cfg.dim)
        elif k.endswith("bias"):
            sd[k] = 0.05 * noise
        elif len(shape) == 1:
            sd[k] = 1.0 + 0.05 * noise
        else:
            sd[k] = noise / np.sqrt(shape[1])
    return sd


def _jax_wan_grads_by_port_name(jgrads, ref_sd: dict, num_layers: int) -> dict:
    """JAX's Wan gradients laid out as the port's parameters: each value of a
    probe state dict (1, 2, 3, ... over every entry) is followed through
    both packages' converters; the padding-mask columns the port's
    converter appends (probe value 0) take zeros."""
    probe, start = {}, 1
    for k, v in ref_sd.items():
        probe[k] = np.arange(start, start + v.size, dtype=np.float64).reshape(v.shape)
        start += v.size
    values = np.concatenate([np.ravel(l) for l in jax.tree.leaves(jax_convert_wan(probe, num_layers, i2v=True))])
    grads = np.concatenate([np.ravel(np.asarray(g)) for g in jax.tree.leaves(jgrads)])
    order = np.argsort(values)
    out = {}
    for k, v in convert_wan_dit_state_dict({k: torch.from_numpy(p) for k, p in probe.items()}).items():
        flat = v.numpy().ravel()
        pos = order[np.searchsorted(values[order], flat)]
        pos = np.where(flat > 0, pos, 0)
        assert np.array_equal(values[pos][flat > 0], flat[flat > 0]), k
        out[k] = torch.from_numpy(np.where(flat > 0, grads[pos], 0.0).astype(np.float32).reshape(v.shape))
    return out


def test_wan_training_step_matches_jax():
    """tests/test_wan_dit.py's Wan layer (the test preset, i2v, frame 0
    conditional, 16 text tokens) on seeded reference weights: the loss and
    every parameter's gradient against jax.grad of JAX's training_step."""
    jcfg = jwd.WAN_PRESETS["test"]
    names = {f.name for f in dataclasses.fields(twd.WanConfig)} - {"dtype"}
    tcfg = twd.WanConfig(dtype=torch.float32, **{n: getattr(jcfg, n) for n in names})
    sd = _wan_reference_state_dict(tcfg, seed=0)
    jparams = jax.tree.map(jnp.asarray, jax_convert_wan(sd, jcfg.num_layers, i2v=True))
    net = twd.WanModel(tcfg)
    net.load_state_dict(convert_wan_dit_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}), strict=True)
    jmodel = jwv.WanVideo2WorldModel(jwv.WanModelConfig(net=jcfg, state_t=2))
    tmodel = twv.WanVideo2WorldModel(twv.WanModelConfig(net=tcfg, state_t=2), net)
    assert tmodel.config.rectified_flow == dataclasses.replace(tmodel.config.rectified_flow, **dataclasses.asdict(
        jmodel.config.rectified_flow)) and tmodel.config.loss_scale == jmodel.config.loss_scale

    shape = (1, 16, 2, 8, 8)
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal(shape).astype(np.float32)
    ctx = (0.02 * rng.standard_normal((1, 16, 4096))).astype(np.float32)
    clip = (0.02 * rng.standard_normal((1, 257, 1280))).astype(np.float32)
    mask = np.zeros((1, 1, 2, 1, 1), np.float32)
    mask[:, :, 0] = 1.0
    jc = jwv.WanCondition(crossattn_emb=jnp.asarray(ctx), clip_emb=jnp.asarray(clip), gt_frames=jnp.asarray(x0),
                          condition_video_mask=jnp.asarray(mask))
    key = jax.random.PRNGKey(4)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.training_step(p, key, jnp.asarray(x0), jc),
                                                    has_aux=True))(jparams)
    rng_eps, rng_t = jax.random.split(key)
    draws = twv.WanTrainDraws(eps=t(jax.random.normal(rng_eps, shape, dtype=jnp.float32)),
                              u=t(jmodel.rectified_flow.sample_train_time(rng_t, 1)))
    tc = twv.WanCondition(crossattn_emb=t(ctx), clip_emb=t(clip), gt_frames=t(x0), condition_video_mask=t(mask))
    loss, metrics = tmodel.training_step(t(x0), tc, draws)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_REL)
    assert set(metrics) == {"loss"}
    want = _jax_wan_grads_by_port_name(jgrads, sd, jcfg.num_layers)
    _assert_grads(dict(net.named_parameters()), want)


# --------------------------------- EDM ---------------------------------


@pytest.mark.parametrize("k_case", ["text", "video"])
def test_edm_training_step_matches_jax(k_case):
    """tests/test_edm.py's EDM model (the test preset at 2 latent frames;
    with gt_frames, JAX's per-sample conditional frames) on seeded noisy
    weights: loss, sigma_mean and every gradient against jax.grad of
    JAX's training_step, with its three draws."""
    jnet = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="none")
    jmodel = jedm.EDMVideo2WorldModel(jedm.EDMModelConfig(model=JRFConfig(net=jnet, state_t=2)))
    shape = (2, 16, 2, 8, 8)
    params = jax.tree.map(jnp.asarray, noisy_params(jit_init(jmodel.init_params, jax.random.PRNGKey(0), shape, 8)))
    rng = np.random.default_rng(2)
    x0 = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    emb = (0.05 * rng.standard_normal((2, 8, 1024))).astype(np.float32)
    jc = jcond.make_condition(jnp.asarray(emb))
    tc = tcond.make_condition(t(emb))
    if k_case == "video":
        jc, tc = jc.replace(gt_frames=jnp.asarray(x0)), tc.replace(gt_frames=t(x0))
    key = jax.random.PRNGKey(3)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.training_step(p, key, jnp.asarray(x0), jc),
                                                     has_aux=True))(params)
    net = port_net(params, jnet).requires_grad_(True)
    tmodel = tedm.EDMVideo2WorldModel(tedm.EDMModelConfig(model=RFModelConfig(net=net.cfg, state_t=2)), net)
    assert (tmodel.config.p_mean, tmodel.config.p_std) == (jmodel.config.p_mean, jmodel.config.p_std)
    rng_s, rng_e, rng_k = jax.random.split(key, 3)
    draws = tedm.EDMTrainDraws(num_conditional_frames=t(jmodel.base.sample_num_conditional_frames(rng_k, 2)).long(),
                               sigma_n=t(jax.random.normal(rng_s, (2,))),
                               eps=t(jax.random.normal(rng_e, shape, dtype=jnp.float32)))
    loss, metrics = tmodel.training_step(t(x0), tc, draws)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_REL)
    assert float(metrics["sigma_mean"]) == pytest.approx(float(jm["sigma_mean"]), rel=1e-6)
    _assert_grads(dict(net.named_parameters()), jax_dit_params_to_torch(jax.tree.map(np.asarray, jgrads), net.cfg))


# ---------------------------- action, multiview ----------------------------


def test_action_conditioned_training_step_matches_jax():
    """tests/test_action_conditioned.py's training step (7 x 4 actions, 2
    latent frames of 8 x 8) through ActionConditionedVideo2WorldModel."""
    jnet = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="none")
    jcfg = jac.action_conditioned_model_config(jnet, action_dim=7, num_action_per_chunk=4, state_t=2)
    jmodel = jac.ActionConditionedVideo2WorldModel(jcfg)
    shape = (1, 16, 2, 8, 8)
    params = jax.tree.map(jnp.asarray, noisy_params(jit_init(
        jmodel.net.init, jax.random.PRNGKey(0), jnp.zeros(shape), jnp.zeros((1,)), jnp.zeros((1, 8, 1024)),
        condition_mask=jnp.zeros((1, 1, 2, 8, 8)), action=jnp.zeros((1, 4, 7)))))
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(1), shape))
    action = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, 4, 7)) * 0.1)
    jc = jcond.make_condition(jnp.zeros((1, 8, 1024))).replace(gt_frames=jnp.asarray(x0), action=jnp.asarray(action))
    net = port_net(params, jcfg.net)
    tcfg = tac.action_conditioned_model_config(net.cfg, action_dim=7, num_action_per_chunk=4, state_t=2)
    tmodel = tac.ActionConditionedVideo2WorldModel(tcfg, net)
    tc = tcond.make_condition(torch.zeros((1, 8, 1024))).replace(gt_frames=t(x0), action=t(action))
    _dit_step_matches_jax(jmodel, params, tmodel, x0, jc, tc, jax.random.PRNGKey(3))
    with pytest.raises(ValueError, match="no action passed"):  # C8's refusal, in the port's words
        tmodel.training_step(t(x0), tc.replace(action=None), _rf_draws(jmodel, jax.random.PRNGKey(3), shape))


def test_multiview_training_step_matches_jax():
    """tests/test_multiview.py's training step: 3 views of 2 latent frames,
    4 caption tokens a view, the per-view condition set, then JAX's
    training_step's own conditional-frame draw on the packed axis."""
    V, Tv = 3, 2
    jnet = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="none", tokens_per_view=4)
    jcfg = jmv.multiview_model_config(jnet, n_views=V, state_t=Tv, view_condition_dim=4)
    jmodel = jmv.MultiviewVid2VidModel(jcfg)
    shape = (1, 16, V * Tv, 4, 4)
    params = jax.tree.map(jnp.asarray, noisy_params(jit_init(jmodel.init_params, jax.random.PRNGKey(0), shape,
                                                             text_len=V * 4)))
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(1), shape))
    emb = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, V * 4, 1024)) * 0.02)
    jc = jmodel.set_multiview_condition(jcond.make_condition(jnp.asarray(emb)), jnp.asarray(x0), 1)
    net = port_net(params, jcfg.net)
    tcfg = tmv.multiview_model_config(net.cfg, n_views=V, state_t=Tv, view_condition_dim=4)
    tmodel = tmv.MultiviewVid2VidModel(tcfg, net)
    tc = tmodel.set_multiview_condition(tcond.make_condition(t(emb)), t(x0), 1)
    np.testing.assert_array_equal(tc.condition_video_mask.numpy(), np.asarray(jc.condition_video_mask))
    _dit_step_matches_jax(jmodel, params, tmodel, x0, jc, tc, jax.random.PRNGKey(3))


# --------------------------- view_indices_B_T ---------------------------


@pytest.mark.parametrize("indices", [[[0, 0, 1, 1, 2, 2], [2, 2, 0, 0, 1, 1]], [[0, 9, 1, -3, 6, 7], [7, 2, 0, 0, 5, 1]]],
                         ids=["views", "clipped"])
def test_dit_view_indices_match_jax(indices):
    """The DiT with per-(view, frame) view indices (B 2, 3 views of 2
    frames): JAX gathers the view table at each index clipped to
    [0, n_cameras_emb - 1], channels [x | cond | pad | view]; the indices
    move the output off the default views 0, 1, 2."""
    V, Tv = 3, 2
    jcfg = tiny_jax_config(n_views=V, concat_view_embedding=True, view_condition_dim=4, concat_condition_mask=True,
                           tokens_per_view=4, rope_enable_fps_modulation=False)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, V * Tv, 8, 8)).astype(np.float32)
    ts = np.asarray([300.0, 800.0], np.float32)
    ctx = rng.standard_normal((2, V * 4, 64)).astype(np.float32)
    idx = np.asarray(indices, np.int32)
    params = seeded_jax_params(jcfg, x, ts, ctx)
    want = JDiT(jcfg).apply(params, x, ts, ctx, view_indices_B_T=jnp.asarray(idx))
    net = port_net(params, jcfg)
    with torch.no_grad():
        got = net(*map(torch.from_numpy, (x, ts, ctx)), view_indices_B_T=torch.from_numpy(idx))
        default = net(*map(torch.from_numpy, (x, ts, ctx)))
    assert rel_l2(got.numpy(), want) <= REL_L2
    assert rel_l2(default.numpy(), want) > 1e-4


# --------------------------- the training names ---------------------------


@pytest.mark.parametrize("name", TRAINING_NAMES)
def test_training_names_build_the_jax_configs(name):
    """Both names are registered, with JAX's make_config field by field."""
    from test_torch_released import _same

    tc, jc = make_config(name), jax_make_config(name)
    for group in ("model", "tokenizer", "trainer", "data_train"):
        _same(getattr(tc, group), getattr(jc, group), group + ".")


TOY = ["model.net.model_channels=256", "model.net.num_heads=2", "model.net.num_blocks=1", "model.net.adaln_lora_dim=32",
       "model.net.crossattn_proj_in_channels=1024", "data_train.height=32", "data_train.width=32", "tokenizer.dim=16"]


def test_action_name_launch_refuses_without_actions_c8(monkeypatch):
    """The action recipe's launch builds the net with action embedders over
    mock clips, which carry no actions; like JAX's (whose net raises
    "config.action_dim set but no action passed" in the first step), it
    refuses at its first training step, and trains nothing."""
    from cosmos_predict2_tpu_torch.training import train

    jnet = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="none", action_dim=84,
                               concat_condition_mask=True)
    jmodel = JModel(JRFConfig(net=jnet, state_t=2))
    shape = (1, 16, 2, 4, 4)
    params = jit_init(jmodel.net.init, jax.random.PRNGKey(0), jnp.zeros(shape), jnp.zeros((1,)),
                      jnp.zeros((1, 8, 1024)), action=jnp.zeros((1, 12, 84)))
    jc = jcond.make_condition(jnp.zeros((1, 8, 1024))).replace(gt_frames=jnp.zeros(shape))
    with pytest.raises(ValueError, match="config.action_dim set but no action passed"):
        jmodel.training_step(params, jax.random.PRNGKey(1), jnp.zeros(shape), jc)

    monkeypatch.setenv("COSMOS_SMOKE", "1")
    monkeypatch.setattr("cosmos_predict2_tpu_torch.utils.flags.SMOKE", True)
    steps = []
    monkeypatch.setattr("cosmos_predict2_tpu_torch.training.trainer.Trainer.train_step",
                        functools.partialmethod(_counting_step, steps))
    cfg = make_config(TRAINING_NAMES[0], TOY)
    assert cfg.model.net.action_dim == 84 and cfg.data_train.num_frames == 13
    with pytest.raises(ValueError, match="config.action_dim set but no action passed.*C8"):
        train.launch(cfg, device="cpu")
    assert steps == [0]


_real_train_step = Trainer.train_step


def _counting_step(self, steps, state, x0, condition, iteration):
    steps.append(iteration)
    return _real_train_step(self, state, x0, condition, iteration)


def test_multiview_name_launch_trains_on_data_that_divides_among_its_views(monkeypatch):
    """The Waymo recipe's launch (Video2WorldModel over mock clips, as JAX's)
    refuses a clip whose 3 latent frames do not divide among 7 views and a
    512-token caption for 7 views; on 25 frames (7 latent frames, one a
    view) and 7 x 512 caption tokens it trains."""
    from cosmos_predict2_tpu_torch.training import train

    monkeypatch.setattr("cosmos_predict2_tpu_torch.utils.flags.SMOKE", True)
    with pytest.raises(ValueError, match="7 views of equal length"):
        train.launch(make_config(TRAINING_NAMES[1], TOY), device="cpu")
    with pytest.raises(ValueError, match="caption holds"):
        train.launch(make_config(TRAINING_NAMES[1], TOY + ["data_train.num_frames=25"]), device="cpu")
    state = train.launch(make_config(TRAINING_NAMES[1], TOY + ["data_train.num_frames=25", "data_train.text_len=3584"]),
                         device="cpu")
    assert state.step == 2


# ------------------------- the trainer over Wan and EDM -------------------------


def _tiny_wan_model(seed=0):
    tcfg = twd.WanConfig(dim=96, ffn_dim=192, num_heads=2, num_layers=2, text_dim=32, clip_dim=48,
                         dtype=torch.float32)
    net = twd.WanModel(tcfg)
    net.load_state_dict(convert_wan_dit_state_dict(
        {k: torch.from_numpy(v) for k, v in _wan_reference_state_dict(tcfg, seed).items()}), strict=True)
    return twv.WanVideo2WorldModel(twv.WanModelConfig(net=tcfg, state_t=2), net.train())


def _wan_batches(n):
    for i in range(n):
        rng = np.random.default_rng(10 + i)
        x0 = torch.from_numpy(rng.standard_normal((1, 16, 2, 8, 8)).astype(np.float32))
        yield x0, twv.make_i2v_condition(torch.from_numpy((0.5 * rng.standard_normal((1, 512, 32))).astype(np.float32)),
                                         x0, torch.from_numpy((0.5 * rng.standard_normal((1, 257, 48))).astype(np.float32)))


def _edm_batches(n):
    for i in range(n):
        rng = np.random.default_rng(20 + i)
        x0 = torch.from_numpy((0.5 * rng.standard_normal((1, 16, 2, 8, 8))).astype(np.float32))
        emb = torch.from_numpy((0.05 * rng.standard_normal((1, 8, 64))).astype(np.float32))
        yield x0, tcond.make_condition(emb).replace(gt_frames=x0)


@pytest.mark.parametrize("family", ["wan", "edm"])
def test_trainer_drives_wan_and_edm_c9(family):
    """The port's Trainer trains the Wan and the EDM model (no conditioning
    dropout: their steps draw none), its first loss that of the model's own
    training_step on the default draws; the JAX trainer raises
    AttributeError on both (it reads model.config.text_dropout_rate, C9)."""
    shape = (1, 16, 2, 8, 8)
    if family == "wan":
        jmodel = jwv.WanVideo2WorldModel(jwv.WanModelConfig(net=jwd.WAN_PRESETS["test"], state_t=2))
        model, batches = _tiny_wan_model(), _wan_batches
        jc = jwv.WanCondition(crossattn_emb=jnp.zeros((1, 16, 4096)), clip_emb=jnp.zeros((1, 257, 1280)))
    else:
        jnet = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="none")
        jmodel = jedm.EDMVideo2WorldModel(jedm.EDMModelConfig(model=JRFConfig(net=jnet, state_t=2)))
        jc = jcond.make_condition(jnp.zeros((1, 8, 1024)))
        net = port_net(seeded_jax_params(tiny_jax_config(), np.zeros(shape, np.float32), np.zeros(1, np.float32),
                                         np.zeros((1, 8, 64), np.float32)), tiny_jax_config()).requires_grad_(True)
        model, batches = tedm.EDMVideo2WorldModel(tedm.EDMModelConfig(model=RFModelConfig(net=net.cfg, state_t=2)),
                                                  net), _edm_batches
    jtrainer = JTrainer(JTrainerConfig(max_iter=1), jmodel)
    with pytest.raises(AttributeError, match="text_dropout_rate"):
        jtrainer.train(jtrainer.init_state({}), iter([(jnp.zeros(shape), jc)]))

    trainer = Trainer(TrainerConfig(max_iter=3, logging_iter=1, save_iter=0,
                                    optimizer=OptimizerConfig(lr=1e-4, warm_up_steps=(1,), cycle_lengths=(10,))), model)
    state = trainer.init_state()
    before = {n: p.detach().clone() for n, p in state.params.items()}
    x0, cond = next(batches(1))
    want, _ = model.training_step(x0, cond, trainer.default_draws(0, x0))
    losses = []
    trainer.callbacks.callbacks.append(type("Record", (), {
        "on_train_start": lambda *a: None, "on_training_step_start": lambda *a: None,
        "on_training_step_end": lambda self, tr, st, m, it: losses.append(float(m["loss"])),
        "on_save_checkpoint": lambda *a: None, "on_train_end": lambda *a: None})())
    state = trainer.train(state, batches(3))
    assert state.step == 3 and np.isfinite(losses).all()
    assert losses[0] == pytest.approx(float(want.detach()), rel=1e-6)
    assert all(not torch.equal(p.detach(), before[n]) for n, p in state.params.items())
