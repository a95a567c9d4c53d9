"""The port's training mesh (parallel/mesh.py::parallelize, the trainer,
DCP checkpoints and training/train.py::launch) held against the JAX package.

Four gloo ranks (tests/torch_dist_util.py: one start of four processes for
the whole file, a FileStore under tmp_path) run, on the same seeded NumPy
inputs and weights that go through the JAX package on one device:

- 3 trainer steps with EMA of test_parallel.py:162's tiny DiT (128
  channels, 4 heads of 32) at fsdp 2 x tp 2, and at fsdp 2 x cp 2 under
  Ulysses and under ring, fed JAX's draws of the global batch: losses,
  final parameters and EMA against JAX's one-device run, at that test's
  1e-5 (the port's one-device run, tests/test_torch_training.py, agrees
  with JAX to ~1e-6 relative on a step's loss);
- the same steps with bf16 Adam moments (AdamWBF16) at fsdp 2 x tp 2
  against the port's one-device run: each shard rounds with the draws the
  unsharded parameter's elements get, so the two agree to fp32 reduction
  order;
- the Qwen LM at tp 2 x fsdp 2 with 4 query heads over 2 KV heads, with
  q/k/v biases and (Qwen3) with per-head q / k norms, against JAX's forward
  (test_parallel.py:135, 2e-5); the Wan2.1 DiT (i2v, 4 heads) at tp 2 x
  fsdp 2, its whole-width q / k norms summing their squares over tp,
  against JAX's one-device forward at the same bound;
- a DCP checkpoint saved at fsdp 2 x tp 2 and restored at fsdp 4 into a
  state with other weights: parameters, EMA, Adam moments, step and rate
  exactly (test_parallel.py:212's resharded restore);
- training/train.py::launch on the mock data at fsdp_shard_size 2 x
  cp_size 2 (dp 1) and at fsdp_shard_size 2 with a batch of 4 (dp 2: HSDP),
  against the one-process launch of the same global batch, and a resumed
  mesh launch (DCP) against the unbroken one; JAX's dp rule and message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)
from test_torch_training import jax_draws

from cosmos_predict2_tpu.conditioning.conditioner import make_condition as j_make_condition
from cosmos_predict2_tpu.models.video2world import RFModelConfig as JRFConfig
from cosmos_predict2_tpu.models.video2world import Video2WorldModel as JModel
from cosmos_predict2_tpu.networks import wan_dit as jwd
from cosmos_predict2_tpu.networks.dit import PRESETS
from cosmos_predict2_tpu.text_encoders import qwen as jqwen
from cosmos_predict2_tpu.training.optim import OptimizerConfig as JOptimizerConfig
from cosmos_predict2_tpu.training.trainer import Trainer as JTrainer
from cosmos_predict2_tpu.training.trainer import TrainerConfig as JTrainerConfig
from cosmos_predict2_tpu.utils.checkpoint_convert import convert_wan_dit_state_dict as jax_convert_wan
from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, Video2WorldModel
from cosmos_predict2_tpu_torch.networks import wan_dit as twd
from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT
from cosmos_predict2_tpu_torch.text_encoders import qwen as tqwen
from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
from cosmos_predict2_tpu_torch.training.train import dp_size
from cosmos_predict2_tpu_torch.training.trainer import Callback, Trainer, TrainerConfig
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch, jax_qwen_params_to_torch
from test_torch_wan_dit import reference_state_dict
from torch_dist_util import _draws, run_ranks
from torch_variants_util import jit_init, noisy_params, port_config

TRAIN_TOL = 1e-5  # test_parallel.py:162's atol and rtol on parameters and EMA
QWEN_TOL = 2e-5  # test_parallel.py:135's
LATENT = (2, 16, 2, 4, 4)
TRAIN_OPT = dict(lr=1e-4, warm_up_steps=(2,), cycle_lengths=(10,))
MESHES = {"fsdp2-tp2": ((1, 2, 1, 2), "ulysses"), "fsdp2-cp2-ulysses": ((1, 2, 2, 1), "ulysses"),
          "fsdp2-cp2-ring": ((1, 2, 2, 1), "ring")}
LAUNCH = ["data_train.num_frames=5", "data_train.height=32", "data_train.width=32", "model.state_t=2",
          "model.net.rope_enable_fps_modulation=False", "trainer.max_iter=2"]


def _jnet():
    return dataclasses.replace(PRESETS["test"], dtype=jnp.float32, remat="none", model_channels=128, num_heads=4,
                               adaln_lora_dim=16)


def _batches():
    """test_parallel.py:162's three global batches: (latents, text embeddings)."""
    out = []
    for i in range(3):
        rng = np.random.RandomState(i)
        latents = rng.randn(*LATENT).astype(np.float32)
        out.append((latents, (rng.randn(2, 8, 1024) * 0.02).astype(np.float32)))
    return out


def _jax_run(jmodel, params):
    """JAX's one-device trainer, 3 steps with EMA: (losses, params, EMA)."""
    tc = JTrainerConfig(max_iter=3, logging_iter=10, save_iter=0, seed=0, ema_enabled=True,
                        optimizer=JOptimizerConfig(**TRAIN_OPT))
    trainer = JTrainer(tc, jmodel)
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

    state = trainer.train(trainer.init_state(jax.tree.map(lambda x: jnp.array(x, copy=True), params)), batches())
    return losses, state.params, state.ema_params


def _port_one_device(cfg, sd, draws, optimizer):
    """The port's one-device trainer on the same weights, batches and draws: (losses, params, EMA)."""
    net = MiniTrainDIT(cfg)
    net.load_state_dict({n: torch.from_numpy(a) for n, a in sd.items()}, strict=True)
    net.train().requires_grad_(True)
    model = Video2WorldModel(RFModelConfig(net=cfg, state_t=2), net)
    tc = TrainerConfig(max_iter=3, logging_iter=100, save_iter=0, seed=0, ema_enabled=True, optimizer=optimizer)
    losses = []

    class Record(Callback):
        def on_training_step_end(self, trainer, state, metrics, iteration):
            losses.append(float(metrics["loss"]))

    trainer = Trainer(tc, model, callbacks=[Record()], draw_fn=lambda it, x0: _draws(draws[it]))

    def batches():
        for latents, emb in _batches():
            x = torch.from_numpy(latents)
            yield x, make_condition(torch.from_numpy(emb)).replace(gt_frames=x)

    state = trainer.train(trainer.init_state(), batches())
    return (losses, {n: p.detach().numpy() for n, p in state.params.items()},
            {n: e.numpy() for n, e in state.ema_params.items()})


def wan_tp_pair():
    """The Wan2.1 i2v DiT of tests/test_torch_wan_dit.py with 4 heads (2 a
    rank at tp 2): JAX's config and parameters, the port's config and the
    reference-named state dict both came from, and two samples of inputs."""
    jcfg = dataclasses.replace(jwd.WAN_PRESETS["test"], model_type="i2v", text_dim=32, clip_dim=48, num_heads=4)
    names = {f.name for f in dataclasses.fields(twd.WanConfig)} - {"dtype"}
    tcfg = twd.WanConfig(dtype=torch.float32, **{n: getattr(jcfg, n) for n in names})
    sd = reference_state_dict(tcfg, seed=0)
    rng = np.random.default_rng(3)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    inputs = dict(x=f(2, 16, 2, 8, 8), y=f(2, 20, 2, 8, 8), ctx=0.5 * f(2, 512, 32), clip=0.5 * f(2, 257, 48),
                  t=np.asarray([731.0, 219.0], np.float32))
    return jcfg, jax_convert_wan(sd, jcfg.num_layers, i2v=True), tcfg, sd, inputs


def jax_wan_forward(jcfg, jparams, inputs):
    return np.asarray(jwd.WanModel(jcfg).apply(jparams, *(jnp.asarray(inputs[k]) for k in ("x", "t", "ctx")),
                                               y_B_C_T_H_W=jnp.asarray(inputs["y"]),
                                               frame_cond_crossattn_emb=jnp.asarray(inputs["clip"])))


def _qwen_cfgs():
    """test_parallel.py:135's LM (Qwen2.5: q/k/v biases) and its Qwen3 form (per-head q / k norms)."""
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16)
    out = {}
    for name, extra in (("qwen2.5", {}), ("qwen3", dict(attention_bias=False, qk_norm=True))):
        out[name] = (dataclasses.replace(jqwen.QwenConfig(), dtype=jnp.float32, **base, **extra),
                     dataclasses.replace(tqwen.QwenConfig(), dtype=torch.float32, **base, **extra))
    return out


@pytest.fixture(scope="module")
def setup():
    """The JAX side: the net's parameters, its one-device run and draws, the Qwen cases."""
    jnet = _jnet()
    jmodel = JModel(JRFConfig(net=jnet, state_t=2))
    params = jax.tree.map(np.asarray, jit_init(jmodel.init_params, jax.random.PRNGKey(0), LATENT, text_len=8))
    draws = []
    for it in range(3):
        d = jax_draws(jmodel, 0, it, LATENT)[0]
        draws.append({f.name: None if getattr(d, f.name) is None else getattr(d, f.name).numpy()
                      for f in dataclasses.fields(d)})
    tcfg = port_config(jnet)
    sd = {n: t.numpy() for n, t in jax_dit_params_to_torch(params, tcfg).items()}
    qwen = {}
    ids = np.random.RandomState(0).randint(0, 128, (2, 16))
    for name, (jc, tc) in _qwen_cfgs().items():
        qp = noisy_params(jit_init(jqwen.QwenLM(jc).init, jax.random.PRNGKey(0), jnp.asarray(ids)))
        qsd = {n: t.numpy() for n, t in jax_qwen_params_to_torch(qp).items()}
        want = [np.asarray(h) for h in jqwen.QwenLM(jc).apply(qp, jnp.asarray(ids))]
        qwen[name] = (tc, qsd, want)
    jwan, jwan_params, twan, wan_sd, wan_inputs = wan_tp_pair()
    wan = dict(cfg=twan, sd=wan_sd, inputs=wan_inputs, want=jax_wan_forward(jwan, jwan_params, wan_inputs))
    return dict(jmodel=jmodel, params=params, draws=draws, tcfg=tcfg, sd=sd, qwen=qwen, ids=ids, wan=wan)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Every mesh case of this file on four gloo ranks, in one start."""
    tmp = tmp_path_factory.mktemp("mesh")
    common = dict(cfg=setup["tcfg"], state_dict=setup["sd"], batches=_batches(), draws=setup["draws"])
    bf16 = OptimizerConfig(moments_dtype="bfloat16", moments_seed=3, **TRAIN_OPT)
    cases = {name: ("mesh_train", dict(common, sizes=sizes, strategy=strategy))
             for name, (sizes, strategy) in MESHES.items()}
    cases["bf16"] = ("mesh_train", dict(common, sizes=(1, 2, 1, 2), optimizer=bf16))
    cases["dcp"] = ("dcp_roundtrip", dict(common, ckpt=str(tmp / "dcp"), save_sizes=(1, 2, 1, 2),
                                          load_sizes=(1, 4, 1, 1)))
    for name, (tc, qsd, _) in setup["qwen"].items():
        cases[name] = ("qwen_forward", dict(cfg=tc, state_dict=qsd, ids=setup["ids"], sizes=(1, 2, 1, 2)))
    cases["launch_cp"] = ("launch_run", dict(overrides=LAUNCH + ["fsdp_shard_size=2", "cp_size=2",
                                                                 "data_train.batch_size=2"]))  # dp 1
    wan = setup["wan"]
    cases["wan_tp"] = ("wan_tp_forward", dict(cfg=wan["cfg"], state_dict=wan["sd"], inputs=wan["inputs"],
                                              sizes=(1, 2, 1, 2)))
    cases["launch_hsdp"] = ("launch_run", dict(overrides=LAUNCH + ["fsdp_shard_size=2", "data_train.batch_size=4"]))
    mesh_launch = LAUNCH + ["fsdp_shard_size=2", "cp_size=2", "data_train.batch_size=2"]
    cases["launch_resume"] = ("launch_run", dict(overrides=mesh_launch + ["trainer.max_iter=1"],
                                                 ckpt_dir=str(tmp / "launch_ckpt"), resume_overrides=mesh_launch))
    results = run_ranks(tmp, 4, list(cases.values()))
    return dict(zip(cases, results))


@pytest.fixture(scope="module")
def jax_run(setup):
    return _jax_run(setup["jmodel"], setup["params"])


def _flat_jax(tree, tcfg):
    return {n: t.numpy() for n, t in jax_dit_params_to_torch(jax.tree.map(np.asarray, tree), tcfg).items()}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_training_steps_match_jax(setup, ranks, jax_run, mesh):
    """3 trainer steps on the mesh, every rank's global losses and rank 0's
    gathered parameters and EMA, against JAX's one-device trainer
    (test_parallel.py:162: ZeRO-3 + TP, and here CP, is a layout, not a
    change of numbers)."""
    want_losses, want_params, want_ema = jax_run
    want_params, want_ema = _flat_jax(want_params, setup["tcfg"]), _flat_jax(want_ema, setup["tcfg"])
    shares = ranks[mesh]
    for losses, norms, _, _ in shares:
        np.testing.assert_allclose(losses, want_losses, rtol=TRAIN_TOL)
        assert norms == shares[0][1]  # the global norm, the same on every rank
    _, _, params, ema = shares[0]
    assert params.keys() == want_params.keys() and ema.keys() == want_ema.keys()
    for n in want_params:
        np.testing.assert_allclose(params[n], want_params[n], atol=TRAIN_TOL, rtol=TRAIN_TOL, err_msg=n)
        np.testing.assert_allclose(ema[n], want_ema[n], atol=TRAIN_TOL, rtol=TRAIN_TOL, err_msg=n)


def test_bf16_moments_shard_like_one_device(setup, ranks):
    """AdamWBF16 on the fsdp 2 x tp 2 mesh: each shard's stochastic rounding
    takes the draws its elements get on one device (the noise drawn whole
    and cut), so 3 steps match the port's one-device run."""
    bf16 = OptimizerConfig(moments_dtype="bfloat16", moments_seed=3, **TRAIN_OPT)
    want_losses, want_params, want_ema = _port_one_device(setup["tcfg"], setup["sd"], setup["draws"], bf16)
    losses, _, params, ema = ranks["bf16"][0]
    np.testing.assert_allclose(losses, want_losses, rtol=TRAIN_TOL)
    for n in want_params:
        np.testing.assert_allclose(params[n], want_params[n], atol=TRAIN_TOL, rtol=TRAIN_TOL, err_msg=n)
        np.testing.assert_allclose(ema[n], want_ema[n], atol=TRAIN_TOL, rtol=TRAIN_TOL, err_msg=n)


@pytest.mark.parametrize("name", ["qwen2.5", "qwen3"])
def test_qwen_tp_fsdp_forward_matches_jax(setup, ranks, name):
    """The Qwen LM with tp 2 x fsdp 2 sharded parameters (each rank 2 of
    the 4 query heads and 1 of the 2 KV heads) against JAX's unsharded
    forward, every hidden state, on every rank (test_parallel.py:135); the
    first layer's placements are the rule's."""
    _, _, want = setup["qwen"][name]
    for states, placements in ranks[name]:
        assert len(states) == len(want)
        for got, w in zip(states, want):
            np.testing.assert_allclose(got, w, atol=QWEN_TOL, rtol=QWEN_TOL)
    placements = ranks[name][0][1]
    dims = ("dp", "fsdp_cp", "tp")
    assert placements["layers.0.self_attn.q_proj.weight"] == (dims, ("Replicate()", "Shard(1)", "Shard(0)"))
    assert placements["layers.0.self_attn.o_proj.weight"] == (dims, ("Replicate()", "Shard(0)", "Shard(1)"))
    assert placements["layers.0.mlp.down_proj.weight"] == (dims, ("Replicate()", "Shard(0)", "Shard(1)"))
    if name == "qwen3":  # the per-head norms: replicated over tp, their gradients summed there
        assert placements["layers.0.self_attn.q_norm.weight"] == (dims, ("Replicate()", "Shard(0)", "Replicate()"))
    else:  # a column-parallel bias follows its weight's out features
        assert placements["layers.0.self_attn.q_proj.bias"] == (dims, ("Replicate()", "_StridedShard(0)", "Shard(0)"))
    assert placements["layers.0.input_layernorm.weight"] == (dims[:2], ("Replicate()", "Shard(0)"))


def test_parallelize_refuses_whole_width_norms_under_tp(setup, ranks):
    """The Wan DiT's q / k norms span every head. parallelize no longer
    refuses tp over it: at tp 2 x fsdp 2 each rank runs 2 of the 4 heads,
    its norms' weights sharded over tp like q / k / k_img's out features
    and their sums of squares summed over tp, and every rank's forward
    matches JAX's one-device forward (the Qwen tp bound, 2e-5)."""
    want = setup["wan"]["want"]
    for out, placements in ranks["wan_tp"]:
        np.testing.assert_allclose(out, want, atol=QWEN_TOL, rtol=QWEN_TOL)
    placements = ranks["wan_tp"][0][1]
    for norm in ("self_attn.norm_q", "self_attn.norm_k", "cross_attn.norm_q", "cross_attn.norm_k",
                 "cross_attn.norm_k_img"):
        assert placements[f"blocks.0.{norm}.weight"][-1] == "S(0)", norm
    for proj in ("self_attn.q", "cross_attn.k_img", "ffn.0"):
        assert placements[f"blocks.0.{proj}.weight"][-1] == "S(0)", proj
    for proj in ("self_attn.o", "cross_attn.o", "ffn.2"):
        assert placements[f"blocks.0.{proj}.weight"][-1] == "S(1)", proj


def test_dcp_checkpoint_reshards(ranks):
    """Saved at fsdp 2 x tp 2 (torch.distributed.checkpoint, every rank its
    shards), restored at fsdp 4 into a state with other weights: every
    parameter, EMA tensor and Adam moment, the step and the rate exactly
    (test_parallel.py:212's resharded restore); on every rank."""
    for saved, restored, latest in ranks["dcp"]:
        assert latest == 1
        assert (restored["step"], restored["opt_step"], restored["lr"]) == (saved["step"], saved["opt_step"], saved["lr"])
        for group in ("params", "ema", "moments"):
            assert restored[group].keys() == saved[group].keys() and saved[group], group
            for n, a in saved[group].items():
                np.testing.assert_array_equal(restored[group][n], a, err_msg=f"{group} {n}")
    assert any(k.endswith("exp_avg_sq") for k in ranks["dcp"][0][0]["moments"])


def _one_process_launch(overrides, **kw):
    """launch_run in this process with the ranks' one CPU thread: the first
    step's loss of the smoke experiment's random net moves by ~1e-5
    relative with the thread count (the order of its fp32 sums)."""
    from torch_dist_util import launch_run

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return launch_run(overrides, **kw)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("case", ["launch_cp", "launch_hsdp"])
def test_launch_on_a_mesh_matches_one_process(ranks, case):
    """launch at fsdp_shard_size 2 x cp_size 2 (dp 1), and at
    fsdp_shard_size 2 with a batch of 4 on 4 processes (dp 2: HSDP): each
    rank's loader yields its rows of the global batch, encoded on the rank;
    the global losses equal the one-process launch of the same batch."""
    batch = "data_train.batch_size=2" if case == "launch_cp" else "data_train.batch_size=4"
    want = _one_process_launch(LAUNCH + [batch])
    for losses in ranks[case]:
        np.testing.assert_allclose(losses, want, rtol=TRAIN_TOL)


def test_launch_resumes_a_mesh_checkpoint(ranks, tmp_path):
    """A mesh launch of 1 iteration saves a DCP step; launched again with 2
    it resumes there (its loader starting over, as JAX's launch does): the
    losses are the one-process launch's, saved (torch.save) and resumed
    alike."""
    one = LAUNCH + ["data_train.batch_size=2"]
    want = _one_process_launch(one + ["trainer.max_iter=1"], ckpt_dir=str(tmp_path / "ckpt"), resume_overrides=one)
    assert ranks["launch_cp"][0][0] == pytest.approx(want[0], rel=TRAIN_TOL)
    for losses in ranks["launch_resume"]:
        np.testing.assert_allclose(losses, want, rtol=TRAIN_TOL)


def test_dp_size_follow_jax_launch():
    """train.py's dp rule (JAX train.py:50-63): the world size over fsdp x cp
    x tp, shrunk until the global batch divides over dp x fsdp; JAX's
    message when it cannot; and a dp that would leave processes idle
    raises (every process here drives a device of the mesh)."""
    from cosmos_predict2_tpu.configs.defaults import make_config as j_make_config
    from cosmos_predict2_tpu.training.train import launch as j_launch

    assert dp_size(4, 4, 2, 1, 1) == 2
    assert dp_size(4, 2, 2, 2, 1) == 1
    assert dp_size(8, 8, 2, 1, 1) == 4
    assert dp_size(6, 6, 2, 1, 1) == 3
    with pytest.raises(ValueError) as e:
        dp_size(2, 3, 2, 1, 1)
    with pytest.raises(ValueError) as je:
        j_launch(j_make_config("error-free_mock_data_smoke", ["fsdp_shard_size=2", "data_train.batch_size=3"]))
    assert str(e.value) == str(je.value) == "batch_size 3 not divisible by dp*fsdp = 2"
    with pytest.raises(ValueError, match="processes"):
        dp_size(4, 2, 2, 1, 1)  # dp 2 cannot split a batch of 2 over dp x fsdp = 4: dp 1 leaves 2 idle
