"""The port's LoRA post-training held against the JAX package (CPU, fp32).

The JAX package merges W' = W + (alpha/r) A B inside its step; the port adds
the adapters unmerged (x W^T + (alpha/r) (x A^T) B^T). Both sides get the
same base weights (JAX's init, perturbed) and the same adapters
(JAX's ``init_lora_params``, with ``b`` drawn nonzero where a test needs
every path to count), carried by utils/convert.py::jax_lora_params_to_torch.

Tolerances: the forward rtol 1e-5 and atol 1e-5 of the output's largest
entry (fp32: on these weights the base alone, without adapters, differs
from JAX's by 2.3e-5 at a largest entry of 6.2, and the adapters add
nothing measurable); one
training step's loss and every adapter gradient 1e-4 relative L2 (fp32 sums
over all tokens in another order, as tests/test_torch_training.py); the
trainer's losses rtol 1e-4 (the JAX golden trainer's own); ``merge_lora``
1e-6 (one fp32 product of rank r in another order); the base weights and a
resumed run bit-exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)
from test_torch_training import LATENT, TRAIN_OPT, Record, _batches, jax_draws, nets, t
from test_training import _batches as jax_batches

from cosmos_predict2_tpu.conditioning import conditioner as jcond
from cosmos_predict2_tpu.models.video2world import RFModelConfig as JRFConfig
from cosmos_predict2_tpu.models.video2world import Video2WorldModel as JModel
from cosmos_predict2_tpu.training import lora as jlora
from cosmos_predict2_tpu.training.optim import OptimizerConfig as JOptimizerConfig
from cosmos_predict2_tpu.training.trainer import Trainer as JTrainer
from cosmos_predict2_tpu.training.trainer import TrainerConfig as JTrainerConfig
from cosmos_predict2_tpu_torch.conditioning import conditioner as tcond
from cosmos_predict2_tpu_torch.models.video2world import RFModelConfig, Video2WorldModel
from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT
from cosmos_predict2_tpu_torch.training import lora as tlora
from cosmos_predict2_tpu_torch.training.checkpointing import Checkpointer
from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
from cosmos_predict2_tpu_torch.training.trainer import Trainer, TrainerConfig
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch, jax_lora_params_to_torch

RANK, ALPHA = 4, 8.0


@pytest.fixture(scope="module")
def setup():
    """JAX's model (the golden trainer's: fp32, no remat) and its initial
    weights, each perturbed by 0.05 N(0, 1) (AdaLN is zero at init: so that
    every path counts), JAX's adapters of them, the same with ``b`` drawn
    nonzero, and the port's DiTConfig."""
    jnet, tnet = nets("none")
    jmodel = JModel(JRFConfig(net=jnet, state_t=2))
    x, ts, ctx = np.zeros(LATENT, np.float32), np.zeros((1,), np.float32), np.zeros((1, 8, 1024), np.float32)
    params = jax.jit(jmodel.net.init)(jax.random.PRNGKey(0), x, ts, ctx)
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params)
    lora = jax.tree.map(np.asarray, jlora.init_lora_params(jax.random.PRNGKey(1), params, rank=RANK))
    lora_nonzero = jax.tree.map(lambda x: x, lora, is_leaf=lambda x: x is None)
    _set_b(lora_nonzero, rng)
    return jmodel, params, lora, lora_nonzero, tnet


def _set_b(tree, rng):
    """``b`` ~ 0.05 N(0, 1) in place on every adapter of a JAX adapter tree."""
    for v in tree.values():
        if isinstance(v, dict) and set(v) == {"a", "b"}:
            v["b"] = (0.05 * rng.standard_normal(v["b"].shape)).astype(np.float32)
        elif isinstance(v, dict):
            _set_b(v, rng)


def port_wrapper(params, lora, tnet, **over):
    """The port's model on JAX's base params under a LoRAModelWrapper that
    carries JAX's adapters."""
    net = MiniTrainDIT(tnet)
    net.load_state_dict(jax_dit_params_to_torch(params, tnet), strict=True)
    wrapper = tlora.LoRAModelWrapper(Video2WorldModel(RFModelConfig(net=tnet, state_t=2, **over), net),
                                     rank=RANK, alpha=ALPHA)
    adapters = wrapper.init_lora(torch.Generator().manual_seed(0))
    want = jax_lora_params_to_torch(lora)
    assert adapters.keys() == want.keys()
    with torch.no_grad():
        for name, p in adapters.items():
            p.copy_(want[name])
    return wrapper


def test_adapted_layers_are_jax_targets(setup):
    """The layers the port adapts are exactly those JAX's init_lora_params
    gives an adapter on a 2-block DiT, with its shapes; A is drawn within +-sqrt(6/fan_in)
    and B is zero."""
    _, params, lora, _, tnet = setup
    want = jax_lora_params_to_torch(lora)
    net = MiniTrainDIT(tnet)
    layers = tlora.target_layers(net)
    assert {f"{n}.lora_{x}" for n in layers for x in "AB"} == set(want)
    assert len(layers) == 2 * (4 + 4 + 2)  # per block: self and cross q/k/v/output, mlp layer1/layer2
    wrapper = tlora.LoRAModelWrapper(Video2WorldModel(RFModelConfig(net=tnet, state_t=2), net), rank=RANK)
    adapters = wrapper.init_lora(torch.Generator().manual_seed(0))
    for name, p in adapters.items():
        assert p.shape == want[name].shape and p.dtype == torch.float32 and p.requires_grad, name
    for name, layer in layers.items():
        a, b = adapters[f"{name}.lora_A"].detach(), adapters[f"{name}.lora_B"]
        assert float(a.abs().max()) <= np.sqrt(6.0 / layer.in_features) and float(a.abs().min()) > 0
        assert not b.any()
    assert [n for n, p in net.named_parameters() if p.requires_grad] == []
    assert tlora.count_lora_params(adapters) == jlora.count_lora_params(lora)
    assert net.state_dict().keys() == jax_dit_params_to_torch(params, tnet).keys()  # adapters stay out of the net


def test_lora_forward_matches_jax_merged_forward(setup):
    jmodel, params, _, lora, tnet = setup
    rng = np.random.default_rng(3)
    x = rng.standard_normal(LATENT).astype(np.float32)
    ts = np.asarray([400.0], np.float32)
    ctx = (0.1 * rng.standard_normal((1, 8, 1024))).astype(np.float32)
    merged = jlora.merge_lora(jax.tree.map(jnp.asarray, params), lora, alpha=ALPHA, rank=RANK)
    want = np.asarray(jmodel.net.apply(merged, x, ts, ctx))
    net = port_wrapper(params, lora, tnet).net
    with torch.no_grad():
        got = net(t(x), t(ts), t(ctx))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_lora_training_step_matches_jax(setup):
    """Loss and every adapter gradient of one training step (batch 2, JAX's
    draws of iteration 3: one text dropped, per-sample conditional frames)
    against jax.grad of LoRAModelWrapper.training_step over the adapters."""
    _, params, _, lora, tnet = setup
    jnet, _ = nets("none")
    jmodel = JModel(JRFConfig(net=jnet, state_t=2))
    shape = (2,) + LATENT[1:]
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal(shape).astype(np.float32)
    emb = (0.1 * rng.standard_normal((2, 8, 1024))).astype(np.float32)
    draws, rng_step = jax_draws(jmodel, seed=0, iteration=3, shape=shape)
    jwrap = jlora.LoRAModelWrapper(jmodel, jax.tree.map(jnp.asarray, params), rank=RANK, alpha=ALPHA)
    jc = jcond.make_condition(jnp.asarray(emb)).replace(gt_frames=jnp.asarray(x0))
    jc = jc.replace(crossattn_emb=jc.crossattn_emb * jnp.asarray(draws.text_keep.numpy())[:, None, None],
                    use_video_condition=jnp.asarray(draws.use_video.numpy()))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda l: jwrap.training_step(l, rng_step, jnp.asarray(x0), jc), has_aux=True))(jax.tree.map(jnp.asarray, lora))

    wrapper = port_wrapper(params, lora, tnet)
    tc = tcond.apply_train_dropout(tcond.make_condition(t(emb)).replace(gt_frames=t(x0)), draws.text_keep,
                                   draws.use_video)
    loss, _ = wrapper.training_step(t(x0), tc, draws)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-4)
    want = jax_lora_params_to_torch(jax.tree.map(np.asarray, jgrads))
    got = wrapper.trainable_parameters()
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        assert float((g - w).norm()) <= 1e-4 * max(float(w.norm()), 1e-12), name
    assert all(p.grad is None for p in wrapper.net.parameters())


def test_lora_trainer_matches_jax_losses_and_keeps_the_base(setup):
    """Three Trainer iterations over the adapters, fed JAX's draws, give the
    JAX Trainer's losses over the same adapters; the base stays bit-equal,
    the adapters and their EMA move, and the optimizer holds the adapters
    alone."""
    _, params, lora, _, tnet = setup
    jnet, _ = nets("none")
    jmodel = JModel(JRFConfig(net=jnet, state_t=2))
    jwrap = jlora.LoRAModelWrapper(jmodel, jax.tree.map(jnp.asarray, params), rank=RANK, alpha=ALPHA)
    jtrainer = JTrainer(JTrainerConfig(max_iter=3, logging_iter=1, save_iter=0, seed=0,
                                       optimizer=JOptimizerConfig(**TRAIN_OPT)), jwrap)
    jlosses = []

    class Capture:
        def __getattr__(self, name):
            if name == "on_training_step_end":
                return lambda trainer, state, metrics, iteration: jlosses.append(float(metrics["loss"]))
            return lambda *a, **k: None

    jtrainer.callbacks.callbacks.append(Capture())
    jtrainer.train(jtrainer.init_state(jax.tree.map(jnp.asarray, lora)), jax_batches(jmodel, 5))

    wrapper = port_wrapper(params, lora, tnet)
    base = {k: v.clone() for k, v in wrapper.net.state_dict().items()}
    trainer = Trainer(TrainerConfig(max_iter=3, logging_iter=1, save_iter=0, seed=0,
                                    optimizer=OptimizerConfig(**TRAIN_OPT)),
                      wrapper, draw_fn=lambda it, x0: jax_draws(jmodel, 0, it, tuple(x0.shape))[0])
    losses = Record(lambda state, m: float(m["loss"]))
    trainer.callbacks.callbacks.append(losses)
    state = trainer.init_state()
    start = {n: p.detach().clone() for n, p in state.params.items()}
    state = trainer.train(state, _batches(5))
    np.testing.assert_allclose(losses.items, jlosses, rtol=1e-4)
    assert state.params.keys() == start.keys() == {n for n in jax_lora_params_to_torch(lora)}
    assert all(torch.equal(v, base[k]) for k, v in wrapper.net.state_dict().items())
    assert all(not torch.equal(state.params[n], start[n]) for n in start if n.endswith("lora_B"))
    assert all(not torch.equal(state.ema_params[n], start[n]) for n in start if n.endswith("lora_B"))
    assert sum(len(g["params"]) for g in state.optimizer.param_groups) == len(start)


def test_merge_lora_matches_jax(setup):
    _, params, _, lora, tnet = setup
    want = jax_dit_params_to_torch(jax.tree.map(np.asarray, jlora.merge_lora(params, lora, alpha=ALPHA, rank=RANK)),
                                   tnet)
    got = tlora.merge_lora(jax_dit_params_to_torch(params, tnet), jax_lora_params_to_torch(lora), alpha=ALPHA,
                           rank=RANK)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    wrapper = port_wrapper(params, lora, tnet)
    merged = wrapper.merged()
    assert all(torch.equal(merged[k], got[k]) for k in got)
    net = MiniTrainDIT(tnet)  # merged weights serve without adapters: the same output
    net.load_state_dict(merged)
    x, ts, ctx = torch.randn(LATENT), torch.tensor([300.0]), 0.1 * torch.randn(1, 8, 1024)
    with torch.no_grad():
        torch.testing.assert_close(net(x, ts, ctx), wrapper.net(x, ts, ctx), rtol=1e-5, atol=1e-5)


def test_adapter_only_checkpoint_saves_and_resumes(setup, tmp_path):
    """A checkpoint of a LoRA run holds the adapters, their EMA and their
    optimizer state, not the base; resuming it into a fresh wrapper (other
    adapters) restores them, and one more step is bit-identical."""
    _, params, lora, _, tnet = setup

    def make(max_iter, save_iter=0):
        wrapper = port_wrapper(params, lora, tnet)
        cfg = TrainerConfig(max_iter=max_iter, logging_iter=1, save_iter=save_iter, seed=0,
                            optimizer=OptimizerConfig(**TRAIN_OPT))
        return Trainer(cfg, wrapper)

    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    trainer = make(2, save_iter=2)
    trainer.checkpointer = ckpt
    state = trainer.train(trainer.init_state(), _batches(2))
    saved = ckpt.read()
    assert saved["params"].keys() == saved["ema_params"].keys() == state.params.keys()
    assert all(k.endswith((".lora_A", ".lora_B")) for k in saved["params"])
    assert len(saved["optimizer"]["state"]) == len(state.params)

    other = make(3)
    with torch.no_grad():
        for p in other.model.trainable_parameters().values():
            p.normal_()
    restored = ckpt.load(other.init_state())
    assert (restored.step, restored.opt_step) == (2, 2)
    for n, p in state.params.items():
        assert torch.equal(restored.params[n], p) and torch.equal(restored.ema_params[n], state.ema_params[n]), n
    batch = list(_batches(3))[2:]
    trainer.config = dataclasses.replace(trainer.config, max_iter=3, save_iter=0)
    trainer.checkpointer = None
    a = trainer.train(state, batch, start_iteration=2)
    b = other.train(restored, batch, start_iteration=2)
    for n, p in a.params.items():
        assert torch.equal(b.params[n], p) and torch.equal(b.ema_params[n], a.ema_params[n]), n


def test_lora_recipe_cli_on_a_local_folder_on_cpu(tmp_path):
    """training/train.py's entry point with the LoRA recipe's switches on a
    local folder (an npz clip padded to 5 frames, one resized and cropped
    with an embedding, one without), on the CPU: 2 iterations saved at 2,
    then one resumed; the checkpoints hold adapters only."""
    from cosmos_predict2_tpu_torch.training.train import main

    root = tmp_path / "clips"
    for d in ("videos", "metas", "t5_xxl"):
        (root / d).mkdir(parents=True)
    rng = np.random.default_rng(0)
    np.savez(root / "videos" / "a.npz", video=rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8))
    np.savez(root / "videos" / "b.npz", video=rng.integers(0, 256, (9, 40, 48, 3), dtype=np.uint8), fps=24.0)
    (root / "metas" / "b.txt").write_text("a robot")
    np.save(root / "t5_xxl" / "b.npy", rng.standard_normal((3, 1024)).astype(np.float16))
    args = ["--device", "cpu", "--experiment=error-free_mock_data_smoke", "--ckpt_dir", str(tmp_path / "ckpt"),
            "data_train=local_video", f"data_train.root={root}", "model.use_lora=True", "model.lora_rank=4",
            "data_train.num_frames=5", "data_train.height=32", "data_train.width=32", "model.net.model_channels=256",
            "model.net.num_heads=2", "model.net.adaln_lora_dim=32", "trainer.save_iter=2"]
    assert main(args + ["trainer.max_iter=2"]) == 0
    saved = Checkpointer(str(tmp_path / "ckpt")).read()
    assert saved["step"] == 2 and all(k.endswith((".lora_A", ".lora_B")) for k in saved["params"])
    assert len(saved["params"]) == 2 * 2 * (4 + 4 + 2)
    assert main(args + ["trainer.max_iter=3"]) == 0
    assert Checkpointer(str(tmp_path / "ckpt")).latest_step() == 3
