"""The plain reference against the port's plain paths at a tiny size, on the CPU."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from conftest import tiny_config
from port_bench import reference as R
from port_bench import weights as W


def port_net(cfg: dict, seed: int):
    """The port's DiT for the tiny configuration, in fp32, with the seed's weights."""
    from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT
    from port_bench.serve import port_config

    net_cfg = dataclasses.replace(port_config(cfg).model.net, dtype=torch.float32)
    net = MiniTrainDIT(net_cfg).eval().requires_grad_(False)
    W.fill(W.dit_spec(cfg), net.state_dict(), seed)
    return net


@pytest.mark.parametrize("name", ["cosmos-predict2.5-2b", "cosmos-predict2.5-2b-sparse"])
def test_dit_forward_matches_port(name):
    cfg = tiny_config(name)
    seed = 2**35 + 11
    net = port_net(cfg, seed)
    ref = R.DiT(cfg, R.DiT.make_params(cfg, seed, "cpu"))
    x = torch.randn(2, cfg["state_ch"], 3, 8, 12, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([[731.0], [731.0]])
    text = torch.randn(2, cfg["text_tokens"], cfg["crossattn_proj_in_channels"])
    with torch.no_grad():
        want = net(x, t, text)
    got = ref.forward(R.denoise_input(x, x, 0, cfg["concat_padding_mask"]), t, text)
    assert R.rel(got, want) < 1e-5


def test_block_rows_match_whole_block():
    """A block at sampled rows equals the same rows of the whole block."""
    cfg = tiny_config("cosmos-predict2.5-2b-sparse")
    ref = R.DiT(cfg, R.DiT.make_params(cfg, 5, "cpu"))
    grid = (3, 4, 6)
    S = 72
    x = torch.randn(S, cfg["model_channels"])
    emb, lora = (a[0, 0].expand(3, -1) for a in ref.time_embed(torch.full((1, 1), 400.0)))
    ctx = ref.caption(torch.randn(cfg["text_tokens"], cfg["crossattn_proj_in_channels"]))
    rows = torch.tensor([0, 7, 40, 71])
    for block in (0, 1):
        whole, whole_attn = ref.block_rows(block, x, torch.arange(S), emb, lora, ctx, grid)
        part, part_attn = ref.block_rows(block, x, rows, emb, lora, ctx, grid)
        assert torch.allclose(part, whole[rows], atol=1e-5)
        assert torch.allclose(part_attn, whole_attn[rows], atol=1e-5)


def test_neighbourhood_window_matches_port():
    from cosmos_predict2_tpu_torch.ops.neighborhood_attention import VideoSize, adaptive_na_parameters, na_mask

    cfg = tiny_config("cosmos-predict2.5-2b-sparse")
    for grid in ((3, 4, 6), (24, 44, 80), (5, 9, 14)):
        cfg["natten_base_size"] = [-1, 44, 80] if grid[1] == 44 else [-1, grid[1], grid[2]]
        cfg["natten_window"], cfg["natten_stride"] = [-1, 12, 24], [1, 4, 8]
        if grid[1] < 44:
            cfg["natten_window"], cfg["natten_stride"] = [-1, 3, 5], [1, 2, 3]
        window, stride = R.na_window(cfg, grid)
        port_w, port_s, _ = adaptive_na_parameters(cfg["natten_window"], cfg["natten_stride"], grid,
                                                    cfg["natten_base_size"])
        assert (window, stride) == (tuple(port_w), tuple(port_s))
        S = int(np.prod(grid))
        rows = torch.from_numpy(np.random.default_rng(0).choice(S, size=min(S, 300), replace=False))
        want = na_mask(rows[:, None], torch.arange(S)[None, :], VideoSize(*grid), window, stride)
        want = torch.ones(rows.numel(), S, dtype=torch.bool) if want is None else want
        assert torch.equal(R.na_visible(rows, grid, window, stride), want)


def test_rope_matches_port():
    from cosmos_predict2_tpu_torch.ops.rope import rope_angles_3d
    from port_bench.serve import port_config

    cfg = tiny_config("cosmos-predict2.5-2b")
    spec = port_config(cfg).model.net.rope_spec
    assert torch.allclose(R.rope_angles(cfg, (3, 4, 6), "cpu"), rope_angles_3d(spec, 3, 4, 6), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("steps", [1, 2, 5, 35])
def test_unipc_matches_port(steps):
    from cosmos_predict2_tpu_torch.schedulers import unipc

    coeffs = unipc.set_timesteps(steps, shift=5.0)
    sched = R.unipc_schedule(steps, 5.0)
    assert np.array_equal(sched["timesteps"].astype(np.float32), coeffs.timesteps)
    x0 = torch.randn(1, 4, 3, 5, 6, generator=torch.Generator().manual_seed(1))
    seen, velocities = [], []

    def velocity(x, t):
        seen.append(x)
        velocities.append(torch.tanh(x) * (t / 1000.0) + 0.1)
        return velocities[-1]

    out = unipc.sample(velocity, x0, coeffs)
    states = R.unipc_states(sched, x0, velocities)
    for got, want in zip(seen[1:] + [out], states):
        assert R.rel(got, want) < 1e-6


def test_vae_encoder_matches_port():
    """The reference's chunked encoder against the port's streaming encode, both fp32."""
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE, WanVAEConfig
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import encode_streaming
    from port_bench import reference_train as RT

    v = {"dim": 16, "z_dim": 16, "dim_mult": [1, 2, 4, 4], "num_res_blocks": 2,
         "temporal_downsample": [False, True, True]}
    vae = WanVAE(WanVAEConfig(dim=16, dtype=torch.float32)).eval().requires_grad_(False)
    W.fill(RT.vae_encoder_spec(v), vae.state_dict(), 17)
    clip = torch.randint(0, 256, (3, 9, 32, 48), dtype=torch.uint8, generator=torch.Generator().manual_seed(2))
    want = encode_streaming(vae, clip.permute(1, 2, 3, 0)[None], pixel_format="uint8")[0].permute(3, 0, 1, 2)
    got = RT.VAEEncoder(v, R.DiT.make_params_from(RT.vae_encoder_spec(v), 17, "cpu")).encode(clip)
    assert got.shape == (16, 3, 4, 6)
    assert R.rel(got, want) < 1e-5


def test_training_steps_match_port():
    """Three reference training steps against the port's trainer, both fp32:
    the losses, step 1's gradient and the changes after three steps."""
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.models.video2world import TrainDraws, Video2WorldModel
    from cosmos_predict2_tpu_torch.training.trainer import Trainer
    from conftest import tiny_train_traffic
    from port_bench import reference_train as RT
    from port_bench.serve import port_config

    cfg, tr = tiny_config("cosmos-predict2.5-2b"), tiny_train_traffic()
    port = port_config(cfg, tr["recipe"], tr["overrides"])
    seed = 2**36 + 3
    net = port_net(cfg, seed).train().requires_grad_(True)
    model = Video2WorldModel(port.model, net)
    shape = (16, 3, 8, 12)

    def draw_fn(iteration, x0):
        d = RT.draws(cfg, shape, seed, iteration, "cpu")
        t = lambda v, dtype: torch.tensor([v], dtype=dtype)
        return TrainDraws(text_keep=t(d["text_keep"], torch.bool), use_video=torch.tensor(d["use_video"]),
                          num_conditional_frames=t(d["num_conditional_frames"], torch.int64), eps=d["eps"][None],
                          u=t(d["u"], torch.float32), high_sigma=t(d["high_sigma"], torch.bool),
                          high_sigma_index=t(d["high_sigma_index"], torch.int64))

    trainer = Trainer(port.trainer, model, callbacks=[], draw_fn=draw_fn)
    state = trainer.init_state()
    gen = torch.Generator().manual_seed(3)
    x0s = [torch.randn(1, *shape, generator=gen) for _ in range(3)]
    texts = [torch.randn(8, 64, generator=gen) for _ in range(3)]
    ref = RT.Trainer(cfg, tr, R.DiT.make_params(cfg, seed, "cpu"))
    for step in range(3):
        cond = make_condition(texts[step][None]).replace(gt_frames=x0s[step])
        loss = float(trainer.train_step(state, x0s[step], cond, step)["loss"])
        ref_loss, norms = ref.step(x0s[step][0], texts[step], RT.draws(cfg, shape, seed, step, "cpu"))
        assert abs(loss - ref_loss) < 1e-5 * abs(ref_loss)
        if step == 0:
            b1 = port.trainer.optimizer.betas[0]
            grads = {n: float(state.optimizer.state[p]["exp_avg"].double().norm()) / (1 - b1)
                     for n, p in state.params.items()}
            assert RT.leaf_gap(grads, norms) < 1e-4
    changes = ref.changes(seed)
    start = R.DiT.make_params(cfg, seed, "cpu")
    got = {n: float((p.detach() - start[n]).double().norm()) for n, p in state.params.items()}
    keep = {n for n, g in norms.items() if g >= 1e-3 * float(np.median(list(norms.values())))}
    assert RT.leaf_gap(got, changes["update"], keep) < 1e-2
