"""The port's DiT, configs and DiT weight conversion held against the JAX package.

Tolerance: the DiT forward in fp32 (2 blocks, seeded weights) agrees with
the JAX forward to ~1e-6 relative; the bound 1e-4 relative / 1e-4 absolute
covers the longer chain of fp32 matmuls, norms and softmaxes summed in
another order. Weight conversion is bit-exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.networks.dit import DiTConfig as JDiTConfig
from cosmos_predict2_tpu.networks.dit import MiniTrainDIT as JDiT
from cosmos_predict2_tpu.utils.checkpoint_convert import convert_dit_state_dict
from cosmos_predict2_tpu_torch.networks import dit as tdit
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch
from torch_variants_util import jit_init

TOL = 1e-4


def tiny_configs(**over):
    """A tiny JAX DiT config (fp32) and the port's config with the same fields."""
    base = dict(model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32, crossattn_emb_channels=64)
    base.update(over)
    jcfg = JDiTConfig(dtype=jnp.float32, remat="none", **base)
    names = {f.name for f in dataclasses.fields(tdit.DiTConfig)} - {"dtype"}
    tcfg = tdit.DiTConfig(dtype=torch.float32, **{n: getattr(jcfg, n) for n in names})
    return jcfg, tcfg


def seeded_jax_params(jcfg, x, t, ctx, seed=0, **kw):
    """JAX init (which zero-inits the AdaLN outputs) plus seeded noise on
    every leaf, so every path of the forward contributes."""
    params = jit_init(JDiT(jcfg).init, jax.random.PRNGKey(seed), x, t, ctx, **kw)
    leaves, tdef = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(l, np.float32) + 0.05 * rng.standard_normal(l.shape).astype(np.float32) for l in leaves]
    return jax.tree.unflatten(tdef, leaves)


CASES = {
    "2B-like": dict(use_crossattn_projection=True, crossattn_proj_in_channels=48, rope_h_extrapolation_ratio=3.0,
                    rope_w_extrapolation_ratio=3.0, rope_enable_fps_modulation=False),
    "fps-modulated, no projection": dict(),
    "no adaln lora": dict(use_adaln_lora=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dit_forward_matches_jax(case):
    jcfg, tcfg = tiny_configs(**CASES[case])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 3, 8, 8)).astype(np.float32)
    t = np.asarray([0.3, 0.9], np.float32) * 1000
    ctx_dim = jcfg.crossattn_proj_in_channels if jcfg.use_crossattn_projection else jcfg.crossattn_emb_channels
    ctx = rng.standard_normal((2, 7, ctx_dim)).astype(np.float32)
    fps = np.asarray([16.0], np.float32)  # one fps per clip batch (the rope takes a scalar)
    params = seeded_jax_params(jcfg, x, t, ctx)
    want = JDiT(jcfg).apply(params, x, t, ctx, fps=fps)

    net = tdit.MiniTrainDIT(tcfg)
    net.load_state_dict(jax_dit_params_to_torch(params, tcfg), strict=True)
    with torch.no_grad():
        got = net(*map(torch.from_numpy, (x, t, ctx)), fps=torch.from_numpy(fps))
    assert got.shape == (2, 16, 3, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_dit_state_dict_round_trip_is_bit_exact():
    """port state_dict -> checkpoint_convert (the JAX tree) -> back, strict."""
    _, tcfg = tiny_configs(**CASES["2B-like"])
    net = tdit.build_dit(tcfg, "cpu", seed=3)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    tree = convert_dit_state_dict(sd, tcfg.num_blocks, tcfg.use_adaln_lora)
    back = tdit.MiniTrainDIT(tcfg)
    back.load_state_dict(jax_dit_params_to_torch(tree, tcfg), strict=True)
    for k, v in net.state_dict().items():
        assert torch.equal(v, back.state_dict()[k]), k


def test_dit_state_dict_maps_onto_the_jax_tree():
    """The port's state_dict names and shapes are the reference checkpoint's:
    checkpoint_convert turns it into exactly the JAX model's parameter tree."""
    jcfg, tcfg = tiny_configs(**CASES["2B-like"])
    x, t = jnp.zeros((1, 16, 2, 8, 8)), jnp.zeros((1,))
    ctx = jnp.zeros((1, 4, jcfg.crossattn_proj_in_channels))
    shapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(JDiT(jcfg).init, jax.random.PRNGKey(0), x, t, ctx))
    sd = {k: v.numpy() for k, v in tdit.MiniTrainDIT(tcfg).state_dict().items()}
    converted = jax.tree.map(lambda a: a.shape, convert_dit_state_dict(sd, tcfg.num_blocks))
    assert converted == shapes


def test_dit_bf16_forward_is_close_to_fp32():
    """The bf16 compute path (fp32 params, bf16 matmuls, fp32 norms and
    modulation) stays within bf16 rounding of the fp32 forward."""
    _, tcfg = tiny_configs(**CASES["2B-like"])
    net32 = tdit.build_dit(tcfg, "cpu", seed=4)
    net16 = tdit.MiniTrainDIT(dataclasses.replace(tcfg, dtype=torch.bfloat16))
    net16.load_state_dict(net32.state_dict(), strict=True)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 16, 3, 8, 8)).astype(np.float32))
    t = torch.tensor([100.0, 900.0])
    ctx = torch.from_numpy(rng.standard_normal((2, 7, 48)).astype(np.float32))
    with torch.no_grad():
        a, b = net32(x, t, ctx), net16(x, t, ctx).float()
    assert b.dtype == torch.float32 and torch.isfinite(b).all()
    assert float((a - b).norm() / a.norm()) < 5e-2  # bf16: ~3 significant digits per op


# --------------------------------- configs ---------------------------------


# the post-trained variants' base experiments: (their net fields beyond the 2B base, state_t)
VARIANTS = {
    "predict2_video2world_2b_action_conditioned": (dict(action_dim=84, concat_condition_mask=True), 4),
    "predict2_video2world_2b_camera_conditioned": (dict(camera_dim=6), 24),
    "predict2_multiview_2b_7views": (dict(n_views=7, concat_view_embedding=True, view_condition_dim=6,
                                          concat_condition_mask=True), 56),
}


@pytest.mark.parametrize("experiment", ["predict2_video2world_2b_rectified_flow", "error-free_mock_data_smoke",
                                        "predict2_video2world_2b_sparse", "predict2_interactive_2b_causal",
                                        "dmd2_trigflow_distill_cosmos_predict2_2B_bidirectional",
                                        "dmd2_trigflow_distill_cosmos_predict2_2B_bidirectional_w_discriminator",
                                        *VARIANTS])
def test_config_fields_match_jax(experiment):
    """Every field of the port's config equals the JAX package's, and the
    JAX fields the port lacks are at their dense, plain defaults."""
    from cosmos_predict2_tpu.configs.defaults import make_config as jax_make_config
    from cosmos_predict2_tpu_torch.configs.defaults import make_config

    j, t = jax_make_config(experiment), make_config(experiment)

    def same(tobj, jobj):
        for f in dataclasses.fields(tobj):
            tv, jv = getattr(tobj, f.name), getattr(jobj, f.name)
            if dataclasses.is_dataclass(tv):
                same(tv, jv)
            elif isinstance(tv, torch.dtype):
                assert str(tv).removeprefix("torch.") == jnp.dtype(jv).name, f.name
            else:
                assert tv == jv, (f.name, tv, jv)

    same(t.model, j.model)
    same(t.tokenizer, j.tokenizer)
    same(t.trainer, j.trainer)
    same(t.data_train, j.data_train)
    jo = j.trainer.optimizer
    assert (jo.moments_dtype, jo.moments_offload, j.model.use_lora) == ("float32", False, False)
    jn = j.model.net
    variant, state_t = VARIANTS.get(experiment, ({}, 24))
    plain = dict(camera_dim=None, action_dim=None, n_views=1, concat_view_embedding=False, view_condition_dim=0,
                 concat_condition_mask=False)
    assert {k: getattr(jn, k) for k in plain} == {**plain, **variant}
    assert {k: getattr(t.model.net, k) for k in plain} == {**plain, **variant}
    assert jn.temporal_causal == ("interactive" in experiment)
    if "interactive" in experiment:
        assert (t.model.net.num_frame_per_block, t.model.net.cache_na_window_rows) == (1, -1)
    if "sparse" in experiment:
        sparse = [p is not None for p in tdit.block_layout(t.model.net)]
        assert [i for i, s in enumerate(sparse) if not s] == [0, 4, 9, 13, 18, 22, 27]
    else:
        assert jn.n_dense_blocks == -1
    assert not (jn.enable_cross_view_attn or jn.scan_blocks or jn.cp_axis or jn.extra_per_block_abs_pos_emb)
    if experiment.startswith("predict2"):
        net = t.model.net
        assert (net.model_channels, net.num_heads, net.head_dim, net.num_blocks) == (2048, 16, 128, 28)
        assert (net.crossattn_proj_in_channels, net.crossattn_emb_channels, t.model.state_t) == (100352, 1024, state_t)
        assert t.tokenizer.dim == 96


# ------------------------------ sparse blocks ------------------------------

PER_LAYER = (
    ((-1, 2, 2), (1, 1, 1), (1, 2, 2), (-1, 4, 4)),  # dilated, full sub-grid window
    None,  # dense
    ((-1, 3, 3), (1, 1, 2), (1, 1, 1), (-1, 4, 4)),
)
SPARSE_CASES = {
    # 1 dense block of 3, window and stride scaled from a 16 x 24 grid to the input's 8 x 12
    "interleave, adapted": dict(num_blocks=3, n_dense_blocks=1, natten_window=(-1, 8, 12), natten_stride=(1, 2, 4),
                                natten_base_size=(-1, 16, 24)),
    "per-layer list with a dilated layer": dict(num_blocks=3, natten_parameters=PER_LAYER),
}


@pytest.mark.parametrize("cfg", [dict(num_blocks=28, n_dense_blocks=7), dict(num_blocks=5, n_dense_blocks=1),
                                 dict(num_blocks=4, n_dense_blocks=0), dict(num_blocks=3, natten_parameters=PER_LAYER)])
def test_block_layout_matches_jax(cfg):
    from cosmos_predict2_tpu.networks.dit import block_layout as jax_block_layout

    jcfg, tcfg = tiny_configs(**cfg)
    sparse, overrides = jax_block_layout(jcfg)
    layout = tdit.block_layout(tcfg)
    assert [p is not None for p in layout] == sparse
    if cfg.get("natten_parameters") is not None:
        assert layout == [None if o is None else tuple(o) for o in overrides]
    else:
        default = (tcfg.natten_window, tcfg.natten_stride, tcfg.natten_dilation, tcfg.natten_base_size)
        assert overrides == [None] * tcfg.num_blocks and layout == [default if s else None for s in sparse]


def _sparse_inputs(jcfg):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 16, 3, 16, 24)).astype(np.float32)  # 3 x 8 x 12 tokens: W padded to a 16-wide tile
    t = np.asarray([700.0], np.float32)
    ctx = rng.standard_normal((1, 6, jcfg.crossattn_emb_channels)).astype(np.float32)
    return x, t, ctx


@pytest.mark.parametrize("case", list(SPARSE_CASES))
def test_sparse_dit_forward_matches_jax(case):
    """A small DiT with sparse blocks (head_dim 128) on the same weights:
    the port's neighborhood attention (plain versions of K10) against the
    JAX DiT's (its CPU route, the dense masked reference)."""
    jcfg, tcfg = tiny_configs(**SPARSE_CASES[case])
    x, t, ctx = _sparse_inputs(jcfg)
    params = seeded_jax_params(jcfg, x, t, ctx)
    want = JDiT(jcfg).apply(params, x, t, ctx)
    net = tdit.MiniTrainDIT(tcfg)
    net.load_state_dict(jax_dit_params_to_torch(params, tcfg), strict=True)
    with torch.no_grad():
        got = net(*map(torch.from_numpy, (x, t, ctx)))
        dense = tdit.MiniTrainDIT(dataclasses.replace(tcfg, n_dense_blocks=-1, natten_parameters=None))
        dense.load_state_dict(net.state_dict(), strict=True)
        assert float((got - dense(*map(torch.from_numpy, (x, t, ctx)))).abs().max()) > 1e-3  # the windows matter
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_sparse_dit_with_full_window_equals_dense():
    """All blocks sparse with a full window: the same network as the dense DiT."""
    _, tcfg = tiny_configs(num_blocks=2)
    dense = tdit.build_dit(tcfg, "cpu", seed=6)
    full = tdit.MiniTrainDIT(dataclasses.replace(tcfg, n_dense_blocks=0, natten_window=(-1, -1, -1)))
    full.load_state_dict(dense.state_dict(), strict=True)
    x, t, ctx = _sparse_inputs(tcfg)
    with torch.no_grad():
        a, b = (net(*map(torch.from_numpy, (x, t, ctx))) for net in (dense, full))
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
