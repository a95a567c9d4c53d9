"""The port's released-experiment names, checkpoint DB, model loader and
released-weights verifier, held against the JAX package (CPU).

* Every experiment the port registers composes to the JAX package's config,
  field by field; the port's names and its waiting list together are the
  JAX registry's names.
* The DB resolves an entry's ``uri``, then the cache directory, and
  otherwise raises FileNotFoundError naming the path; it never reaches for
  a downloader.
* ``load_model_from_checkpoint`` reads a consolidated state dict written
  by the JAX package's ``utils/checkpoint_export.py`` (the mini net and
  the dim-16 VAE of ``error-free_mock_data_smoke``, distinct ``net.`` and
  ``net_ema.`` weights): EMA first, ``net.`` with ``load_ema_to_reg=False``,
  every weight equal to the file's (bf16-stored matmul weights equal to
  the file's value rounded to bf16); its pipeline gives the JAX loader's
  pipeline's pixels within 1e-1 relative L2. Both compute in bf16, the
  smoke config's dtype: on these weights each is 2.8e-2 (JAX) and 3.0e-2
  (the port) relative L2 from the port in fp32, and they differ from each
  other by 3.5e-2 (max-abs 8.0e-2 on [-1, 1]); about 3x margin.
* At the true 2B and 14B shapes the port's DiT state dict (built on the
  meta device: no tensor is made) has exactly the keys and shapes of the
  JAX package's export.
* A golden blessed by the JAX verifier on the smoke experiment is met by
  the port's verifier at PSNR >= 35 dB.
* The 14B sparse pair and the gr00t action names build through the
  registry; comb02's 35 sparse layers pass the kernels' plan at the 720p
  token grid and its 13 dilated ones are refused at 480p's; a DiT with a
  per-layer list of comb02's kinds (dilated full sub-grid, mixed stride
  and dilation, strided, dense) matches JAX's at 1e-4, as
  tests/test_torch_dit.py's sparse DiTs.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.configs.defaults import make_config as jax_make_config
from cosmos_predict2_tpu.configs.registry import list_experiments as jax_list_experiments
from cosmos_predict2_tpu_torch.configs.defaults import make_config
from cosmos_predict2_tpu_torch.configs.registry import Experiment, list_experiments, register_experiment, resolve_experiment
from cosmos_predict2_tpu_torch.configs.released_experiments import INDEX_26, INDEX_26_RESUME2, WAITING
from cosmos_predict2_tpu_torch.utils import checkpoint_db as db
from torch_variants_util import jit_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = "error-free_mock_data_smoke"
PORT_NAMES = list_experiments()


def _same(tobj, jobj, path=""):
    for f in dataclasses.fields(tobj):
        tv, jv = getattr(tobj, f.name), getattr(jobj, f.name)
        if dataclasses.is_dataclass(tv):
            _same(tv, jv, f"{path}{f.name}.")
        elif isinstance(tv, torch.dtype):
            assert str(tv).removeprefix("torch.") == jnp.dtype(jv).name, path + f.name
        else:
            assert tv == jv, (path + f.name, tv, jv)


# ------------------------------- registry -------------------------------


@pytest.mark.parametrize("experiment", PORT_NAMES)
def test_registered_config_matches_jax(experiment):
    """Every field of the port's config equals the JAX package's."""
    t, j = make_config(experiment), jax_make_config(experiment)
    for group in ("model", "tokenizer", "trainer", "data_train"):
        _same(getattr(t, group), getattr(j, group), group + ".")


def test_registered_names_and_waiting_list_are_the_jax_registry():
    """Nothing is silently missing: each JAX name is registered in the port
    or waits for a named roadmap item, never both; since the variants'
    training recipes came (A13.t) none waits. (Names that begin with an
    underscore are registered by tests at run time.)"""
    waiting = [name for name, _ in WAITING]
    assert len(set(waiting)) == len(waiting)
    assert not set(waiting) & set(PORT_NAMES)
    jax_names = {n for n in jax_list_experiments() if not n.startswith("_")}
    assert set(PORT_NAMES) | set(waiting) == jax_names
    assert WAITING == ()
    assert {"ac_reason_embeddings_rectified_flow_2b_256_320", "predict2_multiview_post_train_waymo"} <= set(PORT_NAMES)


def test_base_chains_fold_and_overrides_stay_typed():
    """Two levels of base (nemo assets -> resume2 -> Index-26 -> the 2B
    recipe) fold their overrides; a dotlist string takes the field's type;
    a ``group=name`` token selects a registry node."""
    exp = resolve_experiment("predict2_video2world_training_2b_cosmos_nemo_assets")
    assert exp.groups["net"] == "cosmos_v1_2B" and exp.overrides["model.use_high_sigma_strategy"] is True
    assert exp.overrides["data_train.height"] == 704
    assert resolve_experiment(INDEX_26_RESUME2).overrides == resolve_experiment(INDEX_26).overrides
    cfg = make_config("predict2_video2world_training_2b_groot_gr1_480", ["model.state_t=3", "net=mini_net"])
    assert (cfg.data_train.height, cfg.data_train.width, cfg.model.state_t) == (432, 768, 3)
    assert cfg.model.net.num_blocks == 2 and cfg.model.use_high_sigma_strategy
    with pytest.raises(KeyError, match="unknown experiment"):
        make_config("no_such_experiment")
    register_experiment(Experiment(name="_released_test_override", base="predict2_video2world_14b_rectified_flow",
                                   overrides={"model.net.no_such_field": 1}))
    with pytest.raises(AttributeError, match="no_such_field"):
        make_config("_released_test_override")


def test_lora_recipe_and_local_folder_are_registered():
    """The released LoRA recipe: the cosmos-nemo-assets post-training recipe
    (93 frames at 704x1280, batch 1, 1000 iterations saved every 200) with
    rank-32, alpha-32 adapters on JAX's targets; ``data_train=local_video``
    selects the local folder of clips with JAX's defaults."""
    from cosmos_predict2_tpu.data.local_dataset import LocalVideoDatasetConfig as JLocal
    from cosmos_predict2_tpu_torch.data.local_dataset import LocalVideoDatasetConfig
    from cosmos_predict2_tpu_torch.training.lora import DEFAULT_TARGETS

    name = "predict2_lora_training_2b_cosmos_nemo_assets"
    nemo = resolve_experiment("predict2_video2world_training_2b_cosmos_nemo_assets")
    assert resolve_experiment(name).overrides.items() >= nemo.overrides.items()
    cfg = make_config(name, ["data_train=local_video", "data_train.root=/clips"])
    m = cfg.model
    assert (m.use_lora, m.lora_rank, m.lora_alpha, m.lora_targets) == (True, 32, 32.0, DEFAULT_TARGETS)
    assert (cfg.trainer.max_iter, cfg.trainer.save_iter, m.use_high_sigma_strategy) == (1000, 200, True)
    assert isinstance(cfg.data_train, LocalVideoDatasetConfig) and cfg.data_train.root == "/clips"
    j = jax_make_config(name, ["data_train=local_video", "data_train.root=/clips"])
    assert dataclasses.asdict(cfg.data_train) == dataclasses.asdict(j.data_train) and isinstance(j.data_train, JLocal)
    _same(cfg.model, j.model, "model.")


# ------------------------------- checkpoint DB -------------------------------


def test_checkpoint_db_table_matches_jax():
    from cosmos_predict2_tpu.utils import checkpoint_db as jdb

    port = [dataclasses.asdict(e) for e in db.list_checkpoints()]
    assert port == [dataclasses.asdict(e) for e in jdb.list_checkpoints()]
    entry = db.find_by_experiment(INDEX_26_RESUME2)
    assert entry.name == "nvidia/Cosmos-Predict2.5-2B/base/pre-trained"
    assert db.get_checkpoint_by_uuid(entry.uuid) == entry
    for e in db.list_checkpoints():  # every DB model's experiment resolves or waits
        if e.experiment != "-":
            assert e.experiment in PORT_NAMES or e.experiment in dict(WAITING), e.experiment


def test_checkpoint_path_resolves_uri_then_cache_dir_and_never_downloads(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # any import of it would raise
    monkeypatch.setattr(db, "_DB", dict(db._DB))  # the entries below stay in this test
    uri = tmp_path / "given.pt"
    uri.write_bytes(b"x")
    db.register_checkpoint(db.CheckpointEntry(uuid="test-uuid-uri", name="test/uri", experiment=SMOKE, uri=str(uri)))
    assert db.get_checkpoint_path("test/uri") == str(uri) == db.get_checkpoint_path("test-uuid-uri")

    monkeypatch.setenv("COSMOS_CHECKPOINT_DIR", str(tmp_path / "cache"))
    entry = db.CheckpointEntry(uuid="test-uuid-cache", name="test/cache", experiment=SMOKE, hf_repo="org/repo",
                               hf_filename="base/model_ema_bf16.pt", uri=str(tmp_path / "absent.pt"))
    db.register_checkpoint(entry)
    local = tmp_path / "cache" / "test/cache" / "base/model_ema_bf16.pt"
    with pytest.raises(FileNotFoundError) as err:
        db.get_checkpoint_path("test-uuid-cache")
    assert str(local) in str(err.value)
    local.parent.mkdir(parents=True)
    local.write_bytes(b"x")
    assert db.get_checkpoint_path("test/cache") == str(local)
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "elsewhere")):
        db.get_checkpoint_path("test/cache", cache_dir=str(tmp_path / "elsewhere"))
    src = open(os.path.join(REPO, "cosmos_predict2_tpu_torch", "utils", "checkpoint_db.py")).read()
    assert "huggingface" not in src and "import requests" not in src


# ------------------------------- model loader -------------------------------


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A consolidated DiT file and a VAE file written by the JAX package's
    export: ``net_ema.`` from one seed, ``net.`` from another."""
    from cosmos_predict2_tpu.models.video2world import Video2WorldModel as JModel
    from cosmos_predict2_tpu.tokenizers.wan_vae import WanVAE as JVAE
    from cosmos_predict2_tpu.utils import checkpoint_export as ce

    jcfg = jax_make_config(SMOKE)
    model = JModel(jcfg.model)
    ema = jit_init(model.init_params, jax.random.PRNGKey(0), (1, 16, 2, 4, 4), text_len=8)
    reg = jit_init(model.init_params, jax.random.PRNGKey(1), (1, 16, 2, 4, 4), text_len=8)
    sd_ema = ce.export_dit_state_dict(jax.tree.map(np.asarray, ema), prefix="net_ema.")
    sd_reg = ce.export_dit_state_dict(jax.tree.map(np.asarray, reg), prefix="net.")
    vae_params = jit_init(JVAE(jcfg.tokenizer).init, jax.random.PRNGKey(2), jnp.zeros((1, 5, 16, 16, 3)))
    sd_vae = ce.export_vae_state_dict(jax.tree.map(np.asarray, vae_params))
    d = tmp_path_factory.mktemp("exported")
    ce.save_torch_state_dict({**sd_reg, **sd_ema}, str(d / "model.pt"))
    ce.save_torch_state_dict(sd_vae, str(d / "vae.pth"))
    return str(d / "model.pt"), str(d / "vae.pth"), sd_ema, sd_reg, sd_vae


def _check_weights(module, sd, prefix=""):
    for k, v in module.state_dict().items():
        want = torch.from_numpy(np.asarray(sd[prefix + k])).reshape(v.shape)
        assert torch.equal(v, want.to(v.dtype)), k


@pytest.mark.parametrize("ema", [True, False])
def test_loader_reads_the_jax_export_ema_first(exported, ema):
    from cosmos_predict2_tpu_torch.utils.model_loader import load_model_from_checkpoint

    dit, vae, sd_ema, sd_reg, sd_vae = exported
    pipe, cfg = load_model_from_checkpoint(SMOKE, dit, vae, load_ema_to_reg=ema, size_override=(32, 32), device="cpu")
    assert cfg == make_config(SMOKE) and pipe.setup.streaming_vae and pipe.video_size() == (32, 32)
    _check_weights(pipe.net, sd_ema if ema else sd_reg, "net_ema." if ema else "net.")
    _check_weights(pipe.vae, sd_vae)
    assert {p.dtype for n, p in pipe.net.named_parameters() if n.endswith("q_proj.weight")} == {torch.bfloat16}


def test_loaded_pipeline_matches_the_jax_loader(exported):
    from cosmos_predict2_tpu.utils.model_loader import load_model_from_checkpoint as jax_loader
    from cosmos_predict2_tpu_torch.utils.model_loader import load_model_from_checkpoint

    dit, vae, *_ = exported
    jpipe, _ = jax_loader(SMOKE, dit, vae, size_override=(32, 32))
    pipe, _ = load_model_from_checkpoint(SMOKE, dit, vae, size_override=(32, 32), device="cpu")
    rng = np.random.default_rng(3)
    video = rng.integers(0, 256, (1, 3, 5, 32, 32), dtype=np.uint8)
    emb = rng.standard_normal((1, 8, 1024)).astype(np.float32)
    want = jpipe.generate_vid2world(video, jnp.asarray(emb), num_steps=2, num_conditional_frames=1)
    got = pipe.generate_vid2world(video, emb, num_steps=2, num_conditional_frames=1)
    assert got.shape == want.shape == (5, 32, 32, 3)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-1


def test_loader_resolves_db_names_and_raises_with_the_path(exported, tmp_path, monkeypatch):
    from cosmos_predict2_tpu_torch.utils.model_loader import load_model_from_checkpoint, resolve_checkpoint

    dit, *_ = exported
    monkeypatch.setattr(db, "_DB", dict(db._DB))
    db.register_checkpoint(db.CheckpointEntry(uuid="test-uuid-loader", name="test/loader", experiment=SMOKE, uri=dit))
    assert resolve_checkpoint("test/loader") == resolve_checkpoint("test-uuid-loader") == resolve_checkpoint(dit) == dit
    monkeypatch.setenv("COSMOS_CHECKPOINT_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        load_model_from_checkpoint(SMOKE, "nvidia/Cosmos-Predict2.5-2B/base/pre-trained", device="cpu")
    with pytest.raises(FileNotFoundError, match="neither a file"):
        resolve_checkpoint(str(tmp_path / "no_such.pt"))


# ------------------------------- true shapes -------------------------------


@pytest.mark.parametrize("experiment", [INDEX_26_RESUME2, "predict2_video2world_14b_rectified_flow",
                                        "predict2_video2world_2b_action_conditioned",
                                        "predict2_video2world_2b_camera_conditioned", "predict2_multiview_2b_7views",
                                        "cosmos_predict2p5_2B_action_gr00t_gr1_warmup"])
def test_true_shape_state_dict_equals_the_jax_export(experiment, monkeypatch):
    """Keys and shapes at the released sizes, without making a tensor: the
    port's net on the meta device, JAX's export over ``jax.eval_shape``
    with zero-stride stand-ins and shape-only transposes. JAX's camera net
    is initialised with ``camera=`` so that its cam_encoders exist; its
    multiview net on 7 latent frames and 7 caption tokens, one per view."""
    from cosmos_predict2_tpu.models.video2world import Video2WorldModel as JModel
    from cosmos_predict2_tpu.utils import checkpoint_export as ce
    from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT
    from cosmos_predict2_tpu_torch.utils.checkpoint_export import export_dit_state_dict

    stand_in = lambda shape: np.broadcast_to(np.float32(0), tuple(shape))  # noqa: E731
    monkeypatch.setattr(ce, "_t", lambda w: stand_in(np.shape(w)[::-1]))
    model = JModel(jax_make_config(experiment).model)
    V = model.config.net.n_views
    if model.config.net.camera_dim is not None:
        def init(r):
            x, ctx = jnp.zeros((1, 16, 2, 8, 8)), jnp.zeros((1, 8, model.config.net.crossattn_proj_in_channels))
            return model.net.init(r, x, jnp.zeros((1,)), ctx, camera=jnp.zeros((1, 2, 4, 4, 6)))
    else:
        def init(r):
            return model.init_params(r, (1, 16, 2 if V == 1 else V, 8, 8), text_len=8 if V == 1 else V)
    template = jax.eval_shape(init, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in
            ce.export_dit_state_dict(jax.tree.map(lambda s: stand_in(s.shape), template), prefix="net_ema.").items()}

    cfg = make_config(experiment).model.net
    with torch.device("meta"):
        net = MiniTrainDIT(cfg)
    got = export_dit_state_dict(net, prefix="net_ema.")
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert {v.device.type for v in got.values()} == {"meta"}
    n = sum(v.numel() for v in got.values())
    assert (n > 1.9e9) if cfg.model_channels == 2048 else (n > 1.4e10)


# ------------------------------- verifier -------------------------------


# the smoke experiment's nets (mini DiT, dim-16 VAE) on the 2B recipe: the
# JAX script passes fps for batch 1 into the CFG pass at batch 2, which the
# smoke config's fps-modulated RoPE cannot take, so the handoff runs with
# the 2B recipe's RoPE (fps modulation off)
HANDOFF = {
    "model.net.model_channels": 1024,
    "model.net.num_heads": 8,
    "model.net.num_blocks": 2,
    "model.net.use_crossattn_projection": False,
    "tokenizer.dim": 16,
}


def test_port_verifier_meets_the_jax_verifier_golden(exported, tmp_path, capsys):
    """The JAX script blesses a golden (2 steps, 5 frames at 64x64, decoded
    by the VAE) on the smoke experiment's nets; the port's script meets it,
    and fails on a perturbed checkpoint and on a missing key."""
    from cosmos_predict2_tpu.configs import registry as jax_registry

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import verify_released_weights as jax_vrw
    finally:
        sys.path.pop(0)
    from cosmos_predict2_tpu_torch.scripts import verify_released_weights as vrw
    from cosmos_predict2_tpu_torch.utils.checkpoint_export import save_torch_state_dict

    name = "_verify_handoff_mini"
    for registry in (jax_registry, sys.modules["cosmos_predict2_tpu_torch.configs.registry"]):
        registry.register_experiment(registry.Experiment(name=name, base="predict2_video2world_2b_rectified_flow",
                                                         overrides=dict(HANDOFF)))
    dit, vae, sd_ema, sd_reg, _ = exported
    golden = str(tmp_path / "golden.npz")
    common = ["--experiment", name, "--vae", vae, "--golden", golden]
    assert jax_vrw.main(["--dit", dit, *common, "--write-golden", "--cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["golden_written"] == golden
    assert vrw.main(["--dit", dit, *common, "--cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["psnr_db"] >= 35 and out["decoded"]

    bad = {k: torch.from_numpy(np.asarray(v)) for k, v in sd_ema.items()}
    bad["net_ema.blocks.0.self_attn.q_proj.weight"] += 0.5
    save_torch_state_dict(bad, str(tmp_path / "bad.pt"))
    assert vrw.main(["--dit", str(tmp_path / "bad.pt"), *common, "--cpu"]) == 1
    assert not json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ok"]
    del bad["net_ema.final_layer.linear.weight"]
    save_torch_state_dict(bad, str(tmp_path / "missing.pt"))
    assert vrw.main(["--dit", str(tmp_path / "missing.pt"), *common, "--cpu"]) == 1
    assert "contract" in json.loads(capsys.readouterr().out.strip().splitlines()[-1])["error"]


# ------------------------- the 14B sparse pair, gr00t -------------------------


SPARSE_14B = ("predict2_video2world_14b_sparse", "predict2_video2world_14b_sparse_comb02")
GR00T = ("cosmos_predict2p5_2B_action_conditioned_gr00t_gr1_customized_13frame_sf_warmup",
         "cosmos_predict2p5_2B_action_gr00t_gr1_warmup")


@pytest.mark.parametrize("experiment", SPARSE_14B + GR00T)
def test_sparse_pair_and_gr00t_names_build_through_the_registry(experiment):
    """Each name's net on the meta device: the 14B sparse name's 9 dense
    blocks spread over 36 as JAX lays them out, comb02's per-layer list
    (JAX's tuple, layer 27 dense), the gr00t names' causal 2B with action
    embedders of 7 x 12 x 12 inputs at 4 latent frames."""
    from cosmos_predict2_tpu.networks.dit import block_layout as jax_block_layout
    from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT, block_layout

    cfg, jcfg = make_config(experiment), jax_make_config(experiment)
    with torch.device("meta"):
        net = MiniTrainDIT(cfg.model.net)
    layout = block_layout(cfg.model.net)
    assert [p is not None for p in layout] == jax_block_layout(jcfg.model.net)[0]
    if experiment in GR00T:
        assert cfg.model.net.temporal_causal and cfg.model.state_t == 4 and not any(layout)
        assert net.action_embedder_B_D.fc1.in_features == 7 * 12 * 12 and net.cfg.model_channels == 2048
        return
    assert net.cfg.model_channels == 5120 and len(net.blocks) == 36
    if experiment.endswith("comb02"):
        assert cfg.model.net.natten_parameters == jcfg.model.net.natten_parameters
        assert [i for i, p in enumerate(layout) if p is None] == [27]
        assert {p[2] for p in layout[:11]} == {(1, 11, 5)} and {p[2] for p in layout[11:13]} == {(1, 1, 5)}
    else:
        assert sum(p is None for p in layout) == 9


@pytest.mark.parametrize("grid,refused", [((24, 44, 80), []), ((21, 30, 52), list(range(13)))])
def test_comb02_layers_at_720p_pass_and_at_480p_the_dilated_are_refused(grid, refused):
    """At the released 720p grid (T x 44 x 80 tokens) every sparse layer of
    comb02 scales to parameters the kernels take; at 480p (30 x 52) the
    13 dilated layers' windows no longer cover their sub-grids and the
    plan refuses them (ROADMAP: A8's per-class windows)."""
    from cosmos_predict2_tpu_torch.configs.defaults import COMB02_NATTEN_PARAMETERS
    from cosmos_predict2_tpu_torch.ops.neighborhood_attention import VideoSize, adaptive_na_parameters, effective_params

    got = []
    for i, p in enumerate(COMB02_NATTEN_PARAMETERS):
        if p is None:
            continue
        window, stride, dilation = adaptive_na_parameters(p[0], p[1], grid, p[3], p[2])
        try:
            effective_params(VideoSize(*grid), window, stride, dilation)
        except NotImplementedError as e:
            assert "sub-grid" in str(e)
            got.append(i)
    assert got == refused


def test_dit_with_comb02_kinds_of_layer_matches_jax():
    """A 4-block DiT (head_dim 128) whose per-layer list holds one of each
    of comb02's kinds at a grid where each passes unscaled: a dilated full
    sub-grid window, stride and dilation mixed, a strided window and a
    dense block; the port's plain K10 route against JAX's DiT."""
    from cosmos_predict2_tpu.networks.dit import MiniTrainDIT as JDiT
    from torch_variants_util import port_net, tiny_jax_config

    base = (-1, 4, 8)
    layers = (((-1, 2, 4), (1, 1, 1), (1, 2, 2), base), ((-1, 2, 4), (1, 2, 1), (1, 1, 2), base),
              ((-1, 3, 4), (1, 1, 2), (1, 1, 1), base), None)
    jcfg = tiny_jax_config(num_blocks=4, natten_parameters=layers)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 16, 2, 8, 16)).astype(np.float32)
    t, ctx = np.asarray([600.0], np.float32), rng.standard_normal((1, 6, 64)).astype(np.float32)
    shapes = jax.eval_shape(lambda r: JDiT(jcfg).init(r, x, t, ctx), jax.random.PRNGKey(0))
    draw = lambda leaf: (rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])).astype(np.float32)  # noqa: E731
    params = jax.tree.map(draw, shapes)
    want = jax.jit(JDiT(jcfg).apply)(params, x, t, ctx)
    net = port_net(params, jcfg)
    with torch.no_grad():
        got = net(*map(torch.from_numpy, (x, t, ctx)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
