"""The port's guardrails held against the JAX package on the CPU: the
blocklist (utils/blocklist.py), the validator and env parsers
(utils/validator.py, env_parsers.py), RetinaFace (utils/retinaface.py)
and utils/guardrails.py (the safety head and video filter over a tiny
SigLIP, the runner's face blur, the Qwen guards, the heuristic detector).

Tolerances: the pure-Python layers (blocklist, validator, env parsers, box
math, heuristic detector, verdict parsers) must agree exactly. fp32 on both
sides: the safety head's logits agree to 7.5e-7 (checked at 1e-5);
RetinaFace at 64x96 on converted seeded weights to 5.7e-6 on loc (values
up to 4.6), 1.5e-6 on conf and 5.5e-6 on landmarks (checked at 1e-4); the
tiny guard LMs' logits to ~1e-6 (1e-5); their greedy tokens and the
verdicts, the safety classes and the pixelated frames are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  torch's CPU threads under xdist

from cosmos_predict2_tpu.text_encoders import qwen as jqwen
from cosmos_predict2_tpu.text_encoders import siglip_vision as jsig
from cosmos_predict2_tpu.utils import blocklist as jbl
from cosmos_predict2_tpu.utils import env_parsers as jenv
from cosmos_predict2_tpu.utils import guardrails as jg
from cosmos_predict2_tpu.utils import retinaface as jrf
from cosmos_predict2_tpu.utils import validator as JV
from cosmos_predict2_tpu_torch.text_encoders import qwen as tqwen
from cosmos_predict2_tpu_torch.text_encoders import siglip_vision as tsig
from cosmos_predict2_tpu_torch.utils import blocklist as tbl
from cosmos_predict2_tpu_torch.utils import env_parsers as tenv
from cosmos_predict2_tpu_torch.utils import guardrails as tg
from cosmos_predict2_tpu_torch.utils import retinaface as trf
from cosmos_predict2_tpu_torch.utils import validator as TV
from cosmos_predict2_tpu_torch.utils.convert import jax_qwen_params_to_torch, jax_siglip_params_to_torch
from torch_variants_util import jit_init, noisy_params

# ------------------------------- blocklist -------------------------------

PROMPTS = [
    "a robot arm stacking boxes in a warehouse",  # clean
    "extreme gore footage",  # exact censor word
    "a video of a beheading",  # exact censor word
    "child porn",  # multi-word censor phrase
    "child   pornography at night",  # multi-word, extra spaces
    "g0re and d1smember",  # leet variants
    "m0lestati0n",  # leet
    "three decapitations on camera",  # lemma-inflected plural
    "they tortured him",  # lemma-inflected verb
    "mutilated bodies",  # lemma-inflected
    "a grapefruit on the table",  # whole-word: no substring match
    "a pornographer's studio",  # whole-word
    "nazi rally",  # exact-match list
    "the third   reich parade",  # exact-match phrase
    "a hitlerr poster",  # partial match on the exact-match list
    "swastikaa",  # partial match
    "a basement workshop",  # whitelisted in the keyword directory
    "a zorgon appears",  # custom word of the keyword directory
    "flibber attack at dawn",  # multi-word custom word
    "the quuxmark stands",  # exact-match word of the keyword directory
    "quuxmarc",  # partial of it
    "un café à Paris",  # non-ASCII stripped
    "",  # empty input is unsafe
    "ASSAULT!",  # case and punctuation
]


@pytest.fixture(scope="module")
def keyword_dir(tmp_path_factory):
    """The released Cosmos-Guardrail1 layout: custom/ whitelist/ exact_match/."""
    root = tmp_path_factory.mktemp("blocklist")
    for sub, files in (("custom", {"a.txt": ["zorgon", "flibber attack", "basement", "gore"], "b.txt": ["assault"]}),
                       ("whitelist", {"w.txt": ["basement"]}),
                       ("exact_match", {"e.txt": ["quuxmark", "nazi"]})):
        (root / sub).mkdir()
        for name, words in files.items():
            (root / sub / name).write_text("\n".join(words) + "\n\n")
    return str(root)


@pytest.mark.parametrize("source", ["default", "keyword_dir"])
@pytest.mark.parametrize("prompt", PROMPTS)
def test_blocklist_is_safe_matches_jax(source, prompt, keyword_dir):
    ckpt = keyword_dir if source == "keyword_dir" else None
    got = tbl.Blocklist(checkpoint_dir=ckpt).is_safe(prompt)
    assert got == jbl.Blocklist(checkpoint_dir=ckpt).is_safe(prompt)
    assert isinstance(got[0], bool) and isinstance(got[1], str)


def test_blocklist_helpers_match_jax(keyword_dir):
    assert tbl.read_keyword_list_from_dir(keyword_dir + "/custom") == jbl.read_keyword_list_from_dir(
        keyword_dir + "/custom")
    assert tbl.read_keyword_list_from_dir(keyword_dir + "/missing") == []
    words = ["knives", "children", "tortures", "beheadings", "gore", "raping", "mutilated", "boxes", "ss", "s"]
    assert [tbl.lemmatize(w) for w in words] == [jbl.lemmatize(w) for w in words]
    assert tbl.to_ascii("un café à Paris") == jbl.to_ascii("un café à Paris")
    for text in ("a55ault footage", "a salt shaker", "ASSAULT!", "@ssault"):
        assert tbl.LeetCensor(["assault"]).censor(text) == jbl.LeetCensor(["assault"]).censor(text)
    for prompt, word, leeway in (("this contains badw0rd here", "badword", 1.0), ("look a child abuze", "child abuse",
                                                                                  1.0), ("clean", "badword", 0.4)):
        assert tbl.Blocklist.check_partial_match(prompt, word, leeway) == jbl.Blocklist.check_partial_match(
            prompt, word, leeway)


# --------------------------- validator and env ---------------------------


def _params_class(V):
    class Params(V.ValidatedParams):
        steps = V.Int(default=35, min=1, max=200)
        guidance = V.Float(default=7.0, min=0.0, max=30.0)
        mode = V.OneOf(default="video", options=("video", "image"))
        frames = V.MultipleOf(default=8, multiple_of=4, type_cast=int)
        verbose = V.Bool(default=False)
        prompt = V.String(default="", max_len=16)
        hidden = V.Int(default=1, hidden=True)
        image = V.InputImage(default=None)

    return Params


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001
        return (type(e).__name__, str(e))


VALIDATOR_CASES = [
    {}, {"steps": "12", "verbose": "true", "frames": "16"}, {"guidance": 3}, {"mode": "image", "prompt": "hi"},
    {"steps": 0}, {"steps": 201}, {"guidance": -1.0}, {"mode": "audio"}, {"frames": 7}, {"verbose": 3.14},
    {"verbose": "maybe"}, {"prompt": "x" * 17}, {"stepz": 5}, {"hidden": 2}, {"steps": True}, {"image": "/nonexistent.png"},
]


@pytest.mark.parametrize("payload", VALIDATOR_CASES)
def test_validator_round_trip_and_rejections_match_jax(payload):
    tp, jp = _params_class(TV), _params_class(JV)
    got = _outcome(lambda: tp.from_dict(payload).to_dict())
    assert got == _outcome(lambda: jp.from_dict(payload).to_dict())
    assert tp.schema() == jp.schema() and "hidden" not in tp.schema()


def test_validator_mandatory_and_media_paths_match_jax(tmp_path):
    png = tmp_path / "a.png"
    png.write_bytes(b"\x89PNG")
    for V in (TV, JV):
        class Strict(V.ValidatedParams):
            required = V.Int(min=0)
            video = V.InputVideo(default=None)

        with pytest.raises(ValueError, match="mandatory"):
            Strict.from_dict({})
        assert Strict.from_dict({"required": 5}).required == 5
        with pytest.raises(ValueError, match="Unsupported format"):
            Strict.from_dict({"required": 1, "video": str(png)})
    assert _outcome(lambda: _params_class(TV).from_dict({"image": str(png)}).image) == (
        _outcome(lambda: _params_class(JV).from_dict({"image": str(png)}).image))


ENV = {"PORT": "9001", "NUM_CHIPS": "2", "CP_SIZE": "4", "DISABLE_GUARDRAILS": "true", "CHECKPOINT_HOME": "/ckpt",
       "CHECKPOINT_ACCESS_KEY_ID": "AK", "TEAM_DIR_REGION_NAME": "eu-west-1"}


def test_env_parsers_round_trip_match_jax(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    got, want = tenv.get_inference_envs().to_dict(), jenv.get_inference_envs().to_dict()
    assert got.pop("MODEL_MODULE") == "cosmos_predict2_tpu_torch.inference.api"
    assert want.pop("MODEL_MODULE") == "cosmos_predict2_tpu.inference.api"
    assert got == want and got["PORT"] == 9001 and got["DISABLE_GUARDRAILS"] is True
    # a launcher's base64 payload, written by either package, restores the same set
    for b64 in (tenv.InferenceEnvParser().to_b64(), jenv.InferenceEnvParser().to_b64()):
        back = tenv.InferenceEnvParser(b64).to_dict()
        back.pop("MODEL_MODULE")
        assert back == want
    tc, jc = tenv.get_credential_envs(), jenv.get_credential_envs()
    assert tc.to_dict() == jc.to_dict()
    for role in ("checkpoint", "TEAM_DIR"):
        assert tc.backend_args(role) == jc.backend_args(role)
    with pytest.raises(ValueError, match="unknown credential role"):
        tc.backend_args("other")


@pytest.mark.parametrize("env", [{"PORT": "0"}, {"PORT": "70000"}, {"NUM_CHIPS": "-1"}, {"DISABLE_GUARDRAILS": "perhaps"},
                                 {"TP_SIZE": "x"}])
def test_env_parser_rejections_match_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = _outcome(lambda: tenv.InferenceEnvParser().to_dict())
    assert got[0] != "ok" and got == _outcome(lambda: jenv.InferenceEnvParser().to_dict())


# ------------------------------ safety head ------------------------------


def _safety_state_dict(seed=0, d=1152, fc3_bias=None):
    """A released-layout classifier state dict drawn with NumPy."""
    rng = np.random.default_rng(seed)
    sd = {}
    for i, (n_in, n_out) in ((0, (d, 512)), (3, (512, 256)), (6, (256, 7))):
        sd[f"network.layers.{i}.weight"] = (rng.standard_normal((n_out, n_in)) / np.sqrt(n_in)).astype(np.float32)
        sd[f"network.layers.{i}.bias"] = (0.1 * rng.standard_normal(n_out)).astype(np.float32)
    for i, n in ((1, 512), (4, 256)):
        sd[f"network.layers.{i}.weight"] = (1 + 0.2 * rng.standard_normal(n)).astype(np.float32)
        sd[f"network.layers.{i}.bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
        sd[f"network.layers.{i}.running_mean"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
        sd[f"network.layers.{i}.running_var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    if fc3_bias is not None:
        sd["network.layers.6.bias"] = np.asarray(fc3_bias, np.float32)
    return sd


def test_safety_head_matches_jax():
    sd = _safety_state_dict()
    head = tg.build_safety_classifier({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, device="cpu")
    assert not head.training
    x = np.random.default_rng(1).standard_normal((6, 1152)).astype(np.float32)
    want = np.asarray(jg.safety_classifier_apply(jg.convert_safety_classifier_state_dict(sd), jnp.asarray(x)))
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    seeded = tg.build_safety_classifier(device="cpu", seed=0)
    assert all(float(m.running_var.min()) == 1 for m in seeded.modules() if isinstance(m, torch.nn.BatchNorm1d))


JSIG = jsig.SigLIPVisionConfig(image_size=28, patch_size=14, dim=64, mlp_dim=128, num_heads=2, num_layers=2,
                               dtype=jnp.float32)
TSIG = tsig.SigLIPVisionConfig(image_size=28, patch_size=14, dim=64, mlp_dim=128, num_heads=2, num_layers=2,
                               dtype=torch.float32)


@pytest.fixture(scope="module")
def siglip_pair():
    params = noisy_params(jit_init(jsig.SigLIPVisionTower(JSIG).init, jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3))))
    tower = tsig.SigLIPVisionTower(TSIG)
    tower.load_state_dict(jax_siglip_params_to_torch(params, TSIG), strict=True)
    return jax.tree.map(jnp.asarray, params), tower.eval()


# the head's last bias: as drawn, Safe (class 0) winning, an unsafe class winning
@pytest.mark.parametrize("fc3_bias", [None, [50.0, 0, 0, 0, 0, 0, 0], [0, 0, 0, 50.0, 0, 0, 0]])
@pytest.mark.parametrize("sample_every", [1, 4])
def test_video_safety_filter_matches_jax(siglip_pair, fc3_bias, sample_every):
    params, tower = siglip_pair
    sd = _safety_state_dict(seed=2, d=64, fc3_bias=fc3_bias)
    frames = np.random.default_rng(3).integers(0, 256, (9, 40, 48, 3), dtype=np.uint8)
    jfilt = jg.VideoContentSafetyFilter(jsig.make_frame_embedder(params, JSIG), jg.convert_safety_classifier_state_dict(sd),
                                        sample_every=sample_every)
    tfilt = tg.create_video_content_safety_filter(sd, siglip=tower, sample_every=sample_every, device="cpu")
    emb = jsig.make_frame_embedder(params, JSIG)(frames[::sample_every])
    emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    want_classes = np.asarray(jnp.argmax(jg.safety_classifier_apply(jfilt.params, jnp.asarray(emb)), axis=-1))
    np.testing.assert_array_equal(tfilt.classify(frames), want_classes)
    verdict = tfilt.is_safe_frames(frames)
    assert verdict == jfilt.is_safe_frames(frames) and tfilt(frames) == verdict
    if fc3_bias is not None:
        assert verdict == (fc3_bias[0] > 0)


def test_video_safety_filter_reads_siglip_state_dicts(siglip_pair, tmp_path, monkeypatch):
    """A SigLIP HF state dict (in memory or a file) is loaded into a tower
    built at the released widths; here the released config is shrunk to the
    tiny one, as a file of the tiny tower's keys says."""
    _, tower = siglip_pair
    monkeypatch.setattr(tsig, "SigLIPVisionConfig", lambda: TSIG)
    hf = {f"vision_model.{k}": v for k, v in tower.state_dict().items()}
    torch.save(hf, tmp_path / "siglip.pt")
    sd = _safety_state_dict(seed=2, d=64)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, tmp_path / "safety_filter.pt")
    frames = np.random.default_rng(4).integers(0, 256, (8, 40, 40, 3), dtype=np.uint8)
    want = tg.create_video_content_safety_filter(sd, siglip=tower, device="cpu").classify(frames)
    for kw in ({"siglip": hf}, {"siglip_ckpt": str(tmp_path / "siglip.pt")}):
        filt = tg.create_video_content_safety_filter(str(tmp_path / "safety_filter.pt"), device="cpu", **kw)
        np.testing.assert_array_equal(filt.classify(frames), want)
    with pytest.raises(ValueError, match="siglip"):
        tg.create_video_content_safety_filter(sd, device="cpu")


# ------------------------------- RetinaFace -------------------------------


def _retinaface_public_state_dict(seed=0):
    """The public Resnet50_Final.pth layout drawn with NumPy: conv weights
    N(0, 1/fan_in) (the stem's over the BGR range), BatchNorms with running
    statistics away from 0 and 1, head biases."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in trf.RetinaFace().state_dict().items()}
    sd = {}
    for port, conv, bn in trf._conv_names():
        if f"{port}.weight" not in shapes:
            continue
        shape = shapes[f"{port}.weight"]
        fan_in = int(np.prod(shape[1:]))
        sd[f"{conv}.weight"] = (rng.standard_normal(shape) / np.sqrt(fan_in) / (128 if port == "body.conv1" else 1)
                                ).astype(np.float32)
        if bn:
            n = shape[0]
            sd[f"{bn}.weight"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            sd[f"{bn}.bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
            sd[f"{bn}.running_mean"] = (0.2 * rng.standard_normal(n)).astype(np.float32)
            sd[f"{bn}.running_var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        else:
            sd[f"{conv}.bias"] = (0.1 * rng.standard_normal(shape[0])).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def retinaface_pair():
    """JAX's params (converted by JAX's converter) and the port's module
    holding them through retinaface_params_to_state_dict."""
    sd = _retinaface_public_state_dict()
    params = jrf.convert_retinaface_state_dict(sd)
    module = trf.RetinaFace()
    module.load_state_dict(trf.retinaface_params_to_state_dict(params), strict=True)
    return sd, jax.tree.map(jnp.asarray, params), module.eval()


def test_retinaface_matches_jax(retinaface_pair):
    sd, params, module = retinaface_pair
    x = np.random.default_rng(5).uniform(-128, 128, (2, 64, 96, 3)).astype(np.float32)
    want = [np.asarray(a) for a in jrf.retinaface_forward(params, jnp.asarray(x))]
    # the public checkpoint through the port's own converter folds to the same module
    other = trf.RetinaFace()
    other.load_state_dict(trf.convert_retinaface_state_dict({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}),
                          strict=True)
    for m in (module, other.eval()):
        with torch.no_grad():
            got = [a.numpy() for a in m(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))]
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    assert 0.02 < float((want[1][..., 1] > 0.5).mean()) < 0.98  # the scores are not saturated


def test_retinaface_box_math_matches_jax(retinaface_pair):
    """The host's box math, fed the same loc and scores, returns identical
    boxes; the detector's forward equals JAX's and its boxes too."""
    _, params, module = retinaface_pair
    np.testing.assert_array_equal(trf.prior_boxes(64, 96), jrf.prior_boxes(64, 96))
    rng = np.random.default_rng(6)
    priors = trf.prior_boxes(64, 96)
    loc = (0.5 * rng.standard_normal((priors.shape[0], 4))).astype(np.float32)
    scores = rng.random(priors.shape[0]).astype(np.float32)
    np.testing.assert_array_equal(trf.decode_boxes(loc, priors), jrf.decode_boxes(loc, priors))
    boxes = trf.decode_boxes(loc, priors) * np.asarray([96, 64, 96, 64], np.float32)
    for conf, nms in ((0.5, 0.4), (0.9, 0.3), (0.2, 0.6)):
        np.testing.assert_array_equal(trf.filter_boxes(boxes, scores, conf, nms), jrf.filter_boxes(boxes, scores, conf, nms))
    frame = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    tdet, jdet = trf.RetinaFaceDetector(module, confidence_threshold=0.5), jrf.RetinaFaceDetector(params, 0.5)
    tloc, tscore = tdet.forward(frame)
    jloc, jconf, _ = jdet._fwd(params, jnp.asarray(frame[..., ::-1].astype(np.float32) - np.asarray(jrf.BGR_MEAN,
                                                                                                   np.float32))[None])
    np.testing.assert_allclose(tloc, np.asarray(jloc[0]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tscore, np.asarray(jconf[0, :, 1]), atol=1e-4, rtol=0)
    got, want = tdet(frame), jdet(frame)
    assert got == want and len(got) > 0


# ------------------------------ runner, detectors ------------------------------


def _skin_frames(n=3, h=64, w=96, seed=7):
    """Frames with a skin-toned block (the heuristic's YCbCr range) on noise."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 60, (n, h, w, 3), dtype=np.uint8)
    frames[:, 8:40, 16:48] = (200, 140, 110)
    frames[n - 1, 30:60, 50:90] = (180, 120, 100)
    return frames


def test_heuristic_detector_matches_jax():
    frames = _skin_frames()
    mask = np.random.default_rng(8).random((12, 17)) > 0.5
    np.testing.assert_array_equal(tg._connected_components(mask), jg._connected_components(mask))
    for f in frames:
        boxes = tg.heuristic_face_detector(f)
        assert boxes == jg.heuristic_face_detector(f) and boxes
    assert tg.create_face_detector(None) is tg.heuristic_face_detector


@pytest.mark.parametrize("detector", ["heuristic", "retinaface"])
@pytest.mark.parametrize("pixels", ["uint8", "float"])
def test_runner_blurs_faces_as_jax(detector, pixels, retinaface_pair):
    """GuardrailRunner's video route: the same pixelated frames as JAX's,
    with the heuristic and with the model-backed detector."""
    _, params, module = retinaface_pair
    frames = _skin_frames()
    if pixels == "float":
        frames = frames.astype(np.float32) / 127.5 - 1.0
    if detector == "heuristic":
        tdet, jdet = tg.create_face_detector(None), jg.create_face_detector(None)
    else:
        tdet, jdet = tg.create_face_detector(module), jrf.RetinaFaceDetector(params)
        tdet.confidence_threshold = jdet.confidence_threshold = 0.5
    got = tg.create_video_guardrail_runner(tg.GuardrailConfig(face_detector=tdet, blur_faces=True))(frames)
    want = jg.create_video_guardrail_runner(jg.GuardrailConfig(face_detector=jdet, blur_faces=True))(frames)
    assert got.dtype == want.dtype == frames.dtype
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, frames)  # something was blurred
    blocked = tg.GuardrailConfig(video_classifier=lambda f: False, face_detector=tdet, blur_faces=True)
    assert tg.create_video_guardrail_runner(blocked)(frames) is None


def test_face_detector_sources(retinaface_pair, tmp_path):
    sd, _, module = retinaface_pair
    frame = _skin_frames(1)[0]
    want = trf.RetinaFaceDetector(module)(frame)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "Resnet50_Final.pth")
    for source in (module, str(tmp_path / "Resnet50_Final.pth"), sd, module.state_dict()):
        det = tg.create_face_detector(source, device="cpu")
        assert isinstance(det, trf.RetinaFaceDetector) and det(frame) == want
    seeded = trf.build_retinaface("cpu", seed=0)
    assert isinstance(tg.create_face_detector(seeded), trf.RetinaFaceDetector)
    if not torch.cuda.is_available():  # no quiet CPU route: asked for the card without one, it raises
        with pytest.raises((RuntimeError, AssertionError)):
            tg.create_face_detector(sd)
        with pytest.raises((RuntimeError, AssertionError)):
            tg.build_safety_classifier(_safety_state_dict())


# -------------------------------- text runner --------------------------------


@pytest.mark.parametrize("prompt", ["gore everywhere", "a calm lake", "nazi rally", "a gr@pe"])
@pytest.mark.parametrize("blocked_words", [None, ("grape",)])
def test_text_runner_matches_jax(prompt, blocked_words):
    for llm in (None, lambda p: "lake" not in p):
        got = tg.create_text_guardrail_runner(tg.GuardrailConfig(blocked_words=blocked_words, llm_classifier=llm))
        want = jg.create_text_guardrail_runner(jg.GuardrailConfig(blocked_words=blocked_words, llm_classifier=llm))
        assert got(prompt) == want(prompt)


# -------------------------------- Qwen guards --------------------------------


def _encode(text):
    """A byte-level tokenizer into the tiny vocab, as tests/test_guard_models.py's."""
    return [ord(c) % 256 for c in text][-64:]


def _decoder(seen):
    def decode(ids):
        seen.append(list(ids))
        return "".join(chr(i) for i in ids)

    return decode


@pytest.fixture(scope="module", params=["tiny", "tiny3", "llama"])
def guard_pair(request):
    """The JAX params and the port's QwenGuardLM holding them (fp32)."""
    jcfg, tcfg = jqwen.QwenConfig.tiny3() if request.param == "tiny3" else jqwen.QwenConfig.tiny(), (
        tqwen.QwenConfig.tiny3() if request.param == "tiny3" else tqwen.QwenConfig.tiny())
    if request.param == "llama":  # Llama Guard 3's deltas at the tiny width
        jcfg = dataclasses.replace(jcfg, attention_bias=False, qk_norm=False, tie_word_embeddings=False)
        tcfg = dataclasses.replace(tcfg, attention_bias=False, qk_norm=False, tie_word_embeddings=False)
    params = noisy_params(jit_init(jqwen.QwenGuardLM(jcfg).init, jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32)))
    lm = tqwen.QwenGuardLM(tcfg)
    lm.load_state_dict(jax_qwen_params_to_torch(params), strict=True)
    return request.param, jcfg, tcfg, jax.tree.map(jnp.asarray, params), lm.eval()


@pytest.mark.parametrize("prompt", ["a scenic mountain valley at dawn", "zzzz"])
def test_generative_guards_match_jax(guard_pair, prompt):
    """Qwen3Guard and LlamaGuard3 on the same tiny decoder: the same greedy
    ids (up to 128 over the 512-id buffer), decoded text and verdict."""
    name, jcfg, tcfg, params, lm = guard_pair
    make = (tg.create_llama_guard_3, jg.create_llama_guard_3) if name == "llama" else (tg.create_qwen3_guard,
                                                                                       jg.create_qwen3_guard)
    tseen, jseen = [], []
    tguard = make[0](lm, _encode, _decoder(tseen), config=tcfg, eos_ids=(0,), device="cpu")
    jguard = make[1](params, _encode, _decoder(jseen), config=jcfg, eos_ids=(0,))
    got, want = tguard.is_safe(prompt), jguard.is_safe(prompt)
    assert tseen == jseen and len(tseen[0]) == tguard.last_tokens > 0
    assert got == want


def test_generative_guard_from_a_state_dict(guard_pair):
    name, _, tcfg, _, lm = guard_pair
    seen, again = [], []
    tg.create_qwen3_guard(lm, _encode, _decoder(seen), config=tcfg, device="cpu").is_safe("hello")
    tg.create_qwen3_guard(lm.state_dict(), _encode, _decoder(again), config=tcfg, device="cpu").is_safe("hello")
    assert seen == again


@pytest.mark.parametrize("prompt", ["a scenic mountain valley at dawn", "aaaa", "zzzz"])
def test_guard_classifier_matches_jax(guard_pair, prompt):
    _, jcfg, tcfg, params, lm = guard_pair
    tc = tg.create_qwen_guard_classifier(lm, config=tcfg, tokenize=_encode, safe_token_id=7, unsafe_token_id=9,
                                         device="cpu")
    jc = jg.create_qwen_guard_classifier(params, config=jcfg, tokenize=_encode, safe_token_id=7, unsafe_token_id=9)
    ids = _encode(tc.template.format(prompt=prompt))
    with torch.no_grad():
        got = tc.apply_fn(torch.tensor([ids])).numpy()
    np.testing.assert_allclose(got, np.asarray(jc.apply_fn(jnp.asarray([ids], jnp.int32))), atol=1e-5, rtol=0)
    assert tc(prompt) == jc(prompt)
    runner = tg.GuardrailRunner(tg.GuardrailConfig(llm_classifier=tc))
    assert runner.run_text_guardrail("gore everywhere") is False and runner.run_text_guardrail(prompt) == tc(prompt)


QWEN3_OUTPUTS = ["Safety: Safe\nCategories: None", "Safety: Unsafe\nCategories: Violent, Jailbreak",
                 "Safety: Controversial\nCategories: Sexual Content or Sexual Acts", "no verdict at all",
                 "Safety: Unsafe\nCategories: Suicide & Self-Harm, Unethical Acts, Non-violent Illegal Acts"]
LLAMA_OUTPUTS = ["safe", "unsafe\nS1,S10", "unsafe\nS4, s14<|eot_id|>", "unsafe\nS99, S2", "unsafe", " \nsafe\n"]


def _scripted(text, array):
    """(apply_fn, encode, decode) whose greedy decoding emits ``text`` then
    an end id: the logits at each position pick the next character."""
    vocab = sorted(set(text)) + ["<eos>"]
    target = [vocab.index(c) for c in text] + [len(vocab) - 1]
    prompt = [0, 1, 2]

    def apply_fn(buf, pos):
        logits = np.zeros((1, len(vocab)), np.float32)
        logits[0, target[min(int(pos) - (len(prompt) - 1), len(target) - 1)]] = 1.0
        return array(logits)

    return apply_fn, (lambda s: prompt), (lambda ids: "".join(vocab[i] for i in ids if i < len(vocab) - 1))


@pytest.mark.parametrize("text", QWEN3_OUTPUTS + LLAMA_OUTPUTS)
def test_verdict_parsers_match_jax(text):
    """The verdict parsing on fixed model outputs: Qwen3Guard's label,
    categories and block message, Llama Guard 3's block message, and both
    guards' is_safe through greedy decoding scripted to emit the text."""
    tq, jq = tg.Qwen3Guard(None, None, None), jg.Qwen3Guard(None, None, None)
    assert tq.extract_label_and_categories(text) == jq.extract_label_and_categories(text)
    tl, jl = tg.LlamaGuard3(None, None, None), jg.LlamaGuard3(None, None, None)
    assert tl.get_block_message(text) == jl.get_block_message(text)
    assert tl.build_prompt("p") == jl.build_prompt("p")
    for tguard, jguard in ((tg.Qwen3Guard, jg.Qwen3Guard), (tg.LlamaGuard3, jg.LlamaGuard3)):
        eos = len(set(text))
        got = tguard(*_scripted(text, torch.from_numpy), eos_ids=(eos,), device="cpu").is_safe("p")
        assert got == jguard(*_scripted(text, jnp.asarray), eos_ids=(eos,)).is_safe("p")
