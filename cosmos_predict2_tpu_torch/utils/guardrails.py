"""Guardrails: prompt and video safety filtering.

Counterpart of cosmos_predict2_tpu/utils/guardrails.py (the reference's
imaginaire/auxiliary/guardrail/: GuardrailRunner, the blocklist and an LLM
prompt classifier, the video content classifier and RetinaFace face blur,
presets.py:28-62). A runner chains checks and postprocessors:

* text: the full blocklist (utils/blocklist.py: leet censor, lemma pass,
  exact and partial match), then an optional LLM classifier (any callable
  prompt -> safe bool): :class:`Qwen3Guard` or :class:`LlamaGuard3`
  (generative, the reference's) or :class:`QwenGuardClassifier` (one
  forward, the safe/unsafe token logits compared), all on the port's
  QwenGuardLM (text_encoders/qwen.py);
* video: an optional frame classifier (:class:`VideoContentSafetyFilter`:
  SigLIP so400m frame embeddings into the 7-class :class:`SafetyClassifier`
  head), then, with ``blur_faces``, a face detector's boxes pixelated:
  :class:`~cosmos_predict2_tpu_torch.utils.retinaface.RetinaFaceDetector`
  or, with no checkpoint, the JAX package's skin-tone heuristic.

The towers run as ``nn.Module`` calls under ``torch.no_grad()`` on their
device, where the JAX package wraps an apply in ``jax.jit``. Every
``create_*`` and ``build_*`` function takes ``device`` ("cuda" by default;
"cpu" only when asked for) for what it builds from weights; a built module
runs where it is.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from cosmos_predict2_tpu_torch.utils.blocklist import Blocklist, LeetCensor

from cosmos_predict2_tpu_torch.utils import log

StateDict = Mapping[str, Any]


@dataclasses.dataclass
class GuardrailConfig:
    # None -> the full default Blocklist (utils/blocklist.py); a tuple
    # overrides the censor word list; blocklist_dir loads the released
    # Cosmos-Guardrail1 lists (custom/ whitelist/ exact_match/ layout)
    blocked_words: Optional[tuple[str, ...]] = None
    blocklist_dir: Optional[str] = None
    llm_classifier: Optional[Callable[[str], bool]] = None  # returns is_safe
    video_classifier: Optional[Callable[[np.ndarray], bool]] = None
    face_detector: Optional[Callable[[np.ndarray], list[tuple[int, int, int, int]]]] = None
    blur_faces: bool = False


class BlocklistChecker:
    """bool-returning wrapper over the full Blocklist pipeline."""

    def __init__(self, blocked_words=None, blocklist_dir=None):
        self.blocklist = Blocklist(checkpoint_dir=blocklist_dir)
        if blocked_words is not None:
            self.blocklist.blocklist_words = list(blocked_words)
            self.blocklist._censor = LeetCensor(blocked_words, self.blocklist.whitelist_words)

    def is_safe(self, prompt: str) -> bool:
        safe, message = self.blocklist.is_safe(prompt)
        if not safe:
            log.warning(message)
        return safe


def pixelate_region(frame: np.ndarray, box: tuple[int, int, int, int], factor: int = 16) -> np.ndarray:
    """Blur a (x0, y0, x1, y1) region by down/up sampling (face-blur filter)."""
    x0, y0, x1, y1 = box
    region = frame[y0:y1, x0:x1]
    if region.size == 0:
        return frame
    h, w = region.shape[:2]
    small = region[::factor, ::factor]
    up = np.repeat(np.repeat(small, factor, axis=0), factor, axis=1)[:h, :w]
    out = frame.copy()
    out[y0:y1, x0:x1] = up
    return out


class GuardrailRunner:
    """Chains text checks and video checks/postprocessors
    (reference presets.py create_text/video_guardrail_runner)."""

    def __init__(self, config: GuardrailConfig = GuardrailConfig()):
        self.config = config
        self.blocklist = BlocklistChecker(config.blocked_words, config.blocklist_dir)

    def run_text_guardrail(self, prompt: str) -> bool:
        """True if the prompt is safe."""
        if not self.blocklist.is_safe(prompt):
            log.warning("prompt blocked by blocklist")
            return False
        if self.config.llm_classifier is not None and not self.config.llm_classifier(prompt):
            log.warning("prompt blocked by LLM classifier")
            return False
        return True

    def run_video_guardrail(self, frames: np.ndarray) -> Optional[np.ndarray]:
        """frames (T, H, W, 3) float/uint8 -> filtered frames or None if unsafe."""
        if self.config.video_classifier is not None and not self.config.video_classifier(frames):
            log.warning("video blocked by content classifier")
            return None
        if self.config.blur_faces and self.config.face_detector is not None:
            out = []
            for frame in frames:
                f8 = frame if frame.dtype == np.uint8 else ((np.clip(frame, -1, 1) + 1) * 127.5).astype(np.uint8)
                for box in self.config.face_detector(f8):
                    f8 = pixelate_region(f8, box)
                out.append(f8.astype(frames.dtype) / 127.5 - 1.0 if frames.dtype != np.uint8 else f8)
            frames = np.stack(out)
        return frames


def create_text_guardrail_runner(config: GuardrailConfig = GuardrailConfig()) -> Callable[[str], bool]:
    return GuardrailRunner(config).run_text_guardrail


def create_video_guardrail_runner(config: GuardrailConfig = GuardrailConfig()):
    return GuardrailRunner(config).run_video_guardrail


# ------------------- video content safety classifier -------------------
# The reference classifier head (guardrail/video_content_safety_filter/
# model.py:30-62): SigLIP frame embedding (1152-d) -> Linear/BN/ReLU x2 ->
# 7-class logits; a video is unsafe when more than
# CUTOFF_UNSAFE_FRAMES_PERCENT of the sampled frames classify non-Safe
# (video_content_safety_filter.py:115-146).

CUTOFF_UNSAFE_FRAMES_PERCENT = 10.0
SAFETY_CLASSES = 7  # class 0 is "Safe"


class SafetyClassifier(nn.Module):
    """The reference's VideoSafetyModel, its keys as the released
    ``safety_filter.pt`` has them (``network.layers.{0,1,3,4,6}``); eval
    mode (BatchNorm on its running statistics), fp32."""

    def __init__(self, input_size: int = 1152, num_classes: int = SAFETY_CLASSES):
        super().__init__()
        self.network = nn.Module()
        self.network.layers = nn.Sequential(
            nn.Linear(input_size, 512), nn.BatchNorm1d(512), nn.ReLU(),
            nn.Linear(512, 256), nn.BatchNorm1d(256), nn.ReLU(),
            nn.Linear(256, num_classes),
        )
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.network.layers(x)


def convert_safety_classifier_state_dict(sd: StateDict) -> dict[str, torch.Tensor]:
    """The released classifier's state dict (under "model" or flat; tensors
    or arrays) -> :class:`SafetyClassifier`'s, fp32; BatchNorm's
    ``num_batches_tracked`` is kept where the file has it, else 0."""
    sd = sd.get("model", sd)
    out = {}
    for i, kind in ((0, "fc"), (1, "bn"), (3, "fc"), (4, "bn"), (6, "fc")):
        names = ("weight", "bias") + (("running_mean", "running_var") if kind == "bn" else ())
        for n in names:
            v = sd[f"network.layers.{i}.{n}"]
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            out[f"network.layers.{i}.{n}"] = v.detach().float().clone()
        if kind == "bn":
            key = f"network.layers.{i}.num_batches_tracked"
            out[key] = torch.as_tensor(sd.get(key, 0), dtype=torch.long)
    return out


def build_safety_classifier(sd: Optional[StateDict] = None, device: torch.device | str = "cuda",
                            seed: Optional[int] = 0) -> SafetyClassifier:
    """The head on ``device``: from a state dict (converted by
    :func:`convert_safety_classifier_state_dict`, its widths the file's), or
    with seeded weights (Linear weights 1/sqrt(fan_in), BatchNorm on unit
    statistics)."""
    if sd is not None:
        sd = convert_safety_classifier_state_dict(sd)
        head = SafetyClassifier(sd["network.layers.0.weight"].shape[1], sd["network.layers.6.weight"].shape[0])
        head.load_state_dict(sd, strict=True)
        return head.to(device).eval()
    from cosmos_predict2_tpu_torch.text_encoders.common import build_tower

    head = build_tower(SafetyClassifier, device, torch.float32, seed)
    for m in head.modules():
        if isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()  # weight 1, bias 0, running mean 0 and variance 1
    return head


class VideoContentSafetyFilter:
    """Frame-sampled video safety check. ``embed_frames`` maps uint8 frames
    (N, H, W, 3) to embeddings (N, D) on the host (the SigLIP tower's
    text_encoders/siglip_vision.py::make_frame_embedder); ``classifier``
    is the head, run on its device.

    ``normalize``: L2-normalize embeddings before the classifier, as the
    reference's SigLIPEncoder does (vision_encoder.py:42); the released head
    was trained on normalized features."""

    def __init__(self, embed_frames: Callable[[np.ndarray], np.ndarray], classifier: nn.Module,
                 sample_every: int = 8, normalize: bool = True):
        self.embed_frames = embed_frames
        self.classifier = classifier.eval()
        self.sample_every = sample_every
        self.normalize = normalize
        self.last_classes: Optional[np.ndarray] = None

    @torch.no_grad()
    def classify(self, frames_u8: np.ndarray) -> np.ndarray:
        """The class of every ``sample_every``-th frame."""
        device = next(self.classifier.parameters()).device
        emb = torch.from_numpy(np.asarray(self.embed_frames(frames_u8[:: self.sample_every]), np.float32)).to(device)
        if self.normalize:
            emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True)
        return self.classifier(emb).argmax(dim=-1).cpu().numpy()

    def is_safe_frames(self, frames_u8: np.ndarray) -> bool:
        classes = self.last_classes = self.classify(frames_u8)
        unsafe = int((classes != 0).sum())  # class 0 == "Safe"
        if unsafe / max(1, len(classes)) > CUTOFF_UNSAFE_FRAMES_PERCENT / 100.0:
            log.warning(f"video unsafe: {unsafe}/{len(classes)} sampled frames flagged")
            return False
        return True

    __call__ = is_safe_frames


def _state_dict(source: Union[str, StateDict]) -> StateDict:
    from cosmos_predict2_tpu_torch.utils.checkpoint_convert import read_state_dict

    return read_state_dict(source) if isinstance(source, str) else source


def create_video_content_safety_filter(classifier: Union[str, StateDict, nn.Module], siglip=None,
                                       siglip_ckpt: Optional[str] = None, sample_every: int = 8,
                                       device: torch.device | str = "cuda") -> VideoContentSafetyFilter:
    """The released-weights video safety filter: SigLIP so400m/14-384 frame
    embedder + 7-class head (reference video_content_safety_filter.py:52-101).

    ``classifier``: the released ``safety_filter.pt`` (a path; its state
    dict under "model" or flat), such a state dict, or a built head.
    ``siglip``: a built SigLIPVisionTower or an HF SiglipVisionModel state
    dict; or ``siglip_ckpt``, a path to one. What is built from weights is
    built on ``device``."""
    from cosmos_predict2_tpu_torch.text_encoders.siglip_vision import (
        SigLIPVisionConfig,
        SigLIPVisionTower,
        build_siglip_vision,
        make_frame_embedder,
    )
    from cosmos_predict2_tpu_torch.utils.checkpoint_convert import (
        TOWER_PREFIXES,
        load_reference_state_dict,
        pick_prefix,
    )

    head = classifier if isinstance(classifier, nn.Module) else build_safety_classifier(_state_dict(classifier), device)
    if siglip is None:
        if siglip_ckpt is None:
            raise ValueError("need siglip (a tower or a state dict) or siglip_ckpt for the frame embedder")
        siglip = siglip_ckpt
    if not isinstance(siglip, SigLIPVisionTower):
        sd = pick_prefix(_state_dict(siglip), TOWER_PREFIXES["siglip_vision"])
        tower = build_siglip_vision(SigLIPVisionConfig(), device, seed=None)
        load_reference_state_dict(tower, sd, "SigLIP")
        siglip = tower
    return VideoContentSafetyFilter(make_frame_embedder(siglip), head, sample_every=sample_every)


# ----------------------- LLM prompt guards (Qwen) -----------------------
# Model-backed prompt classifiers on the port's Qwen decoder
# (text_encoders/qwen.py QwenGuardLM). The reference wires Qwen3Guard /
# LlamaGuard3 the same way: a guard chat template around the user prompt,
# then the safety verdict read off what the model generates
# (imaginaire/auxiliary/guardrail/qwen3guard/, llamaGuard3/).

GUARD_TEMPLATE = (
    "<|im_start|>system\n"
    "You are a safety classifier. Classify the user prompt as safe or "
    "unsafe for a video generation model. Answer with one word: safe or "
    "unsafe.<|im_end|>\n"
    "<|im_start|>user\n{prompt}<|im_end|>\n"
    "<|im_start|>assistant\n"
)


def _guard_lm(model, config, device):
    """A QwenGuardLM as it is, or one built on ``device`` with ``config``'s
    widths from a state dict with the port's keys
    (utils/checkpoint_convert.py::convert_qwen_guard_hf_state_dict makes
    them from an HF checkpoint)."""
    from cosmos_predict2_tpu_torch.text_encoders.qwen import QwenGuardLM, build_qwen_lm
    from cosmos_predict2_tpu_torch.utils.checkpoint_convert import load_reference_state_dict

    if isinstance(model, QwenGuardLM):
        return model.eval()
    lm = build_qwen_lm(config, device, seed=None, guard=True)
    load_reference_state_dict(lm, model, "guard LM")
    return lm


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


class QwenGuardClassifier:
    """Prompt safety by next-token logit comparison on a guard LM.

    ``apply_fn(input_ids (1, S) on ``device``) -> (1, vocab)`` logits;
    ``tokenize(text) -> list[int]``; safe/unsafe are the token ids of the
    verdict words under that tokenizer. The call compares their logits at
    the first generated position: the one-step form of generating the
    verdict.
    """

    def __init__(self, apply_fn: Callable, tokenize: Callable[[str], list], safe_token_id: int,
                 unsafe_token_id: int, template: str = GUARD_TEMPLATE, max_len: int = 512,
                 device: torch.device | str = "cuda"):
        self.apply_fn = apply_fn
        self.tokenize = tokenize
        self.safe_token_id = safe_token_id
        self.unsafe_token_id = unsafe_token_id
        self.template = template
        self.max_len = max_len
        self.device = device

    @torch.no_grad()
    def __call__(self, prompt: str) -> bool:
        ids = self.tokenize(self.template.format(prompt=prompt))[-self.max_len:]
        logits = self.apply_fn(torch.tensor([ids], dtype=torch.long, device=self.device))[0].float().cpu()
        return bool(logits[self.safe_token_id] >= logits[self.unsafe_token_id])


def create_qwen_guard_classifier(model, config=None, tokenize=None, safe_token_id=None, unsafe_token_id=None,
                                 device: torch.device | str = "cuda") -> QwenGuardClassifier:
    """Bind a QwenGuardLM (or a state dict of one) into a prompt classifier."""
    from cosmos_predict2_tpu_torch.text_encoders.qwen import QwenConfig

    lm = _guard_lm(model, config or QwenConfig.qwen2_5_vl_7b(), device)
    return QwenGuardClassifier(lm, tokenize, safe_token_id, unsafe_token_id, device=_device_of(lm))


# --------------------------- Qwen3Guard (generative) ---------------------------
# The reference's production prompt guard (qwen3guard/qwen3guard.py:31-88):
# Qwen/Qwen3Guard-Gen-0.6B generates a verdict block, parsed with
# "Safety: (Safe|Unsafe|Controversial)" + category regexes; here the
# QwenGuardLM with the Qwen3 deltas (QwenConfig.qwen3guard_0_6b) decodes
# greedily (text_encoders/qwen.py greedy_generate).

# qwen3guard/categories.py
QWEN3GUARD_UNSAFE_CATEGORIES = {
    "S1": "Violent",
    "S2": "Non-violent Illegal Acts",
    "S3": "Sexual Content or Sexual Acts",
    "S4": "Suicide & Self-Harm",
    "S5": "Unethical Acts",
    "S6": "Jailbreak",
}

# Guard prompt in Qwen chat format. The released checkpoint bakes its
# classification instructions into its chat template; this reproduces that
# contract (instruction -> "Safety: <label>" [+ "Categories: ..."]) so the
# same parsing applies.
QWEN3GUARD_TEMPLATE = (
    "<|im_start|>user\n"
    "You are a safety moderator. Examine the user prompt below and "
    "classify it. Respond in exactly this format:\n"
    "Safety: Safe, Unsafe or Controversial\n"
    "Categories: comma-separated subset of [Violent, Non-violent Illegal "
    "Acts, Sexual Content or Sexual Acts, Suicide & Self-Harm, Unethical "
    "Acts, Jailbreak], or None\n"
    "<BEGIN PROMPT>\n{prompt}\n<END PROMPT><|im_end|>\n"
    "<|im_start|>assistant\n"
)


class _GenerativeGuard:
    """Greedy decoding of a verdict: ``apply_fn(ids (1, S) on ``device``,
    position) -> (1, vocab)``, ``encode``/``decode`` the tokenizer's
    callables, ``eos_ids`` the stop set. ``last_tokens`` is the number of
    tokens the latest verdict generated."""

    def __init__(self, apply_fn, encode, decode, eos_ids=(), max_new_tokens=128,
                 device: torch.device | str = "cuda"):
        self.apply_fn = apply_fn
        self.encode = encode
        self.decode = decode
        self.eos_ids = tuple(eos_ids)
        self.max_new_tokens = max_new_tokens
        self.device = device
        self.last_tokens = 0

    @torch.no_grad()
    def generate(self, text: str) -> str:
        from cosmos_predict2_tpu_torch.text_encoders.qwen import greedy_generate

        out_ids = greedy_generate(self.apply_fn, self.encode(text), max_new_tokens=self.max_new_tokens,
                                  eos_ids=self.eos_ids, device=self.device)
        self.last_tokens = len(out_ids)
        return self.decode(out_ids)

    def is_safe(self, prompt: str) -> tuple[bool, str]:
        raise NotImplementedError

    def __call__(self, prompt: str) -> bool:
        safe, message = self.is_safe(prompt)
        if not safe:
            log.warning(message)
        return safe


class Qwen3Guard(_GenerativeGuard):
    """Generative prompt guard with the reference's verdict parsing
    (qwen3guard.py extract_label_and_categories)."""

    def extract_label_and_categories(self, content: str):
        safe_pattern = r"Safety: (Safe|Unsafe|Controversial)"
        category_pattern = r"(" + "|".join(QWEN3GUARD_UNSAFE_CATEGORIES.values()) + r")"
        label_match = re.search(safe_pattern, content)
        label = label_match.group(1) if label_match else None
        categories = re.findall(category_pattern, content)
        return label, categories

    def is_safe(self, prompt: str) -> tuple[bool, str]:
        label, categories = self.extract_label_and_categories(self.generate(QWEN3GUARD_TEMPLATE.format(prompt=prompt)))
        if label is not None and label.lower() == "unsafe":
            return False, f"Prompt blocked by Qwen3Guard. Safety: {label}, Categories: {categories}"
        return True, ""


def create_qwen3_guard(model, encode, decode, config=None, eos_ids=(),
                       device: torch.device | str = "cuda") -> Qwen3Guard:
    """Bind Qwen3Guard-Gen weights (a QwenGuardLM, or a state dict of one,
    e.g. from utils/checkpoint_convert.py::convert_qwen_guard_hf_state_dict)
    into a prompt guard."""
    from cosmos_predict2_tpu_torch.text_encoders.qwen import QwenConfig

    lm = _guard_lm(model, config or QwenConfig.qwen3guard_0_6b(), device)
    return Qwen3Guard(lm, encode, decode, eos_ids=eos_ids, device=_device_of(lm))


# --------------------------- LlamaGuard3 (generative) ---------------------------
# The reference's other prompt-guard family (guardrail/llamaGuard3/
# llamaGuard3.py:29-111): meta-llama/Llama-Guard-3-8B generates a verdict
# ("safe" | "unsafe\n<categories>"), parsed against the S1..S14 table
# (llamaGuard3/categories.py); the decoder is QwenGuardLM with the
# Llama-3.1 deltas (QwenConfig.llama_guard_3_8b).

# llamaGuard3/categories.py (MLCommons hazard taxonomy; "s14" lowercase
# matches the reference table verbatim: its parser compares raw strings)
LLAMA_GUARD_3_UNSAFE_CATEGORIES = {
    "S1": "Violent Crimes.",
    "S2": "Non-Violent Crimes.",
    "S3": "Sex Crimes.",
    "S4": "Child Exploitation.",
    "S5": "Defamation.",
    "S6": "Specialized Advice.",
    "S7": "Privacy.",
    "S8": "Intellectual Property.",
    "S9": "Indiscriminate Weapons.",
    "S10": "Hate.",
    "S11": "Self-Harm.",
    "S12": "Sexual Content.",
    "S13": "Elections.",
    "s14": "Code Interpreter Abuse.",
}

# The released checkpoint's chat template (Llama Guard 3 model card): a
# moderation task header, the category table, the conversation, and the
# two-line answer contract.
LLAMA_GUARD_3_TEMPLATE = (
    "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\n"
    "Task: Check if there is unsafe content in 'User' messages in "
    "conversations according our safety policy with the below categories.\n\n"
    "<BEGIN UNSAFE CONTENT CATEGORIES>\n{categories}<END UNSAFE CONTENT CATEGORIES>\n\n"
    "<BEGIN CONVERSATION>\n\nUser: {prompt}\n\n<END CONVERSATION>\n\n"
    "Provide your safety assessment for ONLY THE LAST User message in the "
    "above conversation:\n"
    " - First line must read 'safe' or 'unsafe'.\n"
    " - If unsafe, a second line must include a comma-separated list of "
    "violated categories.<|eot_id|>"
    "<|start_header_id|>assistant<|end_header_id|>\n\n"
)


class LlamaGuard3(_GenerativeGuard):
    """Generative prompt guard with the reference's output filtering
    (llamaGuard3.py filter_llamaGuard3_output / get_llamaGuard3_block_message)."""

    def __init__(self, apply_fn, encode, decode, eos_ids=(), max_new_tokens=100,
                 device: torch.device | str = "cuda"):
        super().__init__(apply_fn, encode, decode, eos_ids, max_new_tokens, device)

    def build_prompt(self, prompt: str) -> str:
        cats = "".join(f"{k}: {v}\n" for k, v in LLAMA_GUARD_3_UNSAFE_CATEGORIES.items())
        return LLAMA_GUARD_3_TEMPLATE.format(categories=cats, prompt=prompt)

    def get_block_message(self, moderation_output: str) -> str:
        """Extract violated categories (llamaGuard3.py:56-75): every line
        after the first is split on ',' and matched against the table;
        unknown tokens are warned about, recognized ones named in the block
        message (trailing '.' stripped, as there)."""
        block_msg = "Prompt blocked by Llama Guard 3."
        try:
            detected = []
            for line in moderation_output.splitlines()[1:]:
                for cat in line.split("<|eot_id|>")[0].strip().split(","):
                    cat = cat.strip()
                    if not cat:
                        continue
                    if cat not in LLAMA_GUARD_3_UNSAFE_CATEGORIES:
                        log.warning(f"Unrecognized category from moderation output: {cat}")
                    else:
                        detected.append(cat)
            if detected:
                names = ", ".join(LLAMA_GUARD_3_UNSAFE_CATEGORIES[c][:-1] for c in detected)
                block_msg = f"{block_msg} Violations: {names}."
        except Exception as e:  # noqa: BLE001
            log.warning(f"Unable to extract blocked category from Llama Guard 3 output: {e}")
        return block_msg

    def is_safe(self, prompt: str) -> tuple[bool, str]:
        moderation_output = self.generate(self.build_prompt(prompt)).strip()
        if "unsafe" in moderation_output.lower():
            return False, self.get_block_message(moderation_output)
        return True, ""


def create_llama_guard_3(model, encode, decode, config=None, eos_ids=(),
                         device: torch.device | str = "cuda") -> LlamaGuard3:
    """Bind Llama-Guard-3-8B weights (a QwenGuardLM, or a state dict of one:
    Llama-3.1 has HF's Qwen module names) into a prompt guard."""
    from cosmos_predict2_tpu_torch.text_encoders.qwen import QwenConfig

    lm = _guard_lm(model, config or QwenConfig.llama_guard_3_8b(), device)
    return LlamaGuard3(lm, encode, decode, eos_ids=eos_ids, device=_device_of(lm))


# ----------------------------- face detectors -----------------------------
# The model-backed detector is RetinaFace (utils/retinaface.py), as the
# reference's face_blur_filter; without a checkpoint, the JAX package's
# host-side heuristic: YCbCr skin segmentation + connected components + box
# shape filtering, with no weights.


def _connected_components(mask: np.ndarray) -> np.ndarray:
    """Two-pass union-find labeling of a boolean mask (4-connectivity)."""
    h, w = mask.shape
    labels = np.zeros((h, w), dtype=np.int32)
    parent = [0]

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    nxt = 1
    for y in range(h):
        for x in range(w):
            if not mask[y, x]:
                continue
            up = labels[y - 1, x] if y else 0
            left = labels[y, x - 1] if x else 0
            if not up and not left:
                parent.append(nxt)
                labels[y, x] = nxt
                nxt += 1
            elif up and left and up != left:
                ra, rb = find(up), find(left)
                parent[max(ra, rb)] = min(ra, rb)
                labels[y, x] = min(ra, rb)
            else:
                labels[y, x] = up or left
    for y in range(h):
        for x in range(w):
            if labels[y, x]:
                labels[y, x] = find(labels[y, x])
    return labels


def create_face_detector(checkpoint: Union[None, str, StateDict, nn.Module] = None,
                         device: torch.device | str = "cuda"):
    """The face detector for the blur guardrail.

    ``checkpoint``: the public RetinaFace ``Resnet50_Final.pth`` (a path, or
    its state dict), a state dict with the port's keys, or a built
    :class:`~cosmos_predict2_tpu_torch.utils.retinaface.RetinaFace` (seeded
    weights reach the model-backed detector so); what is built from weights
    is built on ``device``. ``None``: the skin-tone heuristic below, the JAX
    package's contract for "no checkpoint". Logs which it built."""
    if checkpoint is None:
        log.info("face detector: the skin-tone heuristic (no RetinaFace checkpoint)")
        return heuristic_face_detector
    from cosmos_predict2_tpu_torch.utils.retinaface import (
        RetinaFace,
        RetinaFaceDetector,
        build_retinaface,
        convert_retinaface_state_dict,
    )

    module = checkpoint
    if not isinstance(module, RetinaFace):
        sd = _state_dict(checkpoint)
        if any(k.removeprefix("module.") == "body.bn1.weight" for k in sd):  # the public layout
            sd = convert_retinaface_state_dict(sd)
        module = build_retinaface(device, seed=None)
        module.load_state_dict(sd, strict=True)
    log.info(f"face detector: RetinaFace-ResNet50 on {_device_of(module)}")
    return RetinaFaceDetector(module)


def heuristic_face_detector(frame_u8: np.ndarray, downsample: int = 8,
                            min_area_frac: float = 0.002) -> list:
    """(H, W, 3) uint8 -> [(x0, y0, x1, y1)] candidate face boxes."""
    f = frame_u8[::downsample, ::downsample].astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    cb = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
    skin = (cb > 77) & (cb < 127) & (cr > 133) & (cr < 173)
    labels = _connected_components(skin)
    boxes = []
    hs, ws = frame_u8.shape[:2]
    for lab in np.unique(labels):
        if lab == 0:
            continue
        ys, xs = np.nonzero(labels == lab)
        if len(ys) < min_area_frac * skin.size:
            continue
        x0, x1 = xs.min() * downsample, (xs.max() + 1) * downsample
        y0, y1 = ys.min() * downsample, (ys.max() + 1) * downsample
        bw, bh = x1 - x0, y1 - y0
        if 0.4 <= bw / max(bh, 1) <= 2.5:  # face-ish aspect
            boxes.append((int(x0), int(y0), int(min(x1, ws)), int(min(y1, hs))))
    return boxes
