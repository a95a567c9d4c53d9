"""Public Inference API, counterpart of cosmos_predict2_tpu/inference/api.py.

Typed per-sample arguments, batch loading from json/jsonl and media
export, over the port's Video2World pipeline, with the UniPC sampler or the
distilled DMD2 sampler (``sampler="dmd2"``: served one request at a time,
as the batched pass is the UniPC CFG program). ``mode="image"`` runs
Text2Image and writes ``<name>.png``; ``enable_autoregressive`` generates
``num_output_frames`` in chunks of ``chunk_size`` frames overlapping by
``chunk_overlap`` latent frames. Both are served one request at a time.

Guardrail hooks, where the JAX package has them: ``text_guardrail``
(prompt -> safe bool) runs before any device work of a sample;
``video_guardrail`` (uint8 frames -> frames, or None when unsafe) runs on
the generated frames before they are written, on the sequential, batched
and autoregressive routes (utils/guardrails.py builds both). A blocked
sample raises JAX's ValueError / RuntimeError; under ``keep_going`` it is
logged and skipped.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import traceback
from typing import Optional

import numpy as np
import torch

from cosmos_predict2_tpu_torch.inference.pipeline import (
    _IMAGE_EXTS,
    _VIDEO_EXTS,
    Text2ImageInference,
    Video2WorldInference,
    read_and_process_image,
    read_and_process_video,
)
from cosmos_predict2_tpu_torch.utils.flags import SMOKE
from cosmos_predict2_tpu_torch.utils.io import save_img_or_video

log = logging.getLogger("cosmos_predict2_tpu_torch")


@dataclasses.dataclass
class InferenceArguments:
    """Per-sample arguments (reference cosmos_predict2/config.py:406-470)."""

    name: str = "sample"
    prompt: str = ""
    input_path: Optional[str] = None  # image or video; None => Text2World
    negative_prompt: str = ""
    num_steps: int = 35 if not SMOKE else 1
    guidance: float = 7.0
    seed: int = 1
    num_conditional_frames: int = 1
    # autoregressive long video: pixel frames out, per chunk, and the
    # latent frames consecutive chunks share (the JAX package's defaults:
    # a 77-frame chunk is 20 latent frames, under the 2B's state_t of 24)
    enable_autoregressive: bool = False
    num_output_frames: int = 77
    chunk_size: int = 77
    chunk_overlap: int = 1
    # precomputed text embedding path (.npy) when no online encoder
    text_embedding_path: Optional[str] = None
    # "video" or "image" (Text2Image, one frame, written as a png)
    mode: str = "video"
    sampler: str = "unipc"

    @staticmethod
    def from_file(path: str) -> list["InferenceArguments"]:
        """Load a batch of samples from json (list or single) / jsonl."""
        with open(path) as f:
            if path.endswith(".jsonl"):
                items = [json.loads(line) for line in f if line.strip()]
            else:
                data = json.load(f)
                items = data if isinstance(data, list) else [data]
        known = {f.name for f in dataclasses.fields(InferenceArguments)}
        return [InferenceArguments(**{k: v for k, v in item.items() if k in known}) for item in items]


MODES = ("video", "image")


def _check_mode(args: InferenceArguments) -> None:
    if args.mode not in MODES:
        raise ValueError(f"sample {args.name}: unknown mode {args.mode!r}; the modes are {MODES}")


class Inference:
    """Top-level generate() loop. With ``keep_going`` (the default) a failed
    sample is logged and skipped; without it the exception propagates."""

    def __init__(self, pipe: Video2WorldInference, output_dir: str = "outputs", text_guardrail=None,
                 video_guardrail=None, keep_going: bool = True):
        self.pipe = pipe
        self.output_dir = output_dir
        self.text_guardrail = text_guardrail
        self.video_guardrail = video_guardrail
        self.keep_going = keep_going
        self._t2i: Optional[Text2ImageInference] = None
        os.makedirs(output_dir, exist_ok=True)

    def _text_embedding(self, args: InferenceArguments, prompt: str) -> torch.Tensor:
        if args.text_embedding_path and prompt == args.prompt:
            emb = np.load(args.text_embedding_path)
            return torch.from_numpy(emb if emb.ndim == 3 else emb[None])
        return self.pipe.encode_text([prompt])

    def generate(self, samples: list[InferenceArguments]) -> list[str]:
        outputs = []
        for args in samples:
            try:
                outputs.append(self._generate_sample(args))
            except Exception as e:
                if not self.keep_going:
                    raise
                log.error(f"sample {args.name} failed; continuing (keep_going): {e}\n{traceback.format_exc()}")
        return outputs

    def _prepare_video(self, args: InferenceArguments) -> tuple[np.ndarray, int]:
        """(1, 3, T, H, W) uint8 input buffer + number of conditional frames."""
        h, w = self.pipe.video_size()
        nvf = self.pipe.num_video_frames
        if args.input_path is None:
            return np.zeros((1, 3, nvf, h, w), dtype=np.uint8), 0
        if args.input_path.lower().endswith(_IMAGE_EXTS):
            return read_and_process_image(args.input_path, h, w, nvf), 1
        if args.input_path.lower().endswith(_VIDEO_EXTS):
            return read_and_process_video(args.input_path, h, w, nvf, args.num_conditional_frames), args.num_conditional_frames
        raise ValueError(f"unsupported input: {args.input_path}")

    @staticmethod
    def batch_key(args: InferenceArguments):
        """Requests with equal keys can share one batched sampling pass."""
        k = 0 if args.input_path is None else (
            1 if args.input_path.lower().endswith(_IMAGE_EXTS) else args.num_conditional_frames
        )
        return (args.mode, args.enable_autoregressive, args.guidance, args.num_steps, k,
                bool(args.negative_prompt), args.sampler)

    def _check_prompt(self, args: InferenceArguments) -> None:
        if self.text_guardrail is not None and not self.text_guardrail(args.prompt):
            raise ValueError(f"prompt for {args.name} blocked by text guardrail")

    def _guard_video(self, args: InferenceArguments, frames: np.ndarray) -> np.ndarray:
        """The video guardrail's frames; fails closed with a clear reason."""
        if self.video_guardrail is None:
            return frames
        frames = self.video_guardrail(frames)
        if frames is None:
            raise RuntimeError(f"sample {args.name}: video blocked by guardrail")
        return frames

    def _finish(self, args: InferenceArguments, frames: np.ndarray) -> str:
        path = save_img_or_video(frames, os.path.join(self.output_dir, args.name), fps=16)
        log.info(f"saved {path}")
        return path

    def generate_batch(self, samples: list[InferenceArguments]) -> dict[str, str]:
        """Serve N same-geometry video requests in one sampling pass; falls
        back to the sequential loop when the batch is not batchable (mixed
        keys, image mode, autoregressive, or the dmd2 sampler: the batched
        pass is the UniPC CFG program)."""
        first = samples[0] if samples else None
        if (len(samples) <= 1 or len({self.batch_key(a) for a in samples}) != 1 or first.sampler != "unipc"
                or first.mode != "video" or first.enable_autoregressive):
            outputs: dict[str, str] = {}
            for a in samples:
                try:
                    outputs[a.name] = self._generate_sample(a)
                except Exception as e:
                    if not self.keep_going:
                        raise
                    log.error(f"sample {a.name} failed; continuing (keep_going): {e}")
            return outputs
        ok, videos = [], []
        for args in samples:
            try:
                _check_mode(args)
                self._check_prompt(args)
                videos.append(self._prepare_video(args)[0])
                ok.append(args)
            except Exception:
                if not self.keep_going:
                    raise
                log.error(f"sample {args.name} failed in prep; continuing (keep_going)")
        if not ok:
            return {}
        emb = torch.cat([self._text_embedding(a, a.prompt) for a in ok], dim=0)
        neg = torch.cat([self._text_embedding(a, a.negative_prompt) for a in ok], dim=0) if ok[0].negative_prompt else None
        frames_b = self.pipe.generate_vid2world_batch(
            np.concatenate(videos, axis=0), emb, neg_text_emb=neg, guidance=ok[0].guidance,
            num_steps=ok[0].num_steps, num_conditional_frames=self.batch_key(ok[0])[4],
            seeds=[a.seed for a in ok], pixel_format="uint8",
        )
        outputs: dict[str, str] = {}
        for args, frames in zip(ok, frames_b):
            try:
                outputs[args.name] = self._finish(args, self._guard_video(args, frames))
            except Exception:
                if not self.keep_going:
                    raise
                log.error(f"sample {args.name} failed post-processing; continuing (keep_going)")
        return outputs

    def _text2image(self) -> Text2ImageInference:
        """The Text2Image pipeline over this pipeline's weights, built on first use."""
        if self._t2i is None:
            self._t2i = Text2ImageInference(self.pipe.setup, self.pipe.net, self.pipe.vae,
                                            text_encoder=self.pipe.text_encoder)
        return self._t2i

    def _generate_sample(self, args: InferenceArguments) -> str:
        _check_mode(args)
        self._check_prompt(args)
        emb = self._text_embedding(args, args.prompt)
        neg = self._text_embedding(args, args.negative_prompt) if args.negative_prompt else None
        if args.mode == "image":
            t2i = self._text2image()
            img = t2i.generate_image(emb, neg_text_emb=neg, guidance=args.guidance, num_steps=args.num_steps,
                                     seed=args.seed)
            path = t2i.save_image(img, os.path.join(self.output_dir, args.name + ".png"))
            log.info(f"saved {path}")
            return path
        video, k = self._prepare_video(args)
        if args.enable_autoregressive:
            frames = self.pipe.generate_autoregressive(
                video, emb, num_output_frames=args.num_output_frames, chunk_size=args.chunk_size,
                chunk_overlap=args.chunk_overlap, num_conditional_frames=k, guidance=args.guidance,
                num_steps=args.num_steps, seed=args.seed, neg_text_emb=neg, pixel_format="uint8",
            )
        else:
            frames = self.pipe.generate_vid2world(
                video, emb, neg_text_emb=neg, guidance=args.guidance, num_steps=args.num_steps,
                num_conditional_frames=k, seed=args.seed, pixel_format="uint8", sampler=args.sampler,
            )
        return self._finish(args, self._guard_video(args, frames))
