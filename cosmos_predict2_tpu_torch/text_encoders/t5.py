"""T5 / umT5 offline text embeddings: the ``t5_xxl/`` folders of post-training
(data/local_dataset.py) and the Wan text embeddings.

Counterpart of cosmos_predict2_tpu/text_encoders/t5.py. Two backends:

* ``backend="tower"`` (default): the port's own encoder
  (text_encoders/t5_encoder.py) on ``device``, in bf16 as the JAX package's
  default backend runs its tower. The checkpoint directory's
  ``config.json`` and weights are read without ``transformers``
  (utils/checkpoint_convert.py::read_state_dict); a caller may also hand in
  a built :class:`~cosmos_predict2_tpu_torch.text_encoders.t5_encoder.T5Encoder`.
* ``backend="torch"``: HF's ``T5EncoderModel`` on the host, fp32, as the
  JAX package's ``backend="torch"``.

Prompts are tokenized by ``transformers.AutoTokenizer`` (imported only
then), padded to ``max_length``; the embeddings past each prompt's length
are zero, like the reference's masked fill.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from cosmos_predict2_tpu_torch.utils import log


def load_t5_tower(model_path: str, device: torch.device | str = "cuda", dtype: torch.dtype = torch.bfloat16):
    """An HF T5 / umT5 checkpoint directory (``config.json`` and a state
    dict, one file or shards) -> the port's T5Encoder on ``device``, built
    on the meta device and filled from the file."""
    from cosmos_predict2_tpu_torch.text_encoders.t5_encoder import T5Config, build_t5_encoder
    from cosmos_predict2_tpu_torch.utils.checkpoint_convert import (
        convert_t5_hf_state_dict,
        load_reference_state_dict,
        read_state_dict,
    )

    with open(os.path.join(model_path, "config.json")) as f:
        cfg = T5Config.from_hf(json.load(f), dtype=dtype)
    encoder = build_t5_encoder(cfg, device, seed=None)
    load_reference_state_dict(encoder, convert_t5_hf_state_dict(read_state_dict(model_path)),
                              f"T5 checkpoint {model_path}")
    return encoder


class OfflineT5Encoder:
    """A local T5 / umT5 encoder for offline embeddings: (B, max_length,
    d_model) float32 NumPy, zero past each sequence's length."""

    def __init__(self, model_path: Optional[str] = None, max_length: int = 512, backend: str = "tower",
                 device: torch.device | str = "cuda", encoder: Any = None):
        if backend not in ("tower", "torch"):
            raise ValueError(f"backend must be 'tower' or 'torch', not {backend!r}")
        self.model_path = model_path
        self.max_length = max_length
        self.backend = backend
        self.device = torch.device(device) if backend == "tower" else torch.device("cpu")
        self._encoder = encoder
        self._tokenizer = None

    def _load(self):
        if self._encoder is not None:
            return
        if self.backend == "tower":
            self._encoder = load_t5_tower(self.model_path, self.device)
            log.info(f"loaded T5 encoder from {self.model_path} (the port's tower on {self.device})")
        else:
            from transformers import T5EncoderModel

            self._encoder = T5EncoderModel.from_pretrained(self.model_path, torch_dtype=torch.float32).eval()
            log.info(f"loaded T5 encoder from {self.model_path} (HF module on the host)")

    def tokenize(self, prompts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """-> (input_ids, attention_mask), each (B, max_length)."""
        if self._tokenizer is None:
            from transformers import AutoTokenizer

            self._tokenizer = AutoTokenizer.from_pretrained(self.model_path)
        batch = self._tokenizer(prompts, return_tensors="np", padding="max_length", truncation=True,
                                max_length=self.max_length)
        return np.asarray(batch["input_ids"]), np.asarray(batch["attention_mask"])

    @torch.no_grad()
    def encode_ids(self, input_ids, attention_mask) -> np.ndarray:
        self._load()
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long).to(self.device)
        mask = torch.as_tensor(np.asarray(attention_mask), dtype=torch.long).to(self.device)
        if self.backend == "tower":
            emb = self._encoder(ids, mask)
        else:
            emb = self._encoder(input_ids=ids, attention_mask=mask).last_hidden_state * mask[..., None]
        return emb.float().cpu().numpy()

    def __call__(self, prompts: list[str]) -> np.ndarray:
        return self.encode_ids(*self.tokenize(prompts))


def save_embeddings(prompts: list[str], encoder, out_paths: list[str]) -> None:
    emb = encoder(prompts)
    for i, path in enumerate(out_paths):
        np.save(path, emb[i])


def load_embedding(path: str, max_length: Optional[int] = None) -> np.ndarray:
    """A saved embedding as (1, S, D) float32, cut or zero-padded to ``max_length``."""
    emb = np.load(path).astype(np.float32)
    if emb.ndim == 2:
        emb = emb[None]
    if max_length is not None and emb.shape[1] != max_length:
        if emb.shape[1] > max_length:
            emb = emb[:, :max_length]
        else:
            pad = np.zeros((emb.shape[0], max_length - emb.shape[1], emb.shape[2]), dtype=emb.dtype)
            emb = np.concatenate([emb, pad], axis=1)
    return emb
