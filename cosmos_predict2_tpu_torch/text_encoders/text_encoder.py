"""The Cosmos-Reason1 text encoder: tokenize -> Qwen forward -> pooled embedding.

Counterpart of cosmos_predict2_tpu/text_encoders/text_encoder.py:
chat-template tokenization with the image-generator system prompt, padded
or truncated to 512 ids, the forward with every hidden state, per-layer
mean-normalization and FULL_CONCAT / MEAN_POOLING /
POOL_EVERY_N_LAYERS_AND_CONCAT pooling. The 2B Video2World checkpoints take
FULL_CONCAT, 28 x 3584 = 100,352 channels, into the DiT's text projection.

The tokenizer is ``transformers.AutoTokenizer`` at ``tokenizer_path``,
imported only when a prompt is tokenized; without a path tokenizing raises
(token ids go to :meth:`CosmosTextEncoder.encode_tokens` directly). A
caller may hand in its own tokenizer object instead (anything with
``apply_chat_template`` and ``pad_token_id``). :func:`load_text_encoder`
reads an HF Qwen2.5-VL / Qwen2 state dict (the inference CLI's
``--text-encoder``); :func:`build_text_encoder` draws seeded weights on the
device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from cosmos_predict2_tpu_torch.text_encoders.qwen import QwenConfig, QwenLM, build_qwen_lm, pool_hidden_states

from cosmos_predict2_tpu_torch.utils import log

NUM_EMBEDDING_PADDING_TOKENS = 512
SYSTEM_PROMPT = "You are a helpful assistant who will provide prompts to an image generator."


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    model: QwenConfig = QwenConfig.qwen2_5_vl_7b()
    embedding_concat_strategy: str = "full_concat"
    n_layers_per_group: int = 5
    num_padding_tokens: int = NUM_EMBEDDING_PADDING_TOKENS
    tokenizer_path: Optional[str] = None  # a local HF tokenizer directory


class CosmosTextEncoder:
    """Prompts -> (B, num_padding_tokens, channels) fp32 embeddings on the
    LM's device."""

    def __init__(self, config: TextEncoderConfig, lm: Optional[QwenLM] = None, tokenizer: Any = None):
        self.config = config
        self.lm = lm
        self._tokenizer = tokenizer

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            if self.config.tokenizer_path is None:
                raise ValueError("tokenizer_path not set; pass token ids directly to encode_tokens()")
            from transformers import AutoTokenizer

            self._tokenizer = AutoTokenizer.from_pretrained(self.config.tokenizer_path)
        return self._tokenizer

    def tokenize(self, prompts: list[str]) -> np.ndarray:
        """Chat-template tokenization, padded or truncated to
        ``num_padding_tokens`` ids: (B, n) int32."""
        tok = self.tokenizer
        pad_id = tok.pad_token_id if tok.pad_token_id is not None else 0
        n = self.config.num_padding_tokens
        rows = []
        for prompt in prompts:
            conversation = [{"role": "system", "content": SYSTEM_PROMPT}, {"role": "user", "content": prompt}]
            ids = list(tok.apply_chat_template(conversation, tokenize=True, add_generation_prompt=False))
            rows.append((ids[:n] + [pad_id] * max(0, n - len(ids)))[:n])
        return np.asarray(rows, dtype=np.int32)

    def _device(self) -> torch.device:
        if self.lm is None:
            raise ValueError("text encoder weights not loaded")
        return self.lm.embed_tokens.weight.device

    def _pool(self, hidden_states) -> torch.Tensor:
        return pool_hidden_states(hidden_states, self.config.embedding_concat_strategy,
                                  self.config.n_layers_per_group)

    @torch.no_grad()
    def encode_tokens(self, input_ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long).to(self._device())
        return self._pool(self.lm(ids))

    @torch.no_grad()
    def encode_multimodal(self, input_ids, vision_embeds: torch.Tensor, vision_mask) -> torch.Tensor:
        """Video / image prompts: the vision tower's outputs
        (text_encoders/qwen_vision.py::encode_pixels, at the LM's width) laid
        over the placeholder positions, (B, S, hidden) where the boolean
        ``vision_mask`` (B, S) is set; the pooling is unchanged."""
        dev = self._device()
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long).to(dev)
        mask = torch.as_tensor(vision_mask).to(dev, torch.bool)
        return self._pool(self.lm(ids, vision_embeds=vision_embeds, vision_mask=mask))

    def compute_text_embeddings_online(self, prompts: list[str]) -> torch.Tensor:
        return self.encode_tokens(self.tokenize(prompts))

    def __call__(self, prompts: list[str]) -> torch.Tensor:
        return self.compute_text_embeddings_online(prompts)


def build_text_encoder(config: TextEncoderConfig, device: torch.device | str = "cuda", seed: int = 0,
                       tokenizer: Any = None) -> CosmosTextEncoder:
    """The encoder with seeded random weights drawn on ``device``
    (text_encoders/qwen.py::build_qwen_lm: built on the meta device)."""
    return CosmosTextEncoder(config, build_qwen_lm(config.model, device, seed), tokenizer)


def qwen_config_for(path: str, lm_sd: dict, dtype: torch.dtype) -> QwenConfig:
    """The LM config of an HF text-encoder file: the ``config.json`` beside it
    (or in it, for a directory; Qwen2.5-VL nests it under ``text_config``)
    when there is one, else the 7B preset; the layer count and the Qwen3
    deltas (q/k/v biases, q/k norms) as the state dict holds them."""
    from cosmos_predict2_tpu_torch.utils.checkpoint_convert import qwen_hf_deltas

    cfg = QwenConfig.qwen2_5_vl_7b()
    cfg_path = os.path.join(path if os.path.isdir(path) else os.path.dirname(path), "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            c = json.load(f)
        c = c.get("text_config", c)
        cfg = dataclasses.replace(
            cfg, vocab_size=c["vocab_size"], hidden_size=c["hidden_size"], intermediate_size=c["intermediate_size"],
            num_hidden_layers=c["num_hidden_layers"], num_attention_heads=c["num_attention_heads"],
            num_key_value_heads=c["num_key_value_heads"],
            head_dim=c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"],
            rms_norm_eps=c.get("rms_norm_eps", cfg.rms_norm_eps), rope_theta=c.get("rope_theta", cfg.rope_theta))
    deltas = qwen_hf_deltas(lm_sd)
    if deltas["num_hidden_layers"] != cfg.num_hidden_layers:
        log.warning(f"text encoder {path}: {deltas['num_hidden_layers']} layers in the file, "
                    f"{cfg.num_hidden_layers} in its config; building the file's")
    return dataclasses.replace(cfg, dtype=dtype, **deltas)


def load_text_encoder(path: str, tokenizer_path: Optional[str] = None, device: torch.device | str = "cuda",
                      dtype: Optional[torch.dtype] = None) -> CosmosTextEncoder:
    """An HF Qwen2.5-VL / Qwen2 state dict (a file or a directory of
    shards; utils/checkpoint_convert.py::read_state_dict, memory-mapped)
    -> the encoder on ``device``, built on the meta device and filled from the
    file (every key the LM has must be there with its shape). ``dtype``: the
    compute dtype, by default bf16 on a card and fp32 on the CPU."""
    from cosmos_predict2_tpu_torch.utils.checkpoint_convert import (
        convert_qwen_hf_state_dict,
        load_reference_state_dict,
        read_state_dict,
    )

    device = torch.device(device)
    dtype = dtype or (torch.float32 if device.type == "cpu" else torch.bfloat16)
    sd = convert_qwen_hf_state_dict(read_state_dict(path))
    cfg = qwen_config_for(path, sd, dtype)
    lm = build_qwen_lm(cfg, device, seed=None)
    load_reference_state_dict(lm, sd, f"text encoder {path}")
    return CosmosTextEncoder(TextEncoderConfig(model=cfg, tokenizer_path=tokenizer_path), lm)
