#!/usr/bin/env python3
"""Drive the PyTorch port's Video2World serving and training paths (dense, sparse, DMD2, 14B), the HTTP server with its guardrails, its streaming, forward-mode, released-weights, autoregressive, Text2Image, one-shot-VAE and post-training (LoRA, local clips, tar shards from an S3 store under the profiler, remat, bf16 moments) paths, the post-trained variants (multiview, camera, action) and the gr00t action stream, Wan2.1 i2v, the Wan2.2 VAE, EDM and the 14B sparse pair, and the prompt encoders (Reason1 through the CLI, umT5 and CLIP into Wan i2v, T5-11B, the Qwen2.5-VL vision tower, SigLIP, XLM-R), and the training of self-forcing DMD2 (the causal 2B), Wan2.1 and EDM, and context parallelism (Ulysses, ring, the head-sharded stream, halo'd VAE slabs), once on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printed with its wall time:

1. environment: refuses to run without CUDA; prints the card's name and
   power limit (nvidia-smi) and the torch, CUDA and nvcc versions;
2. build: compiles the hand-written kernels (cosmos_predict2_tpu_torch/csrc)
   with nvcc for sm_90a; prints the registers, shared memory and spills of
   the warp-specialised kernels (K2 at each of its wgmma widths, K1, K5,
   K6, K7, K8, K9, K10, K11, K12 and the second passes of K5/K6 and K8)
   from ptxas's report and fails on a spill or on a launch register count
   other than the one their setmaxnreg budget balances at (168);
3. kernels: each kernel against its plain PyTorch version (fp32, TF32 off)
   on bf16 inputs at the main paths' shapes, with max-abs and relative-L2
   error, a second call that must give the same bits (K1, K2, K5-K12),
   CUDA-event times, the card's bound for the same work (for
   K10-K12 also the pairs their walk computes, the time those take at the
   bf16 peak and the kernel's rate on them; for K2 its plan, rate and share
   of the bf16 peak at each stage of the smoke geometry's VAE and the 720p
   decoder's shapes) and, as a yardstick the port
   never calls, one PyTorch call computing the same
   function (scaled_dot_product_attention forward / backward, conv3d;
   K7 + K8 against SDPA's backward, which computes dq, dk and dv in one
   call, at self- and cross-attention, a frame group, 720p (self held on
   1024 query rows and 1024 key columns, cross to 512 keys whole: the LoRA
   path's shapes) and ragged tails on K8's split route, each called twice
   to show the bits repeat;
   for neighborhood attention SDPA with the boolean window mask, or
   flex_attention with a block mask from the same predicate at 720p);
   K10, K11 and K12 at the sparse config's window at the smoke geometry, at
   720p, at 480p (padded) and on a dilated 720p layer; K5 and K6 (the cache
   decode, dense and row-windowed) at the interactive path's 352x640 block
   at full and early fill, with 2-frame blocks, at 720p and on a prime row
   count (23 x 40), K5 also with NaN past the fill and with its split-KV
   plan's splits printed, with SDPA over the filled cache (K6: with the
   boolean window mask) as the yardstick; K9 (fused forward mode) at B1 S8320 and
   S5760 H16, on a kv tail with frame_group 256 and with dv-only tangents,
   against its plain version by heads, beside K1 at the same shape and
   torch.func.jvp of SDPA (the first backend that takes it);
4a. forward mode: flash_attention_fwdmode under torch.func.jvp and under
   forward_ad at B1 S5760 H16 launches one K1 and one K9 each and matches
   the plain version; scripts/fa_jvp.py's run at B1 S8320 H16;
4. small reference: a narrow pipeline (2 blocks, VAE dim 64), dense and
   with a sparse block, and with the distilled dmd2 sampler (4 steps), on
   the card against the same weights run in fp32 on the CPU through the
   plain versions;
5. serving slice: the full-width 2B DiT and full-width Wan2.1 VAE on seeded
   random weights serve a Text2World, an Image2World and a Video2World
   request (93 frames at 192x320, 35 UniPC steps, CFG guidance 7) through
   Video2WorldInference; checks the outputs and that K1 ran 2 x 28 times per
   DiT forward and K2 ran; then profiles one batched-CFG DiT forward and
   one streaming VAE encode and decode of a request's clip;
   the same for one Video2World request on the sparse 2B DiT
   (predict2_video2world_2b_sparse: 7 dense blocks, 21 neighborhood
   attention), with K1 35 and K10 21 times per DiT forward; then one dmd2
   request through the Inference API on the 2B DMD2 student (image input,
   4 TrigFlow steps at batch 1, no CFG): exactly 224 K1 and K2, no K9;
6. small training reference: one training step of a narrow DiT (2 blocks,
   dense and with a sparse block), and a DMD2 student step and critic step
   of narrow nets, in bf16 on the card against the same weights and draws
   in fp32 on the CPU: losses and gradients;
7. training slice: training/train.py's ``launch`` trains the full-width 2B
   DiT (93 frames at 192x320, 2B text width, batch 1, EMA on) for one
   warm-up step, a few timed steps and one step under torch.profiler
   (device time by kernel) on mock data encoded by the VAE; checks finite
   losses, a finite gradient on every parameter at step 1, that parameters
   and EMA moved, and the launches per step (K1 4 x 28, K7 and K8 2 x 28)
   and K2 in the data phase; then the sparse 2B DiT for one warm-up, two
   timed and one profiled step, with K1 70, K10 42, K7 35, K8 35, K11 21
   and K12 21 launches per step; then DMD2 distillation of the 2B student
   (training/distill_trainer.py: student, frozen teacher and fake-score
   nets in fp32, 93 frames at 192x320, batch 1, block remat, 4 critic
   steps and 1 student step): finite losses, each phase changes only its
   net, K1 56 n + 112 (critic) or 56 n + 168 (student) with K7 and K8 56
   per step for the drawn n sampler steps, no K9; step times and peak
   memory;
8. small interactive reference: a narrow causal DiT (2 blocks) streams in
   bf16 on the card through K5 and then K6 against the same weights, inputs
   and noise in fp32 on the CPU through the plain versions;
9. interactive slice: the full-width causal 2B DiT (built as
   scripts/interactive_latency.py builds it, seeded random weights) streams
   20 blocks of one latent frame at 352x640 after one prefilled frame
   (cache 16 + 1 frames, 4 steps, the window slides 5 times) through
   StreamingInference.generate, dense (K5) and with 7 of 22 rows (K6);
   checks the outputs, the cache length after every block, the exact
   launches (28 + 2,800 K5 or K6 and as many K1) and that the peak memory
   holds one copy of the cache; profiles one steady-state block step; runs
   the script's ``measure`` once for its result line;
10. released weights: a synthetic checkpoint at the true 2B shapes
   (patterned bf16 tensors under ``net_ema.``, utils/checkpoint_export.py)
   and the seeded random VAE, written under outputs/chip_smoke/, registered
   in the checkpoint DB under the Index-26 resume2 experiment and loaded by
   its DB name through utils/model_loader.py (every weight bit-equal to the
   file's; load time and peak memory); then the port's verifier writes a
   golden and meets it at >= 35 dB (2 steps, 5 frames at 64x64, one-shot
   VAE decode): exactly 224 K1 and K2; the files are deleted;
11. autoregressive: one Image2World request through Inference with
   enable_autoregressive, 181 frames at 192x320 in chunks of 93 sharing 2
   latent frames: two chunks of 35 UniPC steps with CFG 7, 181 uint8
   frames, chunk 2 opening on chunk 1's last 5 written-back frames, exactly
   3,920 K1 and K2;
12. text2image: one mode="image" request at the 720 bucket, 16:9
   (1280x720, one latent frame), 35 steps with CFG 7: a 720x1280x3 png,
   exactly 1,960 K1 and K2;
13. one-shot VAE: a 93-frame 192x320 clip encoded and decoded whole
   (streaming_vae=False) against the streaming route on the same weights
   (relative L2 limits 3x the bf16 gap measured on the CPU), with K2
   launches, times and peak memory of both; then one Text2World request at
   35 steps on the one-shot route;
13a. the serving front end with guardrails (A16), on phases 11-13's 2B
   pipeline: Qwen3Guard-Gen-0.6B (a byte-level tokenizer), SigLIP so400m
   with the 7-class safety head and RetinaFace-ResNet50 built on the card at
   released widths on seeded weights (build time, peak, Qwen3Guard's
   verdict time and tokens, 32 of its 128 a verdict: a cut);
   ModelServer(Inference(pipe, text_guardrail=blocklist + Qwen3Guard,
   video_guardrail=safety filter + RetinaFace face blur)) on 127.0.0.1,
   spoken to with urllib: /health, /schema and /; a blocklisted prompt
   ends in status error with no kernel launched; two same-key Image2World requests (by input_path and by input_image_b64)
   queued behind a held job run as one batched pass of 2 steps (a cut:
   phase 5 times 35-step requests at these shapes): exactly 112 K1 and 2 x
   844 K2 (vae_k2_launches), /output serves each as (93, 192, 320, 3)
   uint8 (GET and HEAD); with a second head whose last bias makes an unsafe
   class win, a request ends in "video blocked by guardrail"; SigLIP + head
   on the 12 sampled frames, RetinaFace on 93 frames and its host box math
   timed; narrow card fp32 vs CPU fp32: RetinaFace's loc and conf within
   1e-4 relative L2 and the same boxes from the host math, a 2-layer
   full-width SigLIP + a seeded head giving the same classes;
14. 14B: predict2_video2world_14b_rectified_flow (5120 channels, 36
   blocks, 40 heads) on seeded random bf16 matmul weights built by
   load_model_from_checkpoint, one Text2World request (93 frames at
   192x320, 5 of its 35 steps, CFG 7): exactly 360 K1 (72 per forward) and K2,
   time per step and peak memory;
15. post-training: a local folder of three npz clips (two of 100 frames at
   720x1280, one of 60 that pads; captions; (512, 100352) fp16 embeddings
   for two, none for the third) under outputs/chip_smoke/, deleted at the
   end; the released LoRA recipe
   (predict2_lora_training_2b_cosmos_nemo_assets: the full-width 2B DiT
   frozen under rank-32 adapters, 93 frames at 704x1280, 84,480 tokens,
   batch 1) through training/train.py's main for 2 iterations saved at 2
   (the resumed third iteration is cut): finite losses, K1 112, K7 56 and K8
   56 per step and K2 in the data phase, the native media ops taken (not
   their NumPy fallback), the base bit-equal, adapters (every B) and their
   EMA moved, an adapter-only checkpoint equal to the state; the
   trainable count, the split of step 2, tokens/s and peak memory; then the full fine-tune recipe
   on the same folder at 192x320, one warm-up and 2 timed steps under
   (selective, bf16 moments) and (mixed:14, bf16): K1 56 and 84 per step,
   K7 and K8 56, step time and peak memory beside phase 7's ((block, fp32)
   runs in phase 15b); then a narrow LoRA step and a narrow
   bf16-moment step (2 blocks) in bf16 on the card against the same
   weights, adapters, draws and rounding noise in fp32 on the CPU, at phase
   6's limits;
15b. post-training from remote shards (A16): two tar shards of two clips
   each (93 frames at 192x320 as uint8 npz, (512, 100352) fp16 embeddings
   as npy, fps and caption as json) put with signed PUTs into a fake S3
   store (a threaded http.server on 127.0.0.1) and read back as
   s3://bucket/shard-0000N.tar through easy_io's S3 backend: data/
   loaders.py's ShardedTarDataset downloads them ahead into its ShardSpool
   and feeds training/train.py's latent_batches (the streaming VAE
   encode), and the full fine-tune recipe (block remat, fp32 moments, the
   trainer built as launch builds it) takes one warm-up and 2 timed
   iterations, each inside utils/profiling.py's maybe_enable_profiling
   window test (iteration 1 traced to a Chrome trace) and its
   TrainingTimer's "data" and "step" sections; checks the bytes served
   against the shards', each sample bit-equal to the local route's, an
   empty spool after the epoch, K1 112 and K7 = K8 56 a step and K2 480 a
   clip's encode, finite losses, parameters and EMA moved, a trace naming
   K1, K7 and K8, both timer sections; logs device_memory_report(); then
   tokenizers/interface.py's WanVAEInterface on one clip with seeded
   statistics against the streaming encode normalized (phase 13's
   one-shot limit) and its decode's shape, and utils/golden_activations.py
   dumps of phase 4's narrow 2B net, card bf16 (K1) against CPU fp32
   (phase 4's limit on every tensor);
16. post-trained variants, full-width 2B nets on seeded random weights:
   the 7-view driving model (predict2_multiview_2b_7views) through
   MultiviewInference, 7 views of 29 frames at 704x1280 (197,120 DiT
   tokens), video2world from 2 latent frames of every view, guidance 7,
   1 of its 35 steps, the VAE view by view: the step's time and share of
   the bf16 peak (FLOPs from the shapes) under torch.profiler (device
   time by kernel family), the encode and decode per view, peak memory
   inside the DiT forward, before it (the VAE encode) and after it (the
   decode), exactly 56 K1 and K2; a
   narrow 7-view net (2 blocks)
   with cross-view attention over a ring at the same 44 x 80 token grid,
   card bf16 against CPU fp32 (phase 4's limit), K1 18 times; the
   camera-conditioned model on a 29-frame 704x1280 clip packed [0 | clip
   | 0] into 24 latent frames (84,480 tokens) with Plücker rays of a
   seeded camera track, 1 of its steps at guidance 1.5, the two generated
   chunks decoded, the step under torch.profiler and the same split of the
   peak, exactly 56 K1 and K2; the action-conditioned model (12
   actions of 7 from a seeded robot-state track) through
   ActionConditionedInference on 13 frames at 256x320, 35 steps, exactly
   1,960 K1 and K2. Phase 3 holds K1 at the variants' shapes: self at
   197,120 tokens (1,024 rows against all keys, one head at a time),
   per-view cross-attention at B14 Sq28,160 Skv512 whole, cross-view
   at B16 Sq3,520 Skv7,040 and the action model's self-attention at B2
   S1,280 and cross-attention to 512 keys whole; and K2 at each stage of
   the streaming VAE at the action model's 256x320;
17. the rest of A13 and A12.2, each on seeded random weights: the two
   gr00t names (one config, the causal 2B with action embedders of 84 x 12
   inputs; the first name's model) stream 6 one-frame blocks of 4 steps at 256x320 after one prefilled
   frame through StreamingInference with one action chunk, exactly 28 x 31
   K5 and as many K1, the same stream with the action zeroed moving the
   output; Wan2.1 1.3B i2v (models/wan_video2world.image2world: the first
   frame and zeros through the Wan2.1 VAE, 3 UniPC steps with batched CFG
   at 32,760 tokens, the decode) at 81 x 480x832, exactly 270 K1 and K2,
   step times and their share of the bf16 peak; a streaming Wan2.2 VAE
   round trip of 121 frames at 704x1280 (31 x 44 x 80 x 48 latents), encode
   and decode times and peaks, K2 only; one EDM request on the 2B (93
   frames at 192x320, 35 2ab steps and the clean denoise with CFG 7, one
   conditional frame pinned), exactly 2,016 K1 and K2; each 14B sparse
   name (predict2_video2world_14b_sparse, ..._comb02) built in bf16 on the
   meta device, one batched-CFG step at 720p (84,480 tokens), K10 once per
   sparse block (once on each of comb02's dilated blocks, by a hook) and
   K1 for the dense and cross-attentions; and each path's narrow version
   (Wan i2v, Wan2.2 VAE, EDM, a comb02-kind sparse step, the action
   stream) in bf16 on the card against fp32 on the CPU. Phase 3 holds K1
   at Wan's self-attention (B2 S32,760 H12, 1,024 rows) and its text and
   CLIP cross-attentions (512 and 257 keys, whole), K2 at the Wan2.2 VAE's
   first encoder stage and widest decoder convs, K10-K12 at comb02's
   dilated layers 0-10 and its layers 11-12 with the 14B's 40 heads, K10
   at its two wide windows (layers 23-35), and K5 and K1 at the gr00t
   stream's shapes (one 16 x 20 frame a block, fills of 1 and 5 frames;
   cross-attention at B1 Sq320 Skv512);
18. the prompt encoders (A15), each tower at its released width on seeded
   weights, built on the meta device in bf16 and drawn on the card, its
   build time, forward time (CUDA events) and peak memory logged: a
   2-layer full-width Cosmos-Reason1 file with HF Qwen2.5-VL keys (a .pt:
   the card's machine has no safetensors) through the inference CLI's
   ``--text-encoder`` (COSMOS_SMOKE, the 2B), which attaches it and, with no
   ``--tokenizer-path``, raises on a prompt; those 2 layers on 512 ids in
   bf16 on the card against fp32 on the CPU (the pipelines' 8e-2 limit);
   the Qwen2.5-VL vision tower on a 2-frame 448x448 clip (1,024 patches ->
   256 tokens) spliced into them by ``encode_multimodal``; the 28-layer 7B
   on a prompt and a negative prompt (seeded ids through a stand-in
   tokenizer: the card has no transformers): (2, 512, 100,352), finite,
   each row's channel mean 0 and std 1 on its real tokens, then one
   Text2World request through Inference on them (93 frames at 192x320, 35
   steps, CFG 7): exactly 1,960 K1 and K2; umT5-XXL (24 x 4,096) on 512
   ids and CLIP ViT-H/14 on the first frame inside ``make_i2v_condition``
   condition one Wan 1.3B i2v request as phase 17's (81 x 480x832, 3
   steps): exactly 270 K1 and K2; T5-11B at the published widths through
   ``OfflineT5Encoder`` (zero past each length), SigLIP so400m on four
   384x384 frames and XLM-R large with its head on 512 ids.

19. self-forcing and the variants' training (A12.1, A13.t), each on seeded
   random weights: SelfForcingDMD2 over the interactive experiment's
   full-width causal 2B (student, frozen teacher and fake score in fp32,
   block remat, as phase 7's nets): a rollout of 2 one-frame blocks of 4
   steps at 352x640 (880 tokens a block), one generator_loss backward and
   an AdamW step of the student, one critic_loss backward and a step of
   the fake score: finite losses, a finite non-zero gradient on the net
   stepped and none on the others, the exact K5, K1, K7 and K8 launches and
   cached-attention recomputes of each step (ops/flash_attention.py::
   kv_cache_vjp), its time and peak memory; Wan2.1 1.3B i2v training through
   training/trainer.py at full width (no remat, as the JAX net: 25 frames
   at 480x832, 10,920 tokens, through the VAE), one warm-up and two timed
   steps, 90 K1, K7 and K8 a step; EDM training of the 2B at 93 frames of
   192x320, one warm-up and two timed steps, 112 K1 and 56 K7 and K8 a
   step, sigma_mean; a narrow self-forcing generator and critic step, Wan
   step and EDM step in bf16 on the card against fp32 on the CPU at phase
   6's limits;
20. context parallelism (cosmos_predict2_tpu_torch/parallel/): the
   reckoning of what cp = 4 moves; (a) the real entry at the machine's
   world size, torch.cuda.device_count() NCCL ranks through
   parallel/launch.py's init_distributed and make_mesh(cp=world) (in this
   process on one card, spawned on more; no collective is skipped at world
   size 1): the full-width 2B DiT at 720p (24 x 88 x 160 latents, 84,480
   tokens; 4 of 28 blocks) through Ulysses and through ring, the sparse
   2B's Ulysses + NA block, and the causal 2B stream at 88 x 160 with
   head-sharded caches (dense, then the 14-row window), each against the
   same net unsharded, with exact launches; (b) the rank programs of cp = 4
   at full width on this card, each fed the shards the collectives would
   deliver and assembled against the unsharded kernel: K1 at 84,480 tokens
   x 4 heads (Ulysses) and 4 x 4 blocks of 21,120 x 21,120 x 16 heads
   merged by lse (ring), K10 on 4 head shards, K5 and K6 on head-sharded
   caches of 9 frames x 3,520 tokens, K2 on halo'd 720p decoder slabs,
   cropped ((c), the --cp-proxy ladder, is cut: a measurement without a
   check, its figures in PERF.md);
21. the training mesh (parallel/mesh.py::parallelize, A14.2): (a) at the
   machine's world size (as 20(a); the axes of __graft_entry__.py's
   _pick_axes, 4 cards -> dp 1, fsdp 2, cp 2, tp 1), the full-width 2B
   (2,048 channels, 16 heads; 4 of 28 blocks, no remat) trains 2 steps
   through parallelize (FSDP2, even at world size 1) and the trainer (bf16
   Adam moments, EMA) on 29-frame 192x320 mock clips encoded on each rank
   (K2), with exact K1 / K7 / K8 launches a step; rank 0 trains the same
   net unwrapped on the whole batch: step 0's loss bit-equal and its grad
   norm within fp32 reduction order at world size 1, the rest (and every
   step on more cards) within phase 6's bf16 limits, with the parameters'
   update norm; a DCP save, a load into a fresh state and one resumed step
   equal to the unbroken one; one step with cp_strategy="ring" (c + 1 K1,
   K7 and K8 per block, the cp group set even at cp 1) against the same
   step without; (b) the ring backward's rank programs at cp = 4 on 84,480
   tokens x 16 heads, each rank's 4 K7 + 4 K8 block calls with the global
   lse, assembled against K7 / K8 on the whole sequence, a rank's program
   timed beside the whole call;
22. the last mesh gaps (A14.3-5), at the machine's world size as 21(a)
   (one card: world size 1, the groups set at size 1; four cards: tp 2
   and cp 2 meshes, cp 4): (a) LoRA with the recipe's rank, alpha, targets
   and block remat over the full-width 2B at 4 of 28 blocks, 2 steps
   through training/train.py::launch on 29-frame 192x320 mock clips (each
   rank encodes its rows, K2), at (dp, fsdp, cp, tp) = (1, 2, 1, 2) and
   (1, 2, 2, 1) on four cards; (b) Wan2.1 1.3B i2v at full width and 4 of
   30 layers, sharded by parallelize (tp 2 on four cards: 6 of 12 heads a
   rank), 2 trainer steps on 25-frame 480x832 clips through the Wan2.1
   VAE; (c) the 7-view 2B at 4 blocks, 7 views x 13 frames at 192x320
   (28 latent frames, 6,720 tokens; at cp 4 each rank's 7 frames cross a
   view boundary): the serving forward under Ulysses and ring and with
   cross-view attention, a MultiviewInference request whose grid video
   rank 0 writes, and trainer steps (Ulysses, ring, cross-view) wrapped
   by set_context_parallel and parallelize; every path on rank 0 against
   its one-device run (forwards at KERNEL_REL_L2, steps at phase 21's
   bounds) with exact K1 / K7 / K8 launches a step or forward.

Then it prints the kernels' JSON line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}. Any failure exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# Relative L2 error allowed between a kernel and its plain version: bf16
# inputs and a bf16 output (one rounding, ~4e-3 relative), fp32 sums taken
# in another order.
KERNEL_REL_L2 = 1e-2
# Relative L2 error allowed between the small pipeline in bf16 on the card
# and in fp32 on the CPU: bf16 rounding through 2 DiT blocks, 2 UniPC steps
# and the VAE gives 0.026 on the CPU (bf16 vs fp32, same weights); 3x margin.
PIPELINE_REL_L2 = 8e-2
# The small training step in bf16 on the card against fp32 on the CPU. On
# the CPU, bf16 against fp32 (same weights, 4 draws) gives a loss within
# 5.8e-4 relative, all gradients within 6.0e-3 relative L2 together and
# every parameter's within 1.3e-2; about 3x margin on each.
TRAIN_LOSS_REL = 2e-3
TRAIN_GRAD_REL_L2 = 2e-2
TRAIN_GRAD_TENSOR_REL_L2 = 4e-2
# The small causal stream in bf16 on the card against fp32 on the CPU. On the
# CPU, bf16 against fp32 (same weights, inputs and noise; 5 blocks of 4 steps
# with the loop's bf16 caches on both sides) gives a relative L2 of 3.35e-3
# dense and 3.39e-3 with the window; about 3x margin.
STREAM_REL_L2 = 1e-2
NUM_BLOCKS = 28
SIZE = (192, 320)
NUM_FRAMES = 93
NUM_STEPS = 35
GUIDANCE = 7.0
TRAIN_TIMED_STEPS = 3  # after one warm-up step; one more step runs under torch.profiler
SPARSE_TRAIN_TIMED_STEPS = 2
DENSE_EXPERIMENT = "predict2_video2world_2b_rectified_flow"
SPARSE_EXPERIMENT = "predict2_video2world_2b_sparse"
DMD2_EXPERIMENT = "dmd2_trigflow_distill_cosmos_predict2_2B_bidirectional"
DISTILL_ITERS = 5  # student_update_freq 5: 4 critic steps, then 1 student step
DISTILL_PROFILE_STEP = 3  # the third iteration (a critic step) runs under torch.profiler
# what the phases write (an input image, a text embedding, the dmd2 video): inside the checkout, git-ignored
OUT_DIR = Path(__file__).resolve().parent / "outputs" / "chip_smoke"
# the geometry the sparse config's window is tuned at (its natten_base_size)
NA_BASE = (-1, 44, 80)
# the interactive slice: 352x640 (latent 44 x 80, 22 x 40 tokens), a cache of
# 16 frames plus the block, 4 steps, one prefilled frame, 20 streamed blocks;
# the row window of the K6 run: 7 of 22 rows
INTERACTIVE_HW = (44, 80)
INTERACTIVE_CACHE_FRAMES = 16
INTERACTIVE_STEPS = 4
INTERACTIVE_BLOCKS = 20
INTERACTIVE_WINDOW = 7
# the autoregressive request: 181 frames in chunks of 93 sharing 2 latent
# frames (5 pixel frames): two chunks
AR_CHUNK = 93
AR_OVERLAP = 2
AR_FRAMES = 181
FOURTEEN_B_EXPERIMENT = "predict2_video2world_14b_rectified_flow"
# a cut: each of the 14B request's 35 steps repeats the first's shapes and
# kernels (949.1 ms a step on an H100); 5 keep the request's path whole
FOURTEEN_B_STEPS = 5
# The one-shot VAE against the streaming route on the card (bf16, 93 frames
# at 192x320). On the CPU the full-width VAE in bf16, one-shot against
# streaming on the same weights (17 frames at 64x64,
# tests/test_torch_serving_modes.py::test_oneshot_vae_bf16_gap_on_cpu) gives
# 6.7e-3 relative L2 on the latents and 1.46e-2 on the frames; 3x those.
ONESHOT_LATENT_REL_L2 = 2e-2
ONESHOT_FRAME_REL_L2 = 4.5e-2
# post-training (phase 15): the released LoRA recipe and the full fine-tune
# recipe on a local folder of three clips, two of 100 frames at 720x1280 and
# one of 60 (padded to 93); the full fine-tune at 192x320 under each (remat,
# moments) row with its K1 launches per step
LORA_EXPERIMENT = "predict2_lora_training_2b_cosmos_nemo_assets"
FULL_FT_EXPERIMENT = "predict2_video2world_training_2b_cosmos_nemo_assets"
POSTTRAIN_LONG = 100
POSTTRAIN_SHORT = 60
POSTTRAIN_CLIP_HW = (720, 1280)
POSTTRAIN_GEOMETRY = (93, 704, 1280)  # the recipe's frames, height and width
FULL_FT_TIMED = 2  # after one warm-up step
# (a cut: (block, fp32 moments) runs in phase 15b, on remote shards; (block,
# bf16) last took 0.924 s a step at 35.30 GiB against its 0.854 s at 47.13 on
# an H100 80GB HBM3 at 700 W: PERF.md section 5)
FULL_FT_ROWS = (("selective", "bfloat16", 2 * NUM_BLOCKS), ("mixed:14", "bfloat16", 4 * NUM_BLOCKS - 2 * 14))
# post-trained variants (phase 16): the 7-view driving model at 29 frames of
# 704x1280 per view (8 latent frames of 44 x 80 tokens per view: 197,120
# DiT tokens), video2world from 2 latent frames, 1 of its 35 UniPC steps
# (under the profiler; a second step took as long, 41-42 s);
# the camera-conditioned model on a 29-frame 704x1280 clip packed [0 | clip
# | 0] into 24 latent frames (84,480 tokens), 1 step at guidance 1.5 (under
# the profiler; a second took as long, 8.85 s); the
# action-conditioned model on 13 frames at 256x320 (1,280 tokens), all 35
# steps, 12 actions of 7 from a seeded robot-state track; a narrow 7-view
# net (2 blocks) with cross-view attention over a ring, card bf16 against
# CPU fp32
MULTIVIEW_EXPERIMENT = "predict2_multiview_2b_7views"
CAMERA_EXPERIMENT = "predict2_video2world_2b_camera_conditioned"
ACTION_EXPERIMENT = "predict2_video2world_2b_action_conditioned"
VARIANT_HW = (704, 1280)
VARIANT_FRAMES = 29
MULTIVIEW_STEPS = 1
CAMERA_STEPS = 1  # a cut: a second step repeated the first's shapes and kernels (8.85 s on an H100)
CAMERA_GUIDANCE = 1.5
ACTION_HW = (256, 320)
ACTION_FRAMES = 13
ACTION_GUIDANCE = 3.0
# published dense peaks of one H100 SXM at 700 W, for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        log(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s")
        return False


def errors(out, ref) -> tuple[float, float]:
    d = out.float() - ref.float()
    return float(d.abs().max()), float(d.norm() / ref.float().norm().clamp_min(1e-30))


def cuda_ms(fn, warmup: int = 1, iters: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_call(fn):
    """(fn(), its time in ms by CUDA events): one call timed, for a plain
    version whose output a check needs anyway (no second pass to time it)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def yardstick_ms(fn, warmup: int = 1, iters: int = 3):
    """cuda_ms of a library call that is only a yardstick: when it cannot run
    (out of memory, no kernel for the case), the reason instead of a time."""
    import torch

    try:
        return cuda_ms(fn, warmup, iters)
    except Exception as e:
        torch.cuda.empty_cache()
        return f"none: {type(e).__name__}: {str(e).strip().splitlines()[0][:100]}"


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the operations
    at the bf16 tensor-core peak and the bytes at the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def visible_pairs(sq: int, skv: int, frame_group: int) -> int:
    """(query, key) pairs the mask leaves visible: the work the data needs."""
    if frame_group <= 0:
        return sq * skv
    return int(np.minimum(skv, (np.arange(sq) // frame_group + 1) * frame_group).sum())


def environment() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script runs only on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    from cosmos_predict2_tpu_torch import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True).stdout.strip().splitlines()
    log(f"gpu: {smi}")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  nvcc: {nvcc[-1] if nvcc else '?'}")
    return smi


# the warp-specialised kernels: setmaxnreg moves the producer warpgroup to
# 24 registers and the two consumer warpgroups to 240, which balances only
# if the 384-thread CTA starts at 168 (else the consumers wait forever)
SETMAXNREG_LAUNCH_REGISTERS = 168


def kernel_resources() -> dict:
    """The warp-specialised kernels' registers, shared memory and spills from
    the build's ptxas report (build/cosmos_torch_kernels/build.log); fails
    on a spill or on a setmaxnreg kernel not at 168 registers at launch."""
    from cosmos_predict2_tpu_torch import _build

    from cosmos_predict2_tpu_torch.ops.conv3d import WIDTHS

    report, lib = _build.ptxas_report(), _build.library()
    fwd_smem = lib.cosmos_flash_attention_fwd_smem_bytes(0)
    # K2: one instantiation per wgmma width
    conv = [(f"K2 n{n}", f"conv3d_causal_kernelILi{n}E", lib.cosmos_conv3d_causal_smem_bytes(n), True) for n in WIDTHS]
    out = {}
    for label, key, dynamic, setmaxnreg in (
        *conv,
        ("K1", "flash_attention_fwd_kernel", fwd_smem, True),
        ("K5", "flash_kv_cache_kernel", fwd_smem, True),
        ("K6", "flash_kv_cache_window_kernel", lib.cosmos_flash_attention_fwd_smem_bytes(1), True),
        ("K5/K6 combine of split partials", "kv_cache_combine_kernel", 0, False),
        ("K7", "flash_attention_bwd_dq_kernel", lib.cosmos_flash_attention_bwd_smem_bytes(0), True),
        ("K8", "flash_attention_bwd_dkv_kernel", lib.cosmos_flash_attention_bwd_smem_bytes(1), True),
        ("K8 sum of split partials", "flash_attention_bwd_dkv_reduce_kernel", 0, False),
        ("K9", "flash_attention_jvp_kernel", lib.cosmos_flash_attention_jvp_smem_bytes(), True),
        ("K10", "na_fwd_kernel", lib.cosmos_na_smem_bytes(0), True),
        ("K11", "na_bwd_dq_kernel", lib.cosmos_na_smem_bytes(2), True),
        ("K12", "na_bwd_dkv_kernel", lib.cosmos_na_smem_bytes(1), True),
    ):
        found = [v for name, v in report.items() if key in name]
        if len(found) != 1:
            raise AssertionError(f"ptxas report: {len(found)} entries for {key}")
        r = dict(found[0], dynamic_smem_bytes=dynamic)
        log(f"  {label:30s} {r.get('registers')} registers a thread at launch, {r.get('smem_bytes', 0)} bytes static and "
            f"{dynamic} bytes dynamic shared memory, stack {r.get('stack_bytes')} bytes, spill stores "
            f"{r.get('spill_stores')} loads {r.get('spill_loads')} bytes")
        if r.get("spill_stores") or r.get("spill_loads"):
            raise AssertionError(f"{label} ({key}) spills registers: {r}")
        if setmaxnreg and r.get("registers") != SETMAXNREG_LAUNCH_REGISTERS:
            raise AssertionError(f"{label} ({key}) starts at {r.get('registers')} registers, not "
                                 f"{SETMAXNREG_LAUNCH_REGISTERS}: its setmaxnreg budget would not balance")
        out[label] = r
    # ptxas's performance advisories (for example wgmma products it had to serialise)
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "Performance Loss" in line:
            log(f"  ptxas: {line.strip()}")
    return out


def check_kernels(results: dict) -> None:
    import torch

    import torch.nn.functional as F

    from cosmos_predict2_tpu_torch.ops.conv3d import conv3d_causal, conv3d_causal_plain, conv_plan, conv_weight_taps
    from cosmos_predict2_tpu_torch.ops.flash_attention import (
        attention_delta,
        dkv_split_plan,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    failures = []
    t_kernels = time.perf_counter()

    def fmt(x):
        return x if isinstance(x, str) else "-" if x is None else f"{x:9.3f} ms"

    def record(kernel, label, max_abs, rel, ms, plain_ms, library_ms, bnd, **extra):
        ok = rel <= KERNEL_REL_L2
        log(f"  {kernel:24s} {label:44s} max_abs {max_abs:.3e} rel_l2 {rel:.3e} kernel {ms:9.3f} ms "
            f"plain {fmt(plain_ms)} library {fmt(library_ms)} bound {bnd[0]:.3f} ms ({bnd[1]}) "
            f"{'ok' if ok else 'FAIL'}" + "".join(f" {k} {v}" for k, v in extra.items()))
        entry = results.setdefault(kernel, {"max_abs_err": 0.0, "cases": []})
        entry["max_abs_err"] = max(entry["max_abs_err"], max_abs)
        entry["cases"].append({"case": label, "max_abs": max_abs, "rel_l2": rel, "ms": ms, "plain_ms": plain_ms,
                               "library_ms": library_ms, "bound_ms": bnd[0], "bound_by": bnd[1], **extra})
        if not ok:
            failures.append(f"{kernel} {label}: rel_l2 {rel:.3e} > {KERNEL_REL_L2}")

    def sdpa_mask(Sq, Skv, fg):
        if fg <= 0:
            return None
        return (torch.arange(Skv, device=dev)[None, :] // fg) <= (torch.arange(Sq, device=dev)[:, None] // fg)

    # ---- K1: flash attention forward ----
    # (label, B, Sq, Skv, H, frame_group, query rows held against the plain
    # version[, "heads" / "batch": the plain version one head / one batch
    # element at a time, where its fp32 logits would not fit whole])
    attn_cases = [
        ("self  B2 S5760 H16 (smoke geometry)", 2, 5760, 5760, 16, 0, None),
        ("cross B2 Sq5760 Skv512 H16", 2, 5760, 512, 16, 0, None),
        ("self  B1 S5760 H16 frame_group=240", 1, 5760, 5760, 16, 240, None),
        ("self  B2 S84480 H16 (720p, 1024 rows)", 2, 84480, 84480, 16, 0, 1024),
        ("cross B2 Sq84480 Skv512 H16 (720p, 1024 rows)", 2, 84480, 512, 16, 0, 1024),
        ("self  B2 S3600 H16 (text2image 720p, T=1)", 2, 3600, 3600, 16, 0, None),
        ("cross B2 Sq3600 Skv512 H16 (text2image)", 2, 3600, 512, 16, 0, None),
        ("self  B2 S5760 H40 (14B, smoke geometry)", 2, 5760, 5760, 40, 0, None),
        # the post-trained variants: 7 views of 8 x 44 x 80 tokens, each
        # view's cross-attention to its 512 caption tokens at batch V B, and
        # cross-view attention per frame to 2 neighbour views (B Tv = 2 x 8)
        ("self  B2 S197120 H16 (multiview 7 views, 1024 rows)", 2, 197120, 197120, 16, 0, 1024, "heads"),
        ("cross B14 Sq28160 Skv512 H16 (multiview per view)", 14, 28160, 512, 16, 0, None, "batch"),
        ("cross-view B16 Sq3520 Skv7040 H16 (2 neighbours)", 16, 3520, 7040, 16, 0, None, "batch"),
        # the action model at 256x320: 4 x 16 x 20 tokens and its 512 caption tokens
        ("self  B2 S1280 H16 (action 256x320)", 2, 1280, 1280, 16, 0, None),
        ("cross B2 Sq1280 Skv512 H16 (action)", 2, 1280, 512, 16, 0, None),
        # the gr00t stream's cached forward: one 16 x 20 frame a block, batch 1
        ("cross B1 Sq320 Skv512 H16 (gr00t stream)", 1, 320, 512, 16, 0, None),
        # Wan2.1 1.3B i2v at 81 x 480 x 832 (21 x 30 x 52 tokens), batched
        # CFG: self-attention, the 512 text keys and the 257 CLIP image keys
        # (a ragged kv tail)
        ("self  B2 S32760 H12 (Wan 1.3B 480p, 1024 rows)", 2, 32760, 32760, 12, 0, 1024),
        ("cross B2 Sq32760 Skv512 H12 (Wan text)", 2, 32760, 512, 12, 0, None),
        ("cross B2 Sq32760 Skv257 H12 (Wan CLIP image)", 2, 32760, 257, 12, 0, None),
    ]
    for label, B, Sq, Skv, H, fg, rows, *split in attn_cases:
        q = torch.randn((B, Sq, H, 128), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((B, Skv, H, 128), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((B, Skv, H, 128), generator=gen, device=dev).to(torch.bfloat16)
        out, lse = flash_attention_fwd(q, k, v, frame_group=fg)
        # no atomics: a second call gives the same bits
        repeat = flash_attention_fwd(q, k, v, frame_group=fg)
        torch.cuda.synchronize()
        if not (torch.equal(out, repeat[0]) and torch.equal(lse, repeat[1])):
            failures.append(f"flash_attention_fwd {label}: two calls differ")
        del repeat
        if not bool(torch.isfinite(out.float()).all()):
            failures.append(f"flash_attention_fwd {label}: non-finite output")
        if split == ["batch"]:
            # every row held, one batch element at a time: the whole logits would take 13-25 GB fp32
            parts = [flash_attention_plain(q[b : b + 1], k[b : b + 1], v[b : b + 1], fg) for b in range(B)]
            ref, ref_lse = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
            del parts
            got, got_lse = out, lse
            plain_ms = f"{cuda_ms(lambda: flash_attention_plain(q[:1], k[:1], v[:1], fg), 0, 1) * B:.3f} ms by batch element"
        elif rows is None:
            ref, ref_lse = flash_attention_plain(q, k, v, fg)
            got, got_lse = out, lse
            plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, fg))
        elif split == ["heads"]:
            # rows spread over the sequence (all seven views), against all
            # keys, one head at a time: the rows' logits over every head would take 26 GB fp32
            idx = torch.linspace(0, Sq - 1, rows, device=dev).round().long()
            one = lambda t, h: t[:, :, h : h + 1].contiguous()  # noqa: E731
            qs = q[:, idx]
            parts = [flash_attention_plain(one(qs, h), one(k, h), one(v, h), 0) for h in range(H)]
            ref, ref_lse = torch.cat([p[0] for p in parts], dim=2), torch.cat([p[1] for p in parts], dim=1)
            del parts
            got, got_lse = out[:, idx], lse[:, :, idx]
            plain_ms = (f"{cuda_ms(lambda: flash_attention_plain(one(qs, 0), one(k, 0), one(v, 0), 0), 0, 1) * H:.3f} "
                        f"ms for {rows} rows by head")
        else:
            # the plain version would need B*H*Sq*Skv fp32 logits (~0.9 TB);
            # hold rows spread over the sequence (incl. the ragged last tile)
            idx = torch.linspace(0, Sq - 1, rows, device=dev).round().long()
            qs = q[:, idx].contiguous()
            ref, ref_lse = flash_attention_plain(qs, k, v, 0)
            got, got_lse = out[:, idx], lse[:, :, idx]
            plain_ms = f"{cuda_ms(lambda: flash_attention_plain(qs, k, v, 0), 0, 1):.3f} ms for {rows} rows"
        max_abs, rel = errors(got, ref)
        lse_abs, _ = errors(got_lse, ref_lse)
        log(f"  {'':24s} lse max_abs {lse_abs:.3e}")
        if not lse_abs < 1e-2:
            failures.append(f"flash_attention_fwd {label}: lse max_abs {lse_abs:.3e}")
        del ref, ref_lse, got, got_lse
        # the off-main shapes held on rows or one batch element (the largest) take one timed lap each, the kernel
        # warm from the check's calls: measurement only, and their laps were most of this loop's time
        laps = (1, 3) if rows is None and not split else (0, 1)
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, frame_group=fg), *laps)
        qt, kt, vt, mask = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), sdpa_mask(Sq, Skv, fg)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), *laps)
        nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel()
        bnd = bound(4 * B * H * visible_pairs(Sq, Skv, fg) * 128, nbytes)
        record("flash_attention_fwd", label, max_abs, rel, ms, plain_ms, library_ms, bnd)
        del q, k, v, out, lse, qt, kt, vt, mask
        torch.cuda.empty_cache()

    # ---- K7 (dQ) and K8 (dK, dV): flash attention backward, batch 1 as in training ----
    # (label, Sq, Skv, frame_group, query rows and key columns held against the plain version)
    bwd_cases = [
        ("self  B1 S5760 H16 (smoke geometry)", 5760, 5760, 0, None),
        ("cross B1 Sq5760 Skv512 H16", 5760, 512, 0, None),
        ("self  B1 S5760 H16 frame_group=240", 5760, 5760, 240, None),
        ("self  B1 S84480 H16 (720p, 1024 rows / cols)", 84480, 84480, 0, 1024),
        ("cross B1 Sq84480 Skv512 H16 (720p, LoRA path)", 84480, 512, 0, None),
        ("tail  B1 Sq5800 Skv333 H16 (ragged tiles, K8 split)", 5800, 333, 0, None),
    ]
    B, H = 1, 16
    for label, Sq, Skv, fg, rows in bwd_cases:
        q, do = (torch.randn((B, Sq, H, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, Skv, H, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        out, lse = flash_attention_fwd(q, k, v, frame_group=fg)
        delta = attention_delta(out, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, fg)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, fg)
        # no atomics: a second call gives the same bits
        repeat = (flash_attention_bwd_dq(q, k, v, do, lse, delta, fg), *flash_attention_bwd_dkv(q, k, v, do, lse, delta, fg))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), repeat)):
            failures.append(f"flash attention backward {label}: two calls differ")
        del repeat
        if rows is None:
            ref = flash_attention_bwd_plain(q, k, v, out, lse, do, fg)
            errs = [errors(g, r) for g, r in zip((dq, dk, dv), ref)]
            plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, out, lse, do, fg), 0, 1)
            del ref
        else:
            # the plain version whole would need logits of 0.46 TB. dQ of a
            # row needs only that row's q, dO, out and lse; dK and dV of a
            # key column only that column's k and v with all of q, dO, out
            # and lse: hold rows and columns spread over the sequence (the
            # ragged last tiles included)
            idx = torch.linspace(0, Sq - 1, rows, device=dev).round().long()
            cols = torch.linspace(0, Skv - 1, rows, device=dev).round().long()
            sub = lambda t, i: t[:, i].contiguous()
            ref_dq = flash_attention_bwd_plain(sub(q, idx), k, v, sub(out, idx), lse[:, :, idx].contiguous(),
                                               sub(do, idx), 0)[0]
            errs = [errors(dq[:, idx], ref_dq)]
            del ref_dq
            _, ref_dk, ref_dv = flash_attention_bwd_plain(q, sub(k, cols), sub(v, cols), out, lse, do, 0)
            errs += [errors(dk[:, cols], ref_dk), errors(dv[:, cols], ref_dv)]
            plain_ms = "not measurable whole (logits of 0.46 TB)"
            del ref_dk, ref_dv
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (dq, dk, dv))
        if not finite:
            failures.append(f"flash attention backward {label}: non-finite gradients")
        ms_dq = cuda_ms(lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, fg), 1, 3 if rows is None else 1)
        ms_dkv = cuda_ms(lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, fg), 1, 3 if rows is None else 1)
        # yardstick: scaled_dot_product_attention's autograd backward (dq, dk, dv in one call)
        leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
        sd_out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask(Sq, Skv, fg))
        dot = do.transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(sd_out, leaves, dot, retain_graph=True), 1,
                             3 if rows is None else 1)
        del leaves, sd_out, dot
        pairs = visible_pairs(Sq, Skv, fg)
        io = 2 * q.numel() + 2 * do.numel() + 2 * k.numel() + 2 * v.numel() + 4 * lse.numel() + 4 * delta.numel()
        bnd_dq = bound(6 * B * H * pairs * 128, io + 2 * q.numel())
        bnd_dkv = bound(8 * B * H * pairs * 128, io + 2 * k.numel() + 2 * v.numel())
        # K7 + K8 against SDPA's backward, which computes dq, dk and dv in one call
        ratio = (ms_dq + ms_dkv) / library_ms
        splits = dkv_split_plan(Sq, Skv, H, B, fg, torch.cuda.get_device_properties(dev).multi_processor_count).splits
        record("flash_attention_bwd_dq", label, *errs[0], ms_dq, plain_ms, library_ms, bnd_dq, pair_over_library=ratio)
        dk_err = max(errs[1][0], errs[2][0]), max(errs[1][1], errs[2][1])
        record("flash_attention_bwd_dkv", label, *dk_err, ms_dkv, plain_ms, library_ms, bnd_dkv, splits=splits)
        log(f"  {'K7 + K8':24s} {label:44s} {ms_dq + ms_dkv:9.3f} ms against SDPA's backward {library_ms:9.3f} ms: "
            f"{ratio:.2f}x (K8 splits {splits})")
        del q, k, v, do, out, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()

    # ---- K2: causal 3x3x3 conv ----
    # (label, T_out, H, W, Cin, Cout): one case per stage of the smoke
    # geometry's streaming encode (4-frame chunks) and decode (2-latent-frame
    # chunks), the same stages at the action model's 256x320, then the 720p
    # decoder shapes
    conv_cases = [
        ("enc T4 192x320 96->96 (smoke)", 4, 192, 320, 96, 96),
        ("enc T4 96x160 96->192 (smoke)", 4, 96, 160, 96, 192),
        ("enc T2 48x80 192->384 (smoke)", 2, 48, 80, 192, 384),
        ("enc T1 24x40 384->384 (smoke)", 1, 24, 40, 384, 384),
        ("dec T2 24x40 384->384 (smoke)", 2, 24, 40, 384, 384),
        ("dec T4 48x80 192->384 (smoke)", 4, 48, 80, 192, 384),
        ("dec T8 96x160 192->192 (smoke)", 8, 96, 160, 192, 192),
        ("dec T8 192x320 96->96 (smoke)", 8, 192, 320, 96, 96),
        ("enc T4 256x320 96->96 (action)", 4, 256, 320, 96, 96),
        ("enc T4 128x160 96->192 (action)", 4, 128, 160, 96, 192),
        ("enc T2 64x80 192->384 (action)", 2, 64, 80, 192, 384),
        ("enc T1 32x40 384->384 (action)", 1, 32, 40, 384, 384),
        ("dec T2 32x40 384->384 (action)", 2, 32, 40, 384, 384),
        ("dec T4 64x80 192->384 (action)", 4, 64, 80, 192, 384),
        ("dec T8 128x160 192->192 (action)", 8, 128, 160, 192, 192),
        ("dec T8 256x320 96->96 (action)", 8, 256, 320, 96, 96),
        ("dec T2 176x320 384->384 (720p)", 2, 176, 320, 384, 384),
        ("dec T4 352x640 192->192 (720p)", 4, 352, 640, 192, 192),
        ("dec T4 704x1280 96->96 (720p)", 4, 704, 1280, 96, 96),
        ("enc T93 192x320 96->96 (one-shot, zero cache)", 93, 192, 320, 96, 96),
        ("dec T1 720x1280 96->96 (text2image, zero cache)", 1, 720, 1280, 96, 96),
        # the Wan2.2 VAE at 704x1280 (352x640 after the 2x2 patchify): the
        # encoder's first stage, and the decoder's widest convs (4-frame
        # chunks after its two temporal doublings)
        ("enc T4 352x640 160->160 (Wan2.2)", 4, 352, 640, 160, 160),
        ("dec T2 88x160 1024->1024 (Wan2.2)", 2, 88, 160, 1024, 1024),
        ("dec T4 176x320 1024->512 (Wan2.2)", 4, 176, 320, 1024, 512),
        ("dec T4 352x640 512->256 (Wan2.2)", 4, 352, 640, 512, 256),
    ]
    for label, T, H, W, cin, cout in conv_cases:
        x = torch.randn((1, T + 2, H, W, cin), generator=gen, device=dev).to(torch.bfloat16)
        if "zero cache" in label:  # the one-shot route: two zero frames before frame 0
            x[:, :2] = 0
        w = (torch.randn((3, 3, 3, cin, cout), generator=gen, device=dev) / (27 * cin) ** 0.5).to(torch.bfloat16)
        b = torch.randn((cout,), generator=gen, device=dev)
        w_taps = conv_weight_taps(w)  # made once per conv, as the streaming VAE keeps it
        out = conv3d_causal(x, w, b, w_taps=w_taps)
        # no atomics: a second call gives the same bits
        if not torch.equal(out, conv3d_causal(x, w, b, w_taps=w_taps)):
            failures.append(f"conv3d_causal {label}: two calls differ")
        torch.cuda.synchronize()
        ref = conv3d_causal_plain(x, w, b, out_dtype=torch.float32)
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(lambda: conv3d_causal(x, w, b, w_taps=w_taps))
        # the plain version's time: three laps at the main case, one elsewhere (measurement only)
        plain_ms = cuda_ms(lambda: conv3d_causal_plain(x, w, b), *((1, 3) if "192x320 96->96 (smoke)" in label
                                                                    else (0, 1)))
        # yardstick: cuDNN's conv3d on the same causally padded input (NDHWC
        # viewed as channels-last NCDHW), spatial zero padding 1
        xc, wc, bc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous(), b.to(torch.bfloat16)
        library_ms = cuda_ms(lambda: F.conv3d(xc, wc, bc, padding=(0, 1, 1)))
        flops = 2 * T * H * W * 27 * cin * cout
        bnd = bound(flops, 2 * x.numel() + 2 * w.numel() + 4 * b.numel() + 2 * out.numel())
        plan = conv_plan(H, W, cin, cout)
        record("conv3d_causal", label, max_abs, rel, ms, plain_ms, library_ms, bnd,
               tflops=round(flops / ms / 1e9, 1), share_of_peak=round(flops / ms / 1e9 / PEAK_BF16_FLOPS * 1e12, 3),
               plan=f"{plan.box_h}x{plan.box_w} n{plan.n}x{plan.n_split}")
        del x, w, w_taps, b, out, ref, xc, wc, bc
        torch.cuda.empty_cache()

    log(f"  (K1, K7 + K8 and K2 checked {time.perf_counter() - t_kernels:.1f} s into the phase)")
    check_na_kernels(gen, record, failures)
    log(f"  (K10-K12 checked {time.perf_counter() - t_kernels:.1f} s into the phase)")
    check_cache_kernels(gen, record, failures)
    check_jvp_kernel(gen, record, failures)
    if failures:
        raise AssertionError("kernel checks failed:\n  " + "\n  ".join(failures))


def flex_yardstick(q, k, v, do, size, window, stride, dilation):
    """flex_attention with a block mask from the neighborhood predicate on
    token-major (B, H, S, D) tensors: (forward ms, backward ms), or the
    reason there is none."""
    import torch

    from cosmos_predict2_tpu_torch.ops.neighborhood_attention import na_mask

    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        S = q.shape[2]
        block_mask = torch.compile(create_block_mask)(
            lambda b, h, qi, ki: na_mask(qi, ki, size, window, stride, dilation), None, None, S, S, device=q.device)
        flex = torch.compile(flex_attention)
        fwd_ms = cuda_ms(lambda: flex(q, k, v, block_mask=block_mask))
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        # the compiled backward does not keep its graph for a second call: time
        # forward + backward and take the forward away
        both_ms = cuda_ms(lambda: torch.autograd.grad(flex(*leaves, block_mask=block_mask), leaves, do))
        return fwd_ms, both_ms - fwd_ms
    except Exception as e:  # a yardstick only: the reason goes into the row
        torch.cuda.empty_cache()
        reason = f"none: flex_attention did not run ({type(e).__name__}: {str(e).strip().splitlines()[0][:100]})"
        return reason, reason


def check_na_kernels(gen, record, failures) -> None:
    """K10, K11 and K12 against their plain versions on the tiled layout, 16
    heads (the 14B's cases 40), forward at the case's batch and backward at
    batch 1."""
    import torch
    import torch.nn.functional as F

    from cosmos_predict2_tpu_torch.ops import neighborhood_attention as na

    dev = torch.device("cuda")
    # (name, (T, H, W), window, stride, dilation, forward batch, library
    # route, heads, backward too): the 2B sparse config's window adapted to
    # the smoke geometry (batch 2 as in batched CFG) and at 720p; the 480p
    # grid (H and W padded to the tiles; strides 3 and 5); layer 0 of the
    # 14B comb02 list (dilated) at 720p, at 16 heads and at the 14B's 40;
    # comb02's other sparse kinds at 720p and 40 heads: layers 11-12
    # (strided and dilated), and the forward only of the two wide windows
    # (layers 23-35). flex_attention is timed on the 720p row only: it
    # compiles anew for each mask (the comb02 rows' flex times are in
    # PERF.md).
    cases = [
        ("smoke", (24, 12, 20), (-1, 12, 24), (1, 4, 8), (1, 1, 1), 2, "sdpa", 16, True),
        ("720p", (24, 44, 80), (-1, 12, 24), (1, 4, 8), (1, 1, 1), 1, "flex", 16, True),
        ("480p padded", (24, 30, 52), (-1, 12, 24), (1, 4, 8), (1, 1, 1), 1, "sdpa", 16, True),
        ("720p comb02 dilated", (24, 44, 80), (-1, 4, 16), (1, 1, 1), (1, 11, 5), 1, None, 16, True),
        ("720p comb02 dilated H40 (14B)", (24, 44, 80), (-1, 4, 16), (1, 1, 1), (1, 11, 5), 1, None, 40, True),
        ("720p comb02 layer 11 H40 (14B)", (24, 44, 80), (-1, 12, 16), (1, 4, 1), (1, 1, 5), 1, None, 40, True),
        ("720p comb02 wide H40 (14B)", (24, 44, 80), (-1, 28, 56), (1, 4, 8), (1, 1, 1), 1, None, 40, False),
        ("720p comb02 mid H40 (14B)", (24, 44, 80), (-1, 20, 40), (1, 4, 8), (1, 1, 1), 1, None, 40, False),
    ]
    for name, grid, window, stride, dilation, bf, route, H, backward in cases:
        size = na.VideoSize(*grid)
        w, s, d = na.adaptive_na_parameters(window, stride, grid, NA_BASE, dilation)
        ew, es = na.effective_params(size, w, s, d)
        plan = na.build_plan(size, ew, es, d)
        S = grid[0] * grid[1] * grid[2]
        label = f"{name} {grid[0]}x{grid[1]}x{grid[2]} w{w} s{s}" + (f" d{d}" if d != (1, 1, 1) else "")
        pairs = na.visible_pairs(size, ew)
        walked = na.walk_computed_pairs(plan)
        extra = {"visible_pairs": pairs, "s_pad": plan.s_pad}

        def on_computed(kernel, flops_per_pair, batch, ms):
            """The kernel's own work: the pairs its walk computes, the time they
            take at the bf16 peak, and the kernel's rate on them."""
            n = walked[kernel]
            flops = flops_per_pair * batch * H * n * 128
            return {"computed_pairs": n, "computed_at_peak_ms": round(flops / PEAK_BF16_FLOPS * 1e3, 3),
                    "tflops_on_computed": round(flops / ms / 1e9, 1)}
        real = na.permute_in(torch.ones((1, S, 1, 1), device=dev), plan)[0, 0, :, 0] > 0
        mask = None
        if route == "sdpa":
            idx = torch.arange(S, device=dev)
            mask = na.na_mask(idx[:, None], idx[None, :], size, w, s, d)

        # ---- K10 forward ----
        bshd = [torch.randn((bf, S, H, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3)]
        q, k, v = (na.permute_in(x, plan) for x in bshd)
        out, lse = na.na_fwd(q, k, v, plan, ew, es)
        # no atomics: a second call gives the same bits
        repeat = na.na_fwd(q, k, v, plan, ew, es)
        torch.cuda.synchronize()
        if not (torch.equal(out, repeat[0]) and torch.equal(lse, repeat[1])):
            failures.append(f"na_fwd {label}: two calls differ")
        del repeat
        (ref, ref_lse), plain_ms = timed_call(lambda: na.na_fwd_plain(q, k, v, plan, ew, es))  # the check's own call
        max_abs, rel = errors(out, ref)
        lse_abs, _ = errors(lse[:, :, real], ref_lse[:, :, real])
        log(f"  {'':24s} lse max_abs {lse_abs:.3e} (real rows); pad rows of out all zero: "
            f"{bool((out[:, :, ~real] == 0).all())}")
        if not lse_abs < 1e-2:
            failures.append(f"na_fwd {label}: lse max_abs {lse_abs:.3e}")
        del ref, ref_lse
        ms = cuda_ms(lambda: na.na_fwd(q, k, v, plan, ew, es))
        layout_ms = cuda_ms(lambda: ([na.permute_in(x, plan) for x in bshd], na.permute_out(out, plan)))
        qh, kh, vh = (x.transpose(1, 2) for x in bshd)
        if route == "sdpa":
            library_fwd = yardstick_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
        elif route == "flex":  # batch 1: the backward's yardstick comes from the same call
            doh = torch.randn(qh.shape, generator=gen, device=dev).to(torch.bfloat16)
            library_fwd, library_bwd = flex_yardstick(qh, kh, vh, doh, size, w, s, d)
            del doh
        else:
            library_fwd = library_bwd = "not timed for this case (flex_attention's is on the 720p row)"
        # the bound's bytes count the S real tokens: pad slots of the tiled
        # layout are neither keys nor queries, and their zero rows are the
        # layout's own (s_pad beside the bound shows that overhead)
        nbytes = 2 * 4 * bf * H * S * 128 + 4 * bf * H * S
        record("na_fwd", label, max_abs, rel, ms, plain_ms, library_fwd, bound(4 * bf * H * pairs * 128, nbytes),
               layout_ms=round(layout_ms, 3), **extra, **on_computed("na_fwd", 4, bf, ms))
        del bshd, q, k, v, out, lse, qh, kh, vh
        torch.cuda.empty_cache()
        if not backward:
            del mask
            continue

        # ---- K11 dQ and K12 dK/dV, batch 1 ----
        bshd = [torch.randn((1, S, H, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(4)]
        q, k, v, do = (na.permute_in(x, plan) for x in bshd)
        out, lse = na.na_fwd(q, k, v, plan, ew, es)
        delta = na.na_delta(out, do)
        dq = na.na_bwd_dq(q, k, v, do, lse, delta, plan, ew, es)
        dk, dv = na.na_bwd_dkv(q, k, v, do, lse, delta, plan, ew, es)
        repeat = (na.na_bwd_dq(q, k, v, do, lse, delta, plan, ew, es), *na.na_bwd_dkv(q, k, v, do, lse, delta, plan, ew, es))
        torch.cuda.synchronize()
        for name, got, again in (("na_bwd_dq", dq, repeat[0]), ("na_bwd_dkv", dk, repeat[1]), ("na_bwd_dkv", dv, repeat[2])):
            if not torch.equal(got, again):
                failures.append(f"{name} {label}: two calls differ")
        del repeat
        ref, plain_ms = timed_call(lambda: na.na_bwd_plain(q, k, v, out, lse, do, plan, ew, es))  # the check's call
        errs = [errors(g, r) for g, r in zip((dq, dk, dv), ref)]
        del ref
        if not all(bool(torch.isfinite(t.float()).all()) for t in (dq, dk, dv)):
            failures.append(f"neighborhood attention backward {label}: non-finite gradients")
        ms_dq = cuda_ms(lambda: na.na_bwd_dq(q, k, v, do, lse, delta, plan, ew, es))
        ms_dkv = cuda_ms(lambda: na.na_bwd_dkv(q, k, v, do, lse, delta, plan, ew, es))
        if route == "sdpa":
            # yardstick: scaled_dot_product_attention's autograd backward with the mask (dq, dk, dv in one call)
            leaves = [x.transpose(1, 2).detach().requires_grad_(True) for x in bshd[:3]]
            dot = bshd[3].transpose(1, 2)
            library_bwd = library_fwd  # the reason, where the forward did not run
            if isinstance(library_fwd, float):
                sd_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
                library_bwd = yardstick_ms(lambda: torch.autograd.grad(sd_out, leaves, dot, retain_graph=True))
                del sd_out
            del leaves, dot
        # q, k, v and dO read, lse and delta read, over the S real tokens
        grad_bytes = 2 * H * S * 128
        io = 4 * grad_bytes + 2 * 4 * H * S
        record("na_bwd_dq", label, *errs[0], ms_dq, plain_ms, library_bwd, bound(6 * H * pairs * 128, io + grad_bytes),
               **extra, **on_computed("na_bwd_dq", 6, 1, ms_dq))
        dkv_err = max(errs[1][0], errs[2][0]), max(errs[1][1], errs[2][1])
        record("na_bwd_dkv", label, *dkv_err, ms_dkv, plain_ms, library_bwd,
               bound(8 * H * pairs * 128, io + 2 * grad_bytes), **extra, **on_computed("na_bwd_dkv", 8, 1, ms_dkv))
        del bshd, q, k, v, do, out, lse, delta, dq, dk, dv, mask
        torch.cuda.empty_cache()


def check_cache_kernels(gen, record, failures) -> None:
    """K5 and K6 against their plain versions at the interactive path's
    shapes: batch 1, 16 heads, q one block of whole frames, head-major
    buffers with +-1e3 past the fill (it must not reach the output); K5
    once more with NaN past the fill, which a mask alone does not keep out
    (0 x NaN is NaN)."""
    import torch
    import torch.nn.functional as F

    from cosmos_predict2_tpu_torch.ops.flash_attention import (
        flash_attention_kv_cache,
        flash_attention_kv_cache_window,
        kv_cache_plain,
        kv_cache_split_plan,
        kv_cache_window_plain,
        kv_window_split_plan,
        window_rows_bounds,
        window_walk_pairs,
    )

    dev = torch.device("cuda")
    H = 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # (name, token grid gh x gw, frames per block, filled frames, buffer
    # frames, window rows; None: K5 only); the gr00t stream at 256x320: its
    # first block and its steady state in a buffer of 4 + 1 frames
    cases = [
        ("352x640 steady", 22, 40, 1, 17, 17, INTERACTIVE_WINDOW),
        ("352x640 early", 22, 40, 1, 4, 17, INTERACTIVE_WINDOW),
        ("352x640 nb2", 22, 40, 2, 18, 18, INTERACTIVE_WINDOW),
        ("720p", 44, 80, 1, 9, 9, 2 * INTERACTIVE_WINDOW),
        ("prime gh 23x40", 23, 40, 1, 17, 17, INTERACTIVE_WINDOW),
        ("352x640 NaN past a ragged fill", 22, 40, 1, 12, 17, None),
        ("256x320 gr00t first block", 16, 20, 1, 1, 5, None),
        ("256x320 gr00t steady", 16, 20, 1, 5, 5, None),
    ]
    for name, gh, gw, nb, filled, frames, wh in cases:
        Fr = gh * gw
        Sq, fill = nb * Fr, filled * Fr
        nan = "NaN" in name
        if nan:
            fill -= 77  # the frontier inside a kv tile
        label = f"{name} Sq{Sq} fill {fill}"
        q = torch.randn((1, Sq, H, 128), generator=gen, device=dev).to(torch.bfloat16)
        kb, vb = (torch.randn((1, H, frames * Fr, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        kb[:, :, fill:] = float("nan") if nan else 1e3
        vb[:, :, fill:] = float("nan") if nan else -1e3
        # each input read once (q and the filled cache), the output written once
        nbytes = 2 * 2 * q.numel() + 2 * 2 * H * fill * 128
        qh, kh, vh = q.transpose(1, 2), kb[:, :, :fill], vb[:, :, :fill]

        out = flash_attention_kv_cache(q, kb, vb, fill)
        repeat = flash_attention_kv_cache(q, kb, vb, fill)  # the split route's combine is in split order
        torch.cuda.synchronize()
        if not torch.equal(out, repeat):
            failures.append(f"flash_attention_kv_cache {label}: two calls differ")
        max_abs, rel = errors(out, kv_cache_plain(q, kb, vb, fill))
        if not bool(torch.isfinite(out.float()).all()):
            failures.append(f"flash_attention_kv_cache {label}: non-finite output")
        ms_k5 = cuda_ms(lambda: flash_attention_kv_cache(q, kb, vb, fill), 2, 10)
        plain_ms = cuda_ms(lambda: kv_cache_plain(q, kb, vb, fill), 0, 1)
        library_ms = yardstick_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 2, 10)
        record("flash_attention_kv_cache", label, max_abs, rel, ms_k5, plain_ms, library_ms,
               bound(4 * H * Sq * fill * 128, nbytes), splits=kv_cache_split_plan(Sq, fill, H, 1, sms).splits)
        del out, repeat
        if wh is None:
            del q, kb, vb, qh, kh, vh
            torch.cuda.empty_cache()
            continue

        label_w = f"{label} rows {min(wh, gh)}/{gh}"
        out = flash_attention_kv_cache_window(q, kb, vb, fill, (gh, gw), wh)
        repeat = flash_attention_kv_cache_window(q, kb, vb, fill, (gh, gw), wh)  # the split route's combine in order
        torch.cuda.synchronize()
        if not torch.equal(out, repeat):
            failures.append(f"flash_attention_kv_cache_window {label_w}: two calls differ")
        del repeat
        max_abs, rel = errors(out, kv_cache_window_plain(q, kb, vb, fill, (gh, gw), wh))
        if not bool(torch.isfinite(out.float()).all()):
            failures.append(f"flash_attention_kv_cache_window {label_w}: non-finite output")
        ms = cuda_ms(lambda: flash_attention_kv_cache_window(q, kb, vb, fill, (gh, gw), wh), 2, 10)
        plain_ms = cuda_ms(lambda: kv_cache_window_plain(q, kb, vb, fill, (gh, gw), wh), 0, 1)
        lo, hi = window_rows_bounds(torch.arange(Sq, device=dev), (gh, gw), wh)
        yk = (torch.arange(fill, device=dev) % Fr) // gw
        mask = (yk[None, :] >= lo[:, None]) & (yk[None, :] < hi[:, None])
        library_ms = yardstick_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask), 2, 10)
        pairs = window_walk_pairs(Sq, fill, (gh, gw), wh)  # per head: visible, loaded and computed by K6's walk
        record("flash_attention_kv_cache_window", label_w, max_abs, rel, ms, plain_ms, library_ms,
               bound(4 * H * pairs["visible"] * 128, nbytes), visible_pairs=pairs["visible"],
               loaded_pairs=pairs["loaded"], computed_pairs=pairs["computed"],
               splits=kv_window_split_plan(Sq, fill, (gh, gw), wh, H, 1, sms), k5_ms=round(ms_k5, 4),
               k5_computed_pairs=-(-Sq // 128) * 128 * -(-fill // 128) * 128)
        del q, kb, vb, qh, kh, vh, out, lo, hi, yk, mask
        torch.cuda.empty_cache()


# the narrow nets' sparse block: block 0 of 2 (n_dense_blocks=1 keeps block 1
# dense), window 3 x 3 with stride 2 along W on the small pipeline's 4 x 4 and
# the small training step's 8 x 12 token grid
SMALL_SPARSE = dict(n_dense_blocks=1, natten_window=(-1, 3, 3), natten_stride=(1, 1, 2), natten_base_size=None)


def small_reference(sparse: bool, sampler: str = "unipc") -> None:
    """A narrow pipeline on the card (bf16, kernels) against the same weights
    in fp32 on the CPU (plain versions): 2 UniPC steps, or the 4 steps of
    the distilled sampler with ``sampler="dmd2"``."""
    import torch

    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.inference.pipeline import InferenceSetup, Video2WorldInference, image_to_input
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae

    from cosmos_predict2_tpu_torch import _build

    cfg = make_config(SPARSE_EXPERIMENT if sparse else DENSE_EXPERIMENT)
    net_cfg = dataclasses.replace(
        cfg.model.net, model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32,
        crossattn_proj_in_channels=64, crossattn_emb_channels=128, **(SMALL_SPARSE if sparse else {}),
    )
    mc = dataclasses.replace(cfg.model, net=net_cfg, state_t=3)
    vc = dataclasses.replace(cfg.tokenizer, dim=64)
    net = build_dit(net_cfg, "cuda", seed=10)
    vae = build_vae(vc, "cuda", seed=11)
    pipe = Video2WorldInference(InferenceSetup(model_config=mc, vae_config=vc, size_override=(64, 64)), net, vae)
    net32 = build_dit(dataclasses.replace(net_cfg, dtype=torch.float32), "cpu", seed=0)
    net32.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    vae32 = build_vae(dataclasses.replace(vc, dtype=torch.float32), "cpu", seed=0)
    vae32.load_state_dict({k: v.cpu() for k, v in vae.state_dict().items()})
    pipe32 = Video2WorldInference(
        InferenceSetup(model_config=dataclasses.replace(mc, net=net32.cfg), vae_config=vae32.config, size_override=(64, 64)),
        net32, vae32,
    )
    rng = np.random.default_rng(0)
    video = image_to_input(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), pipe.num_video_frames)
    emb = rng.standard_normal((1, 16, 64)).astype(np.float32)
    steps = 4 if sampler == "dmd2" else 2
    _build.reset_launch_counts()
    got = pipe.generate_vid2world(video, emb, num_steps=steps, num_conditional_frames=1, sampler=sampler)
    counts = _build.launch_counts()
    ref = pipe32.generate_vid2world(video, emb, num_steps=steps, num_conditional_frames=1, sampler=sampler)
    max_abs = float(np.abs(got - ref).max())
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    log(f"  {'sparse' if sparse else 'dense'} {sampler}: card bf16 vs cpu fp32: shape {got.shape} max_abs "
        f"{max_abs:.3e} rel_l2 {rel:.3e} (limit {PIPELINE_REL_L2}); launches {counts}")
    if sparse and counts["na_fwd"] == 0:
        raise AssertionError("the small sparse pipeline never ran K10")
    if sampler == "dmd2" and counts["flash_attention_fwd"] != steps * 4:  # batch 1, 2 blocks: 4 attention calls
        raise AssertionError(f"the small dmd2 pipeline launched {counts}, want K1 {steps * 4} times")
    if not (got.shape == ref.shape == (9, 64, 64, 3) and np.isfinite(got).all() and rel <= PIPELINE_REL_L2):
        raise AssertionError(f"small pipeline disagrees with its fp32 CPU reference: rel_l2 {rel:.3e}")


def serve_slice(experiment: str, names: tuple[str, ...]) -> dict:
    """Full-width requests of ``experiment`` (those of ``names``); checks the
    outputs and the launches per DiT forward."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.inference.pipeline import (
        InferenceSetup, Video2WorldInference, image_to_input, video_to_input,
    )
    from cosmos_predict2_tpu_torch.networks.dit import block_layout, build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae

    cfg = make_config(experiment)
    if cfg.model.net.num_blocks != NUM_BLOCKS or cfg.model.net.model_channels != 2048:
        raise AssertionError("the slice must run the full-width 2B DiT")
    n_sparse = sum(p is not None for p in block_layout(cfg.model.net))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = build_dit(cfg.model.net, "cuda", seed=0)
    vae = build_vae(cfg.tokenizer, "cuda", seed=1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in net.parameters())
    log(f"  2B DiT {n_params / 1e9:.3f} B params, VAE dim {cfg.tokenizer.dim}: built in {time.perf_counter() - t0:.1f} s")
    setup = InferenceSetup(model_config=cfg.model, vae_config=cfg.tokenizer, size_override=SIZE)
    pipe = Video2WorldInference(setup, net, vae)
    H, W = SIZE
    T = pipe.num_video_frames
    rng = np.random.default_rng(0)
    requests = [
        ("text2world", np.zeros((1, 3, T, H, W), dtype=np.uint8), 0),
        ("image2world", image_to_input(rng.integers(0, 256, (H, W, 3), dtype=np.uint8), T), 1),
        ("video2world", video_to_input(rng.integers(0, 256, (9, H, W, 3), dtype=np.uint8), T, 2), 2),
    ]
    requests = [r for r in requests if r[0] in names]
    embs = [rng.standard_normal((1, 512, cfg.model.net.crossattn_proj_in_channels)).astype(np.float32) for _ in requests]

    _build.reset_launch_counts()
    outputs = []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for (name, video, k), emb in zip(requests, embs):
        t = time.perf_counter()
        frames = pipe.generate_vid2world(
            video, emb, guidance=GUIDANCE, num_steps=NUM_STEPS, num_conditional_frames=k, seed=1, pixel_format="uint8"
        )
        tm = dict(pipe.last_timings, request_s=time.perf_counter() - t)
        log(f"  {name:12s} k={k} steps={NUM_STEPS} request {tm['request_s']:.2f} s: vae_encode {tm['vae_encode_s']:.2f} s, "
            f"denoise {tm['denoise_s']:.2f} s ({tm['denoise_step_s'] * 1e3:.1f} ms/step), vae_decode {tm['vae_decode_s']:.2f} s")
        outputs.append((name, frames))
    serve_s = time.perf_counter() - t_all
    counts = _build.launch_counts()
    log(f"  launches during the slice: {counts}")

    for name, frames in outputs:
        if frames.shape != (NUM_FRAMES, H, W, 3) or frames.dtype != np.uint8:
            raise AssertionError(f"{name}: output {frames.shape} {frames.dtype}, want ({NUM_FRAMES}, {H}, {W}, 3) uint8")
        if frames.std() == 0:
            raise AssertionError(f"{name}: output is constant")
    forwards = NUM_STEPS * len(requests)  # one batched-CFG DiT forward per UniPC step
    # per forward: K1 for every cross-attention and dense self-attention, K10 for the sparse ones
    want = {"flash_attention_fwd": (2 * NUM_BLOCKS - n_sparse) * forwards, "na_fwd": n_sparse * forwards}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"attention launches {({k: counts[k] for k in want})}, want {want} "
                             f"({forwards} forwards, {n_sparse} sparse blocks)")
    if counts["conv3d_causal"] == 0:
        raise AssertionError("conv3d_causal never ran on the main path")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # a denoise step's device work: one batched-CFG DiT forward under torch.profiler
    x = torch.randn((2, cfg.model.state_ch, (T - 1) // 4 + 1, H // 8, W // 8), device="cuda")
    ctx = torch.from_numpy(np.concatenate([embs[0], np.zeros_like(embs[0])])).cuda()
    ts = torch.full((2, 1), 500.0, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        net(x, ts, ctx)
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()  # inside the profiler: its start and teardown are not the forward's
            net(x, ts, ctx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    log(f"  one batched-CFG DiT forward of {experiment} (batch 2, 5,760 tokens):")
    profile = device_time_table(prof, wall)
    vae_profile = None
    if len(requests) > 1:  # the dense slice: a request's VAE work (K2's share), encode and decode of one clip
        from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import decode_streaming, encode_streaming

        clip = torch.from_numpy(requests[1][1]).cuda().permute(0, 2, 3, 4, 1)
        with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            z = encode_streaming(vae, clip, pixel_format="uint8")
            decode_streaming(vae, z, chunk_latent_frames=setup.decode_chunk_latent_frames, pixel_format="uint8")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        log(f"  one streaming VAE encode and decode of a request's clip ({T} frames, {H}x{W}):")
        vae_profile = device_time_table(prof, wall)
    return {"counts": counts, "serve_s": serve_s, "peak_gb": peak_gb, "profile": profile, "vae_profile": vae_profile}


def small_train_step(device: str, dtype, sparse: bool, state_dict=None):
    """One training step of a narrow DiT (2B experiment, 2 blocks of 256
    channels, head_dim 128; with ``sparse`` block 0 is neighborhood
    attention) with fixed weights, inputs and draws; returns (loss, {name:
    grad fp32 on the CPU}, state_dict)."""
    import torch

    from cosmos_predict2_tpu_torch.conditioning.conditioner import apply_train_dropout, make_condition
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import build_dit

    cfg = make_config(SPARSE_EXPERIMENT if sparse else DENSE_EXPERIMENT)
    net_cfg = dataclasses.replace(
        cfg.model.net, model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32,
        crossattn_proj_in_channels=64, crossattn_emb_channels=128, dtype=dtype, **(SMALL_SPARSE if sparse else {}),
    )
    net = build_dit(net_cfg, device, seed=10, trainable=True)
    if state_dict is not None:
        net.load_state_dict(state_dict)
    model = Video2WorldModel(dataclasses.replace(cfg.model, net=net_cfg, state_t=4), net)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((1, 16, 4, 16, 24)).astype(np.float32)).to(device)
    emb = torch.from_numpy(rng.standard_normal((1, 32, 64)).astype(np.float32)).to(device)
    draws = model.sample_train_draws(torch.Generator().manual_seed(0), tuple(x0.shape)).to(device)
    cond = apply_train_dropout(make_condition(emb).replace(gt_frames=x0), draws.text_keep, draws.use_video)
    loss, _ = model.training_step(x0, cond, draws)
    loss.backward()
    grads = {n: p.grad.float().cpu() for n, p in net.named_parameters()}
    return float(loss.detach()), grads, {k: v.cpu() for k, v in net.state_dict().items()}


def small_train_reference(sparse: bool) -> None:
    """The small training step in bf16 on the card (K1, K7, K8; K10, K11,
    K12 with ``sparse``) against the same weights and draws in fp32 on the
    CPU (plain versions)."""
    import torch

    from cosmos_predict2_tpu_torch import _build

    _build.reset_launch_counts()
    loss, grads, sd = small_train_step("cuda", torch.bfloat16, sparse)
    counts = _build.launch_counts()
    ref_loss, ref_grads, _ = small_train_step("cpu", torch.float32, sparse, sd)
    num = sum(float((grads[n] - g).norm()) ** 2 for n, g in ref_grads.items()) ** 0.5
    den = sum(float(g.norm()) ** 2 for g in ref_grads.values()) ** 0.5
    worst = max((float((grads[n] - g).norm() / g.norm().clamp_min(1e-30)), n) for n, g in ref_grads.items())
    loss_rel = abs(loss / ref_loss - 1)
    log(f"  card bf16 loss {loss:.6f} vs cpu fp32 {ref_loss:.6f}: rel {loss_rel:.3e} (limit {TRAIN_LOSS_REL}); "
        f"gradients rel_l2 {num / den:.3e} (limit {TRAIN_GRAD_REL_L2}), worst parameter {worst[0]:.3e} {worst[1]} "
        f"(limit {TRAIN_GRAD_TENSOR_REL_L2}); launches {counts}")
    # backward: one per attention call of the 2 blocks, 1 of them sparse with `sparse`
    want = {"flash_attention_bwd_dq": 3, "flash_attention_bwd_dkv": 3, "na_bwd_dq": 1, "na_bwd_dkv": 1} if sparse \
        else {"flash_attention_bwd_dq": 4, "flash_attention_bwd_dkv": 4, "na_bwd_dq": 0, "na_bwd_dkv": 0}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"the small training step's backward launches {counts}, want {want}")
    if not (all(torch.isfinite(g).all() for g in grads.values()) and loss_rel <= TRAIN_LOSS_REL
            and num / den <= TRAIN_GRAD_REL_L2 and worst[0] <= TRAIN_GRAD_TENSOR_REL_L2):
        raise AssertionError("the small training step on the card disagrees with its fp32 CPU reference")


def kernel_family(name: str) -> str:
    for key, family in (("flash_kv_cache_window_kernel", "K6 cache decode, window"),
                        ("flash_kv_cache_kernel", "K5 cache decode"),
                        ("kv_cache_combine_kernel", "K5/K6 split combine"),
                        ("na_fwd_kernel", "K10 NA forward"), ("na_bwd_dq_kernel", "K11 NA dQ"),
                        ("na_bwd_dkv_kernel", "K12 NA dK/dV"), ("flash_attention_fwd_kernel", "K1 flash attention forward"),
                        ("flash_attention_jvp_kernel", "K9 forward mode"),
                        ("flash_attention_bwd_dq", "K7 flash attention dQ"),
                        ("flash_attention_bwd_dkv", "K8 flash attention dK/dV"),
                        ("conv3d_causal", "K2 causal conv"), ("nvjet", "GEMM (cuBLAS)"), ("gemm", "GEMM (cuBLAS)"),
                        ("xmma", "GEMM (cuBLAS)"), ("cutlass", "GEMM (cuBLAS)"),
                        ("multi_tensor_apply", "foreach (AdamW)"), ("memcpy", "memcpy / memset"),
                        ("memset", "memcpy / memset"), ("reduce", "reductions"), ("copy", "copies and casts"),
                        ("elementwise", "elementwise")):
        if key in name.lower():
            return family
    return "other"


def device_time_table(prof, wall_s: float) -> dict:
    """Device kernel time of a profiled window by family and by kernel."""
    import torch

    by_name: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        # device kernels only: user annotations (e.g. Optimizer.step) span kernels already counted
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            n_kernels += 1
    total = sum(by_name.values())
    families: dict[str, float] = {}
    for name, ms in by_name.items():
        families[kernel_family(name)] = families.get(kernel_family(name), 0.0) + ms
    log(f"  profiled step: {wall_s * 1e3:.1f} ms on the host clock, {total:.1f} ms of device kernels "
        f"(device busy {total / (wall_s * 1e3):.1%} of the step) in {n_kernels} launches")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        log(f"    {fam:28s} {ms:9.1f} ms {ms / total:6.1%}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    top kernel {ms:9.1f} ms  {name[:110]}")
    from cosmos_predict2_tpu_torch.ops.neighborhood_attention import LAYOUT_RANGE

    # the device time of the kernels launched inside the NA layout ranges (permute_in / permute_out copies)
    layout_ms = sum(e.device_time_total for e in prof.events()
                    if e.name == LAYOUT_RANGE and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
    if layout_ms:
        log(f"    of which NA layout copies (permute_in / permute_out) {layout_ms:9.1f} ms {layout_ms / total:6.1%}")
    return {"device_ms": total, "wall_ms": wall_s * 1e3, "families": families, "na_layout_ms": layout_ms,
            "launches": n_kernels}


class TrainProbe:
    """Training callback of the slice: per-step launches, losses and
    timings; a finite gradient on every parameter at step 1; a few
    parameters and their EMA kept from the start to check that both move;
    torch.profiler around the step numbered ``profile_step``."""

    WATCH = ("x_embedder.proj.1.weight", "blocks.0.self_attn.q_proj.weight", "blocks.27.mlp.layer2.weight",
             "final_layer.linear.weight")

    def __init__(self, profile_step: int):
        self.steps, self.start, self.profile_step, self.profile = [], {}, profile_step, None

    def on_train_start(self, trainer, state):
        self.start = {n: (state.params[n].detach().clone(), state.ema_params[n].clone()) for n in self.WATCH}

    def on_training_step_start(self, trainer, state, batch, iteration):
        import torch

        from cosmos_predict2_tpu_torch import _build

        self.counts0 = _build.launch_counts()
        if iteration + 1 == self.profile_step:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def on_training_step_end(self, trainer, state, metrics, iteration):
        import torch

        from cosmos_predict2_tpu_torch import _build

        counts = {k: v - self.counts0[k] for k, v in _build.launch_counts().items()}
        if iteration == self.profile_step:
            self._prof.__exit__(None, None, None)
            self.profile = device_time_table(self._prof, trainer.last_timings["step_s"])
        if iteration == 1:
            bad = [n for n, p in state.params.items() if p.grad is None or not bool(torch.isfinite(p.grad).all())]
            if bad:
                raise AssertionError(f"{len(bad)} parameters without a finite gradient at step 1, e.g. {bad[:3]}")
            log(f"  step 1: all {len(state.params)} trainable parameters have a finite gradient")
        self.steps.append({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                           "counts": counts, **trainer.last_timings})
        st = self.steps[-1]
        log(f"  step {iteration}: loss {st['loss']:.4f} grad_norm {st['grad_norm']:.3e} step {st['step_s']:.3f} s "
            f"(data+vae {st['data_s']:.3f} s, fwd+bwd {st['forward_backward_s']:.3f} s, "
            f"optimizer+ema {st['optimizer_s']:.3f} s) launches {counts}")

    # the other hooks of trainer.Callback, written out: this file imports the
    # port only inside functions, so that it fails cleanly where the port is absent
    def on_save_checkpoint(self, trainer, state, iteration): ...

    def on_train_end(self, trainer, state): ...

    def moved(self, state) -> tuple[bool, bool]:
        import torch

        params = all(not torch.equal(state.params[n], p0) for n, (p0, _) in self.start.items())
        ema = all(not torch.equal(state.ema_params[n], e0) for n, (_, e0) in self.start.items())
        return params, ema


def train_slice(experiment: str, timed_steps: int) -> dict:
    """training/train.py's launch on a full-width 2B experiment: one warm-up
    step, ``timed_steps`` timed steps and one profiled step."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.networks.dit import block_layout
    from cosmos_predict2_tpu_torch.training.train import launch

    H, W = SIZE
    steps = 1 + timed_steps + 1
    cfg = make_config(experiment, [
        f"data_train.num_frames={NUM_FRAMES}", f"data_train.height={H}", f"data_train.width={W}",
        "data_train.text_dim=100352", "data_train.batch_size=1",
        f"trainer.max_iter={steps}", "trainer.save_iter=0", "trainer.logging_iter=1", "trainer.ema_enabled=True",
    ])
    net = cfg.model.net
    if (net.num_blocks, net.model_channels, net.crossattn_proj_in_channels) != (NUM_BLOCKS, 2048, 100352):
        raise AssertionError("the training slice must run the full-width 2B DiT")
    probe = TrainProbe(profile_step=steps)
    gc.collect()  # an earlier slice's trainer may sit in a reference cycle
    torch.cuda.empty_cache()
    log(f"  device memory in use before the launch: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state = launch(cfg, device="cuda", callbacks=[probe])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"  launches during the training slice: {counts}")

    if len(probe.steps) != steps or state.step != steps:
        raise AssertionError(f"trained {state.step} steps, want {steps}")
    if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in probe.steps):
        raise AssertionError(f"non-finite losses: {[s['loss'] for s in probe.steps]}")
    # per step, with block remat (forward and recompute): K1 for every cross-
    # and dense self-attention and K10 for the sparse ones, twice; K7/K8 and
    # K11/K12 once per attention call of each kind
    n_sparse = sum(p is not None for p in block_layout(net))
    n_dense_calls = 2 * NUM_BLOCKS - n_sparse
    want = {"flash_attention_fwd": 2 * n_dense_calls, "flash_attention_bwd_dq": n_dense_calls,
            "flash_attention_bwd_dkv": n_dense_calls, "na_fwd": 2 * n_sparse, "na_bwd_dq": n_sparse,
            "na_bwd_dkv": n_sparse}
    for i, s in enumerate(probe.steps):
        got = {k: s["counts"][k] for k in want}
        if got != want:
            raise AssertionError(f"step {i + 1} launched {got}, want {want}")
    if counts["conv3d_causal"] == 0:
        raise AssertionError("conv3d_causal never ran in the training slice's VAE encode")
    params_moved, ema_moved = probe.moved(state)
    if not (params_moved and ema_moved):
        raise AssertionError(f"parameters moved: {params_moved}, EMA moved: {ema_moved}")
    timed = probe.steps[1:1 + timed_steps]
    mean = lambda key: sum(s[key] for s in timed) / len(timed)
    tokens = (1 + (NUM_FRAMES - 1) // 4) * (H // 16) * (W // 16)
    out = {"counts": counts, "total_s": total_s, "peak_gb": peak_gb, "tokens_per_step": tokens,
           "profile": probe.profile, **{k: mean(k) for k in ("step_s", "data_s", "forward_backward_s", "optimizer_s")}}
    iteration_s = out["data_s"] + out["step_s"]
    log(f"  {experiment}: {timed_steps} timed steps after a warm-up: iteration {iteration_s:.3f} s = data+vae "
        f"{out['data_s']:.3f} s (host mock data, H2D, VAE encode) + train step {out['step_s']:.3f} s (fwd+bwd "
        f"{out['forward_backward_s']:.3f} + optimizer+ema {out['optimizer_s']:.3f}); {tokens} tokens/step: "
        f"{tokens / out['step_s']:.0f} tokens/s over the train step, {tokens / iteration_s:.0f} over the iteration; "
        f"peak device memory {peak_gb:.2f} GiB; whole launch {total_s:.1f} s")
    return out


def small_stream(device: str, dtype, window: int, state_dict=None):
    """A narrow causal DiT (the tiny preset's 2 blocks of 3 heads of 128)
    streams 5 one-frame blocks of 4 steps after one prefilled frame at a 16 x
    24 latent (8 x 12 tokens), cache 3 + 1 frames (the window slides 3
    times), with fixed inputs and noise. Returns (latents fp32 on the CPU,
    launches, state_dict)."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.scripts.interactive_latency import NET_TINY, build_stream

    stream = build_stream(dataclasses.replace(NET_TINY, dtype=dtype), 1, 3, 4, window, device, seed=20)
    if state_dict is not None:
        stream.model.net.load_state_dict(state_dict)
    rng = np.random.default_rng(0)
    emb = torch.from_numpy((rng.standard_normal((1, 8, 1024)) * 0.05).astype(np.float32)).to(device)
    init = torch.from_numpy(rng.standard_normal((1, 16, 1, 16, 24)).astype(np.float32)).to(device)
    draw = lambda step, shape: torch.from_numpy(np.random.default_rng(100 + step).standard_normal(shape).astype(np.float32))
    _build.reset_launch_counts()
    out = stream.generate(make_condition(emb), init, 6, (16, 24), draw=draw)
    counts = _build.launch_counts()
    return out.float().cpu(), counts, {k: v.cpu() for k, v in stream.model.net.state_dict().items()}


def small_stream_reference() -> None:
    """The small causal stream in bf16 on the card (K5, then K6 with 3 of 8
    rows) against the same weights, inputs and noise in fp32 on the CPU."""
    import torch

    for window in (-1, 3):
        got, counts, sd = small_stream("cuda", torch.bfloat16, window)
        ref, _, _ = small_stream("cpu", torch.float32, window, sd)
        max_abs, rel = errors(got, ref)
        cached = "flash_attention_kv_cache_window" if window > 0 else "flash_attention_kv_cache"
        log(f"  window {window}: card bf16 vs cpu fp32: shape {tuple(got.shape)} max_abs {max_abs:.3e} rel_l2 "
            f"{rel:.3e} (limit {STREAM_REL_L2}); launches {counts}")
        # per DiT forward: 2 cached self-attentions and 2 cross-attentions; 1 prefill + 5 x (4 steps + 1 commit)
        want = 2 * (1 + 5 * 5)
        if (counts[cached], counts["flash_attention_fwd"]) != (want, want):
            raise AssertionError(f"the small stream launched {counts}, want {cached} and K1 {want} times each")
        if not (got.shape == (1, 16, 6, 16, 24) and torch.isfinite(got).all() and rel <= STREAM_REL_L2):
            raise AssertionError(f"the small stream disagrees with its fp32 CPU reference: rel_l2 {rel:.3e}")


def interactive_slice(window: int, run_measure: bool) -> dict:
    """StreamingInference.generate with the full-width causal 2B DiT at
    352x640: one prefilled frame, INTERACTIVE_BLOCKS streamed one-frame
    blocks; checks, timings, peak memory and one profiled block step."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.scripts import interactive_latency as il

    h, w = INTERACTIVE_HW
    tpf = (h // 2) * (w // 2)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    stream = il.build_stream(il.NET_2B, 1, INTERACTIVE_CACHE_FRAMES, INTERACTIVE_STEPS, window, "cuda", seed=0)
    net = stream.model.config.net
    if (net.num_blocks, net.model_channels, net.num_heads, net.head_dim) != (NUM_BLOCKS, 2048, 16, 128):
        raise AssertionError("the interactive slice must run the full-width causal 2B DiT")
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - base
    log(f"  causal 2B DiT built in {time.perf_counter() - t0:.1f} s: {weights / 2**30:.2f} GiB of weights "
        f"(matmul weights bf16, AdaLN fp32); window {window if window > 0 else 'dense'}")
    cond = il.text_condition(stream, "cuda")
    init = torch.randn((1, 16, 1, h, w), generator=torch.Generator(device="cuda").manual_seed(2), device="cuda")
    s_max = (INTERACTIVE_CACHE_FRAMES + 1) * tpf
    cache_bytes = NUM_BLOCKS * 2 * 16 * s_max * 128 * 2
    laps, lens, state = [], [], {}

    def on_block(step, x, caches):
        torch.cuda.synchronize()
        now = time.perf_counter()
        laps.append(now - state["t"])
        state["t"], state["caches"] = now, caches
        lens.append(sorted({c["len"] for c in caches}))

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    state["t"] = t_all = time.perf_counter()
    out = stream.generate(cond, init, 1 + INTERACTIVE_BLOCKS, (h, w),
                          generator=torch.Generator(device="cuda").manual_seed(3), on_block=on_block)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t_all
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base

    cached = "flash_attention_kv_cache_window" if window > 0 else "flash_attention_kv_cache"
    other = "flash_attention_kv_cache" if window > 0 else "flash_attention_kv_cache_window"
    want = NUM_BLOCKS + INTERACTIVE_BLOCKS * (INTERACTIVE_STEPS + 1) * NUM_BLOCKS
    got = (counts[cached], counts["flash_attention_fwd"], counts[other])
    if got != (want, want, 0):
        raise AssertionError(f"launches {cached}, K1, {other}: {got}, want ({want}, {want}, 0)")
    if out.shape != (1, 16, 1 + INTERACTIVE_BLOCKS, h, w) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"streamed latents {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    want_lens = [[min(1 + s, INTERACTIVE_CACHE_FRAMES) * tpf] for s in range(1, INTERACTIVE_BLOCKS + 1)]
    if lens != want_lens:
        raise AssertionError(f"cache lengths after each block {lens}, want {want_lens}")
    slides = sum(1 + s > INTERACTIVE_CACHE_FRAMES for s in range(1, INTERACTIVE_BLOCKS + 1))
    if peak - weights > 1.25 * cache_bytes:
        raise AssertionError(f"peak {peak / 2**30:.2f} GiB over {weights / 2**30:.2f} GiB of weights: more than one "
                             f"copy of the {cache_bytes / 2**30:.2f} GiB cache")
    p50 = float(np.median(laps[1:]))  # laps[0] holds the prefill and the first block's warm-up
    log(f"  streamed {INTERACTIVE_BLOCKS} blocks in {total_s:.2f} s ({slides} slides); first block with the prefill "
        f"{laps[0] * 1e3:.1f} ms; p50 block latency {p50 * 1e3:.1f} ms (min {min(laps[1:]) * 1e3:.1f}, max "
        f"{max(laps[1:]) * 1e3:.1f}) -> {1 / p50:.2f} latent frames/s = {4 / p50:.1f} pixel fps; launches {cached} "
        f"{counts[cached]}, K1 {counts['flash_attention_fwd']}; peak device memory {peak / 2**30:.2f} GiB over the "
        f"start = weights {weights / 2**30:.2f} + cache {cache_bytes / 2**30:.2f} GiB (bf16, 28 x k/v (1, 16, "
        f"{s_max}, 128)) + {(peak - weights - cache_bytes) / 2**30:.2f} GiB")

    # steady-state block steps (the cache full: 16 frames + the block): the
    # host's time to queue one (nothing in it waits for the card) against
    # the time until the card has run it; then one under torch.profiler
    caches = state.pop("caches")
    noise = torch.randn((1, 16, 1, h, w), device="cuda")
    queued, done = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        stream.generate_block(noise, cond, caches, 1 + INTERACTIVE_BLOCKS)
        queued.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        done.append(time.perf_counter() - t)
    queued_s, done_s = float(np.median(queued)), float(np.median(done))
    log(f"  block step at full cache: queued by the host in {queued_s * 1e3:.1f} ms, run by the card "
        f"{done_s * 1e3:.1f} ms after its start (medians of 3)")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        stream.generate_block(noise, cond, caches, 1 + INTERACTIVE_BLOCKS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    log(f"  one block step at full cache ({INTERACTIVE_STEPS} denoise forwards + 1 commit):")
    profile = device_time_table(prof, wall)
    del stream, caches, cond, out, prof
    result = {"counts": counts, "p50_s": p50, "latent_fps": 1 / p50, "pixel_fps": 4 / p50, "laps": laps,
              "queued_s": queued_s, "done_s": done_s,
              "total_s": total_s, "peak_gb": peak / 2**30, "weights_gb": weights / 2**30,
              "cache_gb": cache_bytes / 2**30, "profile": profile}
    if run_measure:
        gc.collect()
        torch.cuda.empty_cache()
        result["measure"] = il.measure(INTERACTIVE_HW, 8, INTERACTIVE_CACHE_FRAMES,
                                       cache_window_rows=window, device="cuda")
    return result


# ------------------------- K9: fused forward mode -------------------------


def jvp_plain_by_heads(q, k, v, dq, dk, dv, fg, heads_per_chunk: int = 4):
    """K9's plain version, a few heads at a time: whole, it would hold five
    (B, H, S, S) fp32 tensors (~22 GB at S8320 H16)."""
    import torch

    from cosmos_predict2_tpu_torch.ops.flash_attention_jvp import flash_attention_jvp_plain

    outs = [flash_attention_jvp_plain(*(t[:, :, h:h + heads_per_chunk].contiguous() for t in (q, k, v, dq, dk, dv)), fg)
            for h in range(0, q.shape[2], heads_per_chunk)]
    return torch.cat([o for o, _ in outs], dim=2), torch.cat([d for _, d in outs], dim=2)


def sdpa_jvp_yardstick(q, k, v, dq, dk, dv, mask):
    """torch.func.jvp of scaled_dot_product_attention (BHSD views), the
    first backend that takes it: (ms or the reasons, backend name)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    prim = tuple(t.transpose(1, 2) for t in (q, k, v))
    tang = tuple(t.transpose(1, 2) for t in (dq, dk, dv))
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(a, b, c, attn_mask=mask)  # noqa: E731
    fn = lambda: torch.func.jvp(sdpa, prim, tang)  # noqa: E731
    reasons = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.MATH):
        with sdpa_kernel(backend):
            ms = yardstick_ms(fn)
        if not isinstance(ms, str):
            return ms, backend.name
        reasons.append(f"{backend.name} {ms}")
    return "; ".join(reasons), None


def check_jvp_kernel(gen, record, failures) -> None:
    """K9 against its plain version (fp32, by heads) at four
    cases; beside it K1 at the same shape and the SDPA jvp yardstick."""
    import torch

    from cosmos_predict2_tpu_torch.ops.flash_attention import flash_attention_fwd
    from cosmos_predict2_tpu_torch.ops.flash_attention_jvp import flash_attention_jvp

    dev = torch.device("cuda")
    # (label, S, frame_group, inputs with a tangent); case 3 has a kv tail (1000 = 15 x 64 + 40)
    cases = [
        ("B1 S8320 H16 (fa_jvp shape)", 8320, 0, "qkv"),
        ("B1 S5760 H16 (smoke self-attention)", 5760, 0, "qkv"),
        ("B1 S1000 H16 frame_group=256 (kv tail)", 1000, 256, "qkv"),
        ("B1 S5760 H16 dv only", 5760, 0, "v"),
    ]
    B, H = 1, 16
    for label, S, fg, tangents in cases:
        q, k, v = (torch.randn((B, S, H, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
        dq, dk, dv = (torch.randn((B, S, H, 128), generator=gen, device=dev).to(torch.bfloat16) if name in tangents
                      else torch.zeros_like(x) for name, x in zip("qkv", (q, k, v)))
        o, do = flash_attention_jvp(q, k, v, dq, dk, dv, fg)
        # no atomics: a second call gives the same bits
        repeat = flash_attention_jvp(q, k, v, dq, dk, dv, fg)
        torch.cuda.synchronize()
        if not (torch.equal(o, repeat[0]) and torch.equal(do, repeat[1])):
            failures.append(f"flash_attention_jvp {label}: two calls differ")
        del repeat
        ref_o, ref_do = jvp_plain_by_heads(q, k, v, dq, dk, dv, fg)
        (o_abs, o_rel), (do_abs, do_rel) = errors(o, ref_o), errors(do, ref_do)
        del ref_o, ref_do
        plain_ms = cuda_ms(lambda: jvp_plain_by_heads(q, k, v, dq, dk, dv, fg), 0, 1)
        ms = cuda_ms(lambda: flash_attention_jvp(q, k, v, dq, dk, dv, fg), 1, 5)
        k1_ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, frame_group=fg), 1, 5)
        mask = None
        if fg > 0:
            mask = (torch.arange(S, device=dev)[None, :] // fg) <= (torch.arange(S, device=dev)[:, None] // fg)
        library_ms, backend = sdpa_jvp_yardstick(q, k, v, dq, dk, dv, mask)
        bnd = bound(12 * B * H * visible_pairs(S, S, fg) * 128, 2 * 8 * q.numel())
        record("flash_attention_jvp", label, max(o_abs, do_abs), max(o_rel, do_rel), ms, plain_ms, library_ms, bnd,
               o_rel_l2=f"{o_rel:.3e}", do_rel_l2=f"{do_rel:.3e}", k1_ms=k1_ms, library_backend=backend)
        if not bool(torch.isfinite(do.float()).all()):
            failures.append(f"flash_attention_jvp {label}: non-finite tangent")
        del q, k, v, dq, dk, dv, o, do, mask
        torch.cuda.empty_cache()


def fwdmode_slice() -> dict:
    """The op under both forward-mode APIs on card tensors at the smoke
    self-attention shape: one K1 and one K9 each, against the plain version."""
    import torch
    import torch.autograd.forward_ad as fwAD

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.ops.flash_attention_jvp import flash_attention_fwdmode

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, dq, dk, dv = (torch.randn((1, 5760, 16, 128), generator=gen, device="cuda").to(torch.bfloat16)
                           for _ in range(6))
    ref_o, ref_do = jvp_plain_by_heads(q, k, v, dq, dk, dv, 0)
    _build.reset_launch_counts()
    results = {}
    for api in ("torch.func.jvp", "forward_ad"):
        before = _build.launch_counts()
        if api == "torch.func.jvp":
            o, do = torch.func.jvp(flash_attention_fwdmode, (q, k, v), (dq, dk, dv))
        else:
            with fwAD.dual_level():
                o, do = fwAD.unpack_dual(flash_attention_fwdmode(*(fwAD.make_dual(p, t)
                                                                   for p, t in zip((q, k, v), (dq, dk, dv)))))
        torch.cuda.synchronize()
        after = _build.launch_counts()
        got = {n: after[n] - before[n] for n in ("flash_attention_fwd", "flash_attention_jvp")}
        (_, o_rel), (_, do_rel) = errors(o, ref_o), errors(do, ref_do)
        log(f"  {api}: launches {got}; o rel_l2 {o_rel:.3e}, do rel_l2 {do_rel:.3e} (limit {KERNEL_REL_L2})")
        if got != {"flash_attention_fwd": 1, "flash_attention_jvp": 1}:
            raise AssertionError(f"{api} of flash_attention_fwdmode launched {got}, want one K1 and one K9")
        if not (o_rel <= KERNEL_REL_L2 and do_rel <= KERNEL_REL_L2):
            raise AssertionError(f"{api} of flash_attention_fwdmode disagrees with the plain version")
        results[api] = {"o_rel_l2": o_rel, "do_rel_l2": do_rel}
    return {"counts": _build.launch_counts(), **results}


def fa_jvp_slice() -> dict:
    """scripts/fa_jvp.py's run as a user calls it: B1 S8320 H16, 1 + 1 + 20
    jvp calls (the checked call, the slice, the timed ones)."""
    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.scripts import fa_jvp

    _build.reset_launch_counts()
    result = fa_jvp.run("cuda")
    counts = _build.launch_counts()
    want = 1 + 1 + 20
    if (counts["flash_attention_fwd"], counts["flash_attention_jvp"]) != (want, want):
        raise AssertionError(f"fa_jvp launched {counts}, want K1 and K9 {want} times each")
    if not (result["o_rel_l2"] <= KERNEL_REL_L2 and result["do_rel_l2"] <= KERNEL_REL_L2):
        raise AssertionError(f"fa_jvp's slice disagrees with the fp32 plain version: {result}")
    return {"counts": counts, **result}


# ------------------------------- DMD2 serving -------------------------------


def dmd2_serve_slice() -> dict:
    """One DMD2 request through the Inference API on the full-width 2B
    student (seeded random weights): an image-conditioned Video2World
    request, 93 frames at 192x320, 4 TrigFlow steps, batch 1, no CFG."""
    import torch
    from PIL import Image

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.inference.api import Inference, InferenceArguments
    from cosmos_predict2_tpu_torch.inference.pipeline import InferenceSetup, Video2WorldInference
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae

    cfg = make_config(DMD2_EXPERIMENT)
    mc = cfg.model
    if (mc.net.num_blocks, mc.net.model_channels, mc.sampling_num_steps) != (NUM_BLOCKS, 2048, 4):
        raise AssertionError("the DMD2 slice must run the full-width 2B student with 4 steps")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = build_dit(mc.net, "cuda", seed=0)
    vae = build_vae(cfg.tokenizer, "cuda", seed=1)
    pipe = Video2WorldInference(InferenceSetup(model_config=mc, vae_config=cfg.tokenizer, size_override=SIZE), net, vae)
    out_dir = OUT_DIR / "dmd2"
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(3)
    H, W = SIZE
    Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(out_dir / "input.png")
    np.save(out_dir / "prompt.npy", rng.standard_normal((1, 512, mc.net.crossattn_proj_in_channels)).astype(np.float32))
    request = InferenceArguments(name="dmd2_request", prompt="p", input_path=str(out_dir / "input.png"),
                                 num_steps=mc.sampling_num_steps, sampler="dmd2", seed=1,
                                 text_embedding_path=str(out_dir / "prompt.npy"))
    frames = []
    generate = pipe.generate_vid2world
    pipe.generate_vid2world = lambda *a, **kw: frames.append(generate(*a, **kw)) or frames[-1]  # keep the frames

    api = Inference(pipe, output_dir=str(out_dir), keep_going=False)
    export_s = []
    finish = api._finish

    def timed_finish(*a):  # the media export (mp4, or a gif where no video codec is installed)
        t = time.perf_counter()
        path = finish(*a)
        export_s.append(time.perf_counter() - t)
        return path

    api._finish = timed_finish
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    (path,) = api.generate([request])
    request_s = time.perf_counter() - t
    counts = _build.launch_counts()
    tm = pipe.last_timings
    want = 4 * 2 * NUM_BLOCKS  # 4 forwards of batch 1, 28 self- and 28 cross-attentions each
    pipeline_s = tm["vae_encode_s"] + tm["denoise_s"] + tm["vae_decode_s"]
    log(f"  dmd2 request ({mc.sampling_num_steps} steps, no CFG): {request_s:.2f} s through Inference = pipeline "
        f"{pipeline_s:.2f} s (vae_encode {tm['vae_encode_s']:.2f} s, denoise {tm['denoise_s']:.2f} s = "
        f"{tm['denoise_step_s'] * 1e3:.1f} ms/step, vae_decode {tm['vae_decode_s']:.2f} s) + export "
        f"{export_s[0]:.2f} s ({path}) + input and text {request_s - pipeline_s - export_s[0]:.2f} s; "
        f"launches {counts}")
    if counts["flash_attention_fwd"] != want or counts["conv3d_causal"] == 0:
        raise AssertionError(f"the dmd2 request launched {counts}, want K1 {want} times and K2")
    if counts["flash_attention_jvp"] != 0:
        raise AssertionError("the dmd2 request launched K9")
    (video,) = frames
    if video.shape != (NUM_FRAMES, H, W, 3) or video.dtype != np.uint8 or video.std() == 0:
        raise AssertionError(f"dmd2 output {video.shape} {video.dtype}, std {video.std()}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # a denoise step's device work: one DiT forward at batch 1 (no CFG) under torch.profiler
    x = torch.randn((1, mc.state_ch, (NUM_FRAMES - 1) // 4 + 1, H // 8, W // 8), device="cuda")
    ctx = torch.from_numpy(np.load(out_dir / "prompt.npy")).cuda()
    ts = torch.full((1, x.shape[2]), 500.0, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        net(x, ts, ctx)
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            net(x, ts, ctx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    log("  one DiT forward of the dmd2 student (batch 1, 5,760 tokens):")
    profile = device_time_table(prof, wall)
    del pipe, net, vae, api
    return {"counts": counts, "request_s": request_s, "pipeline_s": pipeline_s, "export_s": export_s[0], **tm,
            "peak_gb": peak_gb, "profile": profile}


# ----------------------------- DMD2 distillation -----------------------------


def small_distill_steps(device: str, dtype, state_dicts=None):
    """A student step and a critic step of a narrow DMD2 distillation (2B
    experiment, 2 blocks of 256 channels, head_dim 128; 2 sampler steps)
    with fixed weights, inputs and draws. Returns ({phase: (loss, {name:
    grad fp32 on the CPU})}, launches per phase, state dicts)."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import get_condition_uncondition, make_condition
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.distillation import DistillationConfig, DistillationModel
    from cosmos_predict2_tpu_torch.networks.dit import build_dit

    cfg = make_config(DMD2_EXPERIMENT)
    net_cfg = dataclasses.replace(cfg.model.net, model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32,
                                  crossattn_proj_in_channels=64, crossattn_emb_channels=128, dtype=dtype)
    nets = [build_dit(net_cfg, device, seed=10 + i, trainable=i != 1) for i in range(3)]  # student, teacher, fake
    if state_dicts is not None:
        for net, sd in zip(nets, state_dicts):
            net.load_state_dict(sd)
    student, teacher, fake = nets
    dm = DistillationModel(DistillationConfig(model=dataclasses.replace(cfg.model, net=net_cfg, state_t=4)))
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((1, 16, 4, 16, 24)).astype(np.float32)).to(device)
    emb = torch.from_numpy(rng.standard_normal((1, 32, 64)).astype(np.float32)).to(device)
    cond, uncond = get_condition_uncondition(make_condition(emb).replace(gt_frames=x0).set_video_condition(x0, 1))
    draws = dm.sample_distill_draws(torch.Generator().manual_seed(0), tuple(x0.shape)).to(device)
    out, counts = {}, {}
    for phase, net in (("student", student), ("critic", fake)):
        _build.reset_launch_counts()
        if phase == "student":
            loss, _ = dm.training_step_generator(student, teacher, fake, x0, cond, uncond, 2, draws)
        else:
            loss, _ = dm.training_step_critic(student, fake, x0, cond, 2, draws)
        loss.backward()
        counts[phase] = _build.launch_counts()
        out[phase] = (float(loss.detach()), {n: p.grad.float().cpu() for n, p in net.named_parameters()})
        net.zero_grad(set_to_none=True)
    return out, counts, [{k: v.cpu() for k, v in n.state_dict().items()} for n in nets]


def small_distill_reference() -> None:
    """The small distillation steps in bf16 on the card (K1, K7, K8) against
    the same weights and draws in fp32 on the CPU, under the training bounds."""
    import torch

    got, counts, sds = small_distill_steps("cuda", torch.bfloat16)
    ref, _, _ = small_distill_steps("cpu", torch.float32, sds)
    for phase in ("student", "critic"):
        (loss, grads), (ref_loss, ref_grads) = got[phase], ref[phase]
        num = sum(float((grads[n] - g).norm()) ** 2 for n, g in ref_grads.items()) ** 0.5
        den = sum(float(g.norm()) ** 2 for g in ref_grads.values()) ** 0.5
        worst = max((float((grads[n] - g).norm() / g.norm().clamp_min(1e-30)), n) for n, g in ref_grads.items())
        loss_rel = abs(loss / ref_loss - 1)
        log(f"  {phase}: card bf16 loss {loss:.6f} vs cpu fp32 {ref_loss:.6f}: rel {loss_rel:.3e} (limit "
            f"{TRAIN_LOSS_REL}); gradients rel_l2 {num / den:.3e} (limit {TRAIN_GRAD_REL_L2}), worst parameter "
            f"{worst[0]:.3e} {worst[1]} (limit {TRAIN_GRAD_TENSOR_REL_L2}); launches {counts[phase]}")
        # 2 blocks: 4 attention calls per forward; 2 sampler steps (the student's last recomputed under
        # remat) or 2 sampler steps and the fake-score forward (recomputed); the student phase adds
        # the fake-score and teacher forwards
        k1 = 4 * (2 + 1) + (8 if phase == "student" else 4)
        want = {"flash_attention_fwd": k1, "flash_attention_bwd_dq": 4, "flash_attention_bwd_dkv": 4,
                "flash_attention_jvp": 0}
        if {k: counts[phase][k] for k in want} != want:
            raise AssertionError(f"the small {phase} step launched {counts[phase]}, want {want}")
        if not (all(torch.isfinite(g).all() for g in grads.values()) and loss_rel <= TRAIN_LOSS_REL
                and num / den <= TRAIN_GRAD_REL_L2 and worst[0] <= TRAIN_GRAD_TENSOR_REL_L2):
            raise AssertionError(f"the small {phase} step on the card disagrees with its fp32 CPU reference")


class DistillProbe:
    """Distillation callback: per iteration the phase, n, loss, timings,
    launches, peak memory and which nets' watched parameters changed;
    torch.profiler around the iteration numbered ``profile_step``."""

    WATCH = TrainProbe.WATCH
    NETS = ("student", "teacher", "fake_score")

    def __init__(self, profile_step: int):
        self.steps, self.profile_step, self.profile = [], profile_step, None

    def snapshot(self, state):
        out = {}
        for net in self.NETS:
            params = dict(getattr(state, net).named_parameters())
            out[net] = {n: params[n].detach().clone() for n in self.WATCH}
        return out

    def on_train_start(self, trainer, state): ...

    def on_training_step_start(self, trainer, state, batch, iteration):
        import torch

        from cosmos_predict2_tpu_torch import _build

        self.before = self.snapshot(state)
        self.counts0 = _build.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        if iteration + 1 == self.profile_step:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def on_training_step_end(self, trainer, state, metrics, iteration):
        import torch

        from cosmos_predict2_tpu_torch import _build

        counts = {k: v - self.counts0[k] for k, v in _build.launch_counts().items()}
        if iteration == self.profile_step:
            self._prof.__exit__(None, None, None)
            log(f"  iteration {iteration} ({metrics['phase']}, n={metrics['n_steps']}) under torch.profiler:")
            self.profile = device_time_table(self._prof, trainer.last_timings["step_s"])
        after = self.snapshot(state)
        changed = sorted(net for net in self.NETS
                         if any(not torch.equal(after[net][n], self.before[net][n]) for n in self.WATCH))
        st = {"phase": metrics["phase"], "n_steps": metrics["n_steps"], "loss": float(metrics["loss"]),
              "grad_norm": float(metrics["grad_norm"]), "counts": counts, "changed": changed,
              "peak_gb": torch.cuda.max_memory_allocated() / 2**30, **trainer.last_timings}
        self.steps.append(st)
        log(f"  iteration {iteration} [{st['phase']}, n={st['n_steps']}]: loss {st['loss']:.4f} grad_norm "
            f"{st['grad_norm']:.3e} step {st['step_s']:.3f} s (fwd+bwd {st['forward_backward_s']:.3f}, optimizer "
            f"{st['optimizer_s']:.3f}); peak {st['peak_gb']:.2f} GiB; changed {changed}; launches {counts}")

    def on_save_checkpoint(self, trainer, state, iteration): ...

    def on_train_end(self, trainer, state): ...


def distill_slice() -> dict:
    """DMD2 distillation of the full-width 2B student: student, frozen
    teacher and fake-score nets (seeded random weights, fp32), mock data at
    93 frames 192x320 encoded by the VAE, batch 1, block remat, 5 iterations
    (student_update_freq 5: 4 critic steps, then 1 student step)."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.distillation import DistillationConfig, DistillationModel
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae
    from cosmos_predict2_tpu_torch.training.distill_trainer import DistillationTrainer, DistillTrainerConfig
    from cosmos_predict2_tpu_torch.training.train import latent_batches, make_loader

    H, W = SIZE
    cfg = make_config(DMD2_EXPERIMENT, [
        f"data_train.num_frames={NUM_FRAMES}", f"data_train.height={H}", f"data_train.width={W}",
        "data_train.text_dim=100352", "data_train.batch_size=1",
    ])
    net_cfg = cfg.model.net
    if (net_cfg.num_blocks, net_cfg.model_channels, net_cfg.remat) != (NUM_BLOCKS, 2048, "block"):
        raise AssertionError("the distillation slice must run the full-width 2B DiT with block remat")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    log(f"  device memory in use before the slice: {base / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    student, teacher, fake = (build_dit(net_cfg, "cuda", seed=i, trainable=i != 1) for i in range(3))
    vae = build_vae(cfg.tokenizer, "cuda", seed=3)
    model = DistillationModel(DistillationConfig(model=cfg.model, student_update_freq=5))
    probe = DistillProbe(profile_step=DISTILL_PROFILE_STEP)
    trainer = DistillationTrainer(DistillTrainerConfig(max_iter=DISTILL_ITERS, logging_iter=1), model,
                                  callbacks=[probe])
    state = trainer.init_state(student, teacher, fake)
    torch.cuda.synchronize()
    nets_gb = (torch.cuda.memory_allocated() - base) / 2**30
    log(f"  three 2B DiTs (fp32) and the VAE built in {time.perf_counter() - t0:.1f} s: {nets_gb:.2f} GiB")

    def batches():
        for x0, cond in latent_batches(make_loader(cfg.data_train), vae, torch.device("cuda")):
            yield x0, cond.set_video_condition(x0, 1)

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.train(state, batches())
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    steps = probe.steps
    phases = [s["phase"] for s in steps]
    if phases != ["critic"] * 4 + ["student"] or state.step != DISTILL_ITERS:
        raise AssertionError(f"phases {phases}, want 4 critic steps and 1 student step")
    host = np.random.RandomState(0)
    if [s["n_steps"] for s in steps] != [int(host.randint(0, 4)) + 1 for _ in range(DISTILL_ITERS)]:
        raise AssertionError("the sampler steps are not the host RandomState(0)'s draws")
    for i, s in enumerate(steps):
        if not (np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])):
            raise AssertionError(f"iteration {i}: non-finite loss or gradient norm")
        if s["changed"] != (["student"] if s["phase"] == "student" else ["fake_score"]):
            raise AssertionError(f"iteration {i} ({s['phase']}) changed {s['changed']}")
        n = s["n_steps"]
        # per DiT forward 56 K1 (28 self, 28 cross); the graph-recording forward once more for remat;
        # the student phase adds the fake-score and teacher forwards
        k1 = 2 * NUM_BLOCKS * (n + 1) + (2 * 2 * NUM_BLOCKS if s["phase"] == "student" else 2 * NUM_BLOCKS)
        want = {"flash_attention_fwd": k1, "flash_attention_bwd_dq": 2 * NUM_BLOCKS,
                "flash_attention_bwd_dkv": 2 * NUM_BLOCKS, "flash_attention_jvp": 0}
        if {k: s["counts"][k] for k in want} != want:
            raise AssertionError(f"iteration {i} ({s['phase']}, n={n}) launched {s['counts']}, want {want}")
    if counts["conv3d_causal"] == 0:
        raise AssertionError("conv3d_causal never ran in the distillation slice's VAE encode")
    peak_gb = max(s["peak_gb"] for s in steps)
    by_phase = {}
    for phase in ("critic", "student"):
        mine = [s for s in steps if s["phase"] == phase]
        by_phase[phase] = {"step_s": [s["step_s"] for s in mine], "n_steps": [s["n_steps"] for s in mine],
                           "peak_gb": max(s["peak_gb"] for s in mine)}
    log(f"  {DISTILL_ITERS} iterations in {total_s:.1f} s (with the host's mock data and VAE encode); peak device "
        f"memory {peak_gb:.2f} GiB of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}; by phase "
        f"{by_phase}")
    del state, trainer, student, teacher, fake, vae
    return {"counts": counts, "steps": steps, "peak_gb": peak_gb, "nets_gb": nets_gb, "total_s": total_s,
            "by_phase": by_phase, "profile": probe.profile}


# ------------------------- the base family's serving surface -------------------------


def fresh_memory() -> None:
    """Free what earlier phases left and start a new peak."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def check_launches(name: str, counts: dict, k1: int | None) -> None:
    """K1 exactly ``k1`` times (any number when None) and K2 at least once;
    no other kernel."""
    other = {k: v for k, v in counts.items() if k not in ("flash_attention_fwd", "conv3d_causal") and v}
    if (k1 is not None and counts["flash_attention_fwd"] != k1) or counts["conv3d_causal"] == 0 or other:
        raise AssertionError(f"the {name} path launched {counts}; want K1 {k1 if k1 is not None else '> 0'} times, "
                             f"K2 and nothing else")


def released_slice() -> dict:
    """A synthetic released checkpoint at the true 2B shapes, by name: write
    it (patterned bf16 tensors under ``net_ema.``, and the seeded random VAE),
    register it in the checkpoint DB under the Index-26 resume2 experiment,
    load it with load_model_from_checkpoint by its DB name (every weight
    bit-equal to the file's), then the port's verifier writes a golden and
    meets it."""
    import contextlib
    import io

    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.configs.released_experiments import INDEX_26_RESUME2
    from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT
    from cosmos_predict2_tpu_torch.scripts import verify_released_weights as vrw
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae
    from cosmos_predict2_tpu_torch.utils import checkpoint_db as db
    from cosmos_predict2_tpu_torch.utils.checkpoint_export import (
        export_dit_state_dict, export_vae_state_dict, patterned_like, save_torch_state_dict,
    )
    from cosmos_predict2_tpu_torch.utils.model_loader import load_model_from_checkpoint

    cfg = make_config(INDEX_26_RESUME2)
    net_cfg = cfg.model.net
    if (net_cfg.model_channels, net_cfg.num_blocks, net_cfg.num_heads, net_cfg.head_dim) != (2048, NUM_BLOCKS, 16, 128):
        raise AssertionError("the released slice must write the full-width 2B DiT")
    out_dir = OUT_DIR / "released"
    out_dir.mkdir(parents=True, exist_ok=True)
    dit_path, vae_path, golden = out_dir / "synthetic_ema_bf16.pt", out_dir / "synthetic_vae.pth", out_dir / "golden.npz"
    fresh_memory()
    with torch.device("meta"):
        template = export_dit_state_dict(MiniTrainDIT(net_cfg), prefix="net_ema.")
    t = time.perf_counter()
    written = patterned_like(template, salt=26, dtype=torch.bfloat16, device="cuda")
    save_torch_state_dict(written, str(dit_path))
    save_torch_state_dict(export_vae_state_dict(build_vae(cfg.tokenizer, "cuda", seed=1)), str(vae_path))
    write_s = time.perf_counter() - t
    n = sum(v.numel() for v in written.values())
    log(f"  wrote {n / 1e9:.3f} B bf16 DiT weights under net_ema. ({dit_path.stat().st_size / 2**30:.2f} GiB) "
        f"and the VAE in {write_s:.1f} s")
    name = "chip_smoke/Cosmos-Predict2.5-2B/base/synthetic"
    db.register_checkpoint(db.CheckpointEntry(uuid="00000000-chip-smoke-2b-synthetic", name=name,
                                              experiment=INDEX_26_RESUME2, uri=str(dit_path)))
    if db.get_checkpoint_path(name) != str(dit_path) or db.find_by_experiment(INDEX_26_RESUME2).name != name:
        raise AssertionError("the checkpoint DB does not resolve the synthetic checkpoint")

    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    pipe, _ = load_model_from_checkpoint(INDEX_26_RESUME2, name, str(vae_path), size_override=SIZE, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    load_peak_gb = (torch.cuda.max_memory_allocated() - base) / 2**30
    bad = [k for k, v in pipe.net.state_dict().items() if not torch.equal(v, written["net_ema." + k].to(v.dtype))
           or not torch.equal(v.to(torch.bfloat16), written["net_ema." + k])]
    if bad or len(pipe.net.state_dict()) != len(written):
        raise AssertionError(f"{len(bad)} loaded weights differ from the file's, e.g. {bad[:3]}")
    log(f"  load_model_from_checkpoint({INDEX_26_RESUME2[:40]}..., '{name}'): {load_s:.2f} s, peak device memory "
        f"{load_peak_gb:.2f} GiB over the start; all {len(written)} weights bit-equal to the file's")
    del pipe, written
    fresh_memory()

    runs = []
    t_all = time.perf_counter()
    for extra in (["--write-golden"], []):
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = vrw.main(["--checkpoint", name, "--vae", str(vae_path), "--golden", str(golden), *extra])
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        runs.append({"rc": rc, **line, "s": time.perf_counter() - t})
        log(f"  verifier {' '.join(extra) or '(verify)'}: rc {rc} in {runs[-1]['s']:.1f} s: {line}")
    verify_s = time.perf_counter() - t_all
    counts = _build.launch_counts()
    written_ok, verified = runs
    if not (written_ok["rc"] == 0 and written_ok.get("golden_written")):
        raise AssertionError(f"the verifier did not write its golden: {written_ok}")
    if not (verified["rc"] == 0 and verified["ok"] and verified["psnr_db"] >= 35 and verified["decoded"]):
        raise AssertionError(f"the verifier did not meet its golden at 35 dB: {verified}")
    # two runs of 2 steps, one batched-CFG forward each, 2 x 28 attention calls per forward
    check_launches("released", counts, 2 * 2 * 2 * NUM_BLOCKS)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for path in (dit_path, vae_path, golden):
        path.unlink()
    return {"counts": counts, "write_s": write_s, "load_s": load_s, "load_peak_gb": load_peak_gb,
            "verify_s": verify_s, "psnr_db": verified["psnr_db"], "peak_gb": peak_gb}


def _serving_pipe(experiment: str = DENSE_EXPERIMENT, **setup):
    """The full-width pipeline of ``experiment`` on seeded random weights,
    built by load_model_from_checkpoint at the smoke geometry."""
    import torch

    from cosmos_predict2_tpu_torch.utils.model_loader import load_model_from_checkpoint

    t = time.perf_counter()
    pipe, cfg = load_model_from_checkpoint(experiment, None, size_override=SIZE, device="cuda")
    pipe.setup = dataclasses.replace(pipe.setup, **setup)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in pipe.net.parameters())
    log(f"  {experiment}: {n / 1e9:.3f} B DiT params ({cfg.model.net.model_channels} channels, "
        f"{cfg.model.net.num_blocks} blocks, {cfg.model.net.num_heads} heads), VAE dim {cfg.tokenizer.dim}: "
        f"built in {time.perf_counter() - t:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return pipe, cfg


def _request_files(out_dir: Path, cfg, seed: int) -> tuple[str, str]:
    """An input image at the smoke geometry and a 512-token text embedding."""
    from PIL import Image

    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, SIZE + (3,), dtype=np.uint8)).save(out_dir / "input.png")
    np.save(out_dir / "prompt.npy", rng.standard_normal((1, 512, cfg.model.net.crossattn_proj_in_channels)).astype(np.float32))
    return str(out_dir / "input.png"), str(out_dir / "prompt.npy")


def _timed_api(pipe, out_dir: Path):
    """An Inference over ``pipe`` whose media export is timed apart."""
    from cosmos_predict2_tpu_torch.inference.api import Inference

    api = Inference(pipe, output_dir=str(out_dir), keep_going=False)
    export_s, finish = [], api._finish

    def timed_finish(*a):
        t = time.perf_counter()
        path = finish(*a)
        export_s.append(time.perf_counter() - t)
        return path

    api._finish = timed_finish
    return api, export_s


def autoregressive_slice(pipe, cfg) -> dict:
    """One Image2World request through Inference with enable_autoregressive:
    181 frames at 192x320 in chunks of 93 sharing 2 latent frames (5 pixel
    frames), so two chunks of 35 UniPC steps with CFG 7."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.inference.api import InferenceArguments

    out_dir = OUT_DIR / "autoregressive"
    image, prompt = _request_files(out_dir, cfg, seed=5)
    chunks, generate, returned = [], pipe.generate_vid2world, []
    pipe.generate_vid2world = lambda window, *a, **kw: chunks.append((np.array(window), kw)) or returned.append(
        generate(window, *a, **kw)) or returned[-1]
    autoregressive = pipe.generate_autoregressive
    long_video = []
    pipe.generate_autoregressive = lambda *a, **kw: long_video.append(autoregressive(*a, **kw)) or long_video[-1]
    api, export_s = _timed_api(pipe, out_dir)
    request = InferenceArguments(name="autoregressive", prompt="p", input_path=image, text_embedding_path=prompt,
                                 num_steps=NUM_STEPS, guidance=GUIDANCE, seed=1, enable_autoregressive=True,
                                 chunk_size=AR_CHUNK, chunk_overlap=AR_OVERLAP, num_output_frames=AR_FRAMES)
    fresh_memory()
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    (path,) = api.generate([request])
    request_s = time.perf_counter() - t
    counts = _build.launch_counts()
    del pipe.generate_vid2world, pipe.generate_autoregressive
    (video,) = long_video
    overlap_px = (AR_OVERLAP - 1) * 4 + 1
    H, W = SIZE
    if video.shape != (AR_FRAMES, H, W, 3) or video.dtype != np.uint8 or video.std() == 0:
        raise AssertionError(f"autoregressive output {video.shape} {video.dtype} std {video.std()}")
    if [kw["num_conditional_frames"] for _, kw in chunks] != [1, AR_OVERLAP] or [kw["seed"] for _, kw in chunks] != [1, 2]:
        raise AssertionError(f"chunks conditioned on {[kw['num_conditional_frames'] for _, kw in chunks]} latent frames "
                             f"with seeds {[kw['seed'] for _, kw in chunks]}, want [1, {AR_OVERLAP}] and [1, 2]")
    conditioning = chunks[1][0][0, :, :overlap_px].transpose(1, 2, 3, 0)
    if not np.array_equal(conditioning, returned[0][-overlap_px:]):
        raise AssertionError("chunk 2's first conditioning frames are not chunk 1's last written-back frames")
    if not np.array_equal(video[:AR_CHUNK], returned[0]) or not np.array_equal(video[AR_CHUNK:], returned[1][overlap_px:]):
        raise AssertionError("the long video is not chunk 1 followed by chunk 2 past its overlap")
    check_launches("autoregressive", counts, 2 * NUM_STEPS * 2 * NUM_BLOCKS)
    tm = pipe.last_timings
    log(f"  {AR_FRAMES} frames in 2 chunks of {AR_CHUNK} (overlap {overlap_px} frames): {request_s:.2f} s through "
        f"Inference, of which export {export_s[0]:.2f} s ({path}); last chunk: vae_encode {tm['vae_encode_s']:.2f} s, "
        f"denoise {tm['denoise_s']:.2f} s ({tm['denoise_step_s'] * 1e3:.1f} ms/step), vae_decode {tm['vae_decode_s']:.2f} s;"
        f" chunk 2 opens on chunk 1's last {overlap_px} written-back frames; launches {counts}")
    return {"counts": counts, "request_s": request_s, "export_s": export_s[0], **tm,
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30}


def text2image_slice(pipe, cfg) -> dict:
    """One Text2Image request through Inference (mode="image") at the 720
    image bucket, 16:9 (1280x720): one latent frame of 45 x 80 tokens, 35
    UniPC steps with CFG 7, a png."""
    import torch
    from PIL import Image

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.inference.api import InferenceArguments
    from cosmos_predict2_tpu_torch.inference.pipeline import Video2WorldInference

    out_dir = OUT_DIR / "text2image"
    _, prompt = _request_files(out_dir, cfg, seed=6)
    pipe720 = Video2WorldInference(dataclasses.replace(pipe.setup, size_override=None, resolution="720"), pipe.net,
                                   pipe.vae)
    api, _ = _timed_api(pipe720, out_dir)
    fresh_memory()
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    (path,) = api.generate([InferenceArguments(name="text2image", prompt="p", text_embedding_path=prompt, mode="image",
                                               num_steps=NUM_STEPS, guidance=GUIDANCE, seed=1)])
    request_s = time.perf_counter() - t
    counts = _build.launch_counts()
    image = np.asarray(Image.open(path))
    if not path.endswith(".png") or image.shape != (720, 1280, 3) or image.std() == 0:
        raise AssertionError(f"text2image wrote {path} {image.shape} std {image.std()}, want a 720x1280x3 png")
    check_launches("text2image", counts, NUM_STEPS * 2 * NUM_BLOCKS)
    tm = api._t2i._v2w.last_timings
    log(f"  a 720x1280 png in {request_s:.2f} s through Inference: vae_encode {tm['vae_encode_s']:.2f} s, denoise "
        f"{tm['denoise_s']:.2f} s ({tm['denoise_step_s'] * 1e3:.1f} ms/step at 3,600 tokens), vae_decode "
        f"{tm['vae_decode_s']:.2f} s; launches {counts}")
    return {"counts": counts, "request_s": request_s, **tm, "peak_gb": torch.cuda.max_memory_allocated() / 2**30}


def oneshot_slice(pipe, cfg) -> dict:
    """The one-shot VAE route (streaming_vae=False): a 93-frame 192x320 clip
    through encode and decode whole against the streaming route on the same
    weights, then one Text2World request at 35 steps on the one-shot route."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.inference.pipeline import Video2WorldInference, video_to_input
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import (
        decode_oneshot, decode_streaming, encode_oneshot, encode_streaming,
    )

    H, W = SIZE
    rng = np.random.default_rng(7)
    clip = torch.from_numpy(video_to_input(rng.integers(0, 256, (9, H, W, 3), dtype=np.uint8), NUM_FRAMES, 2)).cuda()
    clip = clip.permute(0, 2, 3, 4, 1).contiguous()
    vae = pipe.vae
    routes = {}
    for route, enc, dec in (("streaming", encode_streaming, lambda z: decode_streaming(vae, z, 2, "uint8")),
                            ("one-shot", encode_oneshot, lambda z: decode_oneshot(vae, z, "uint8"))):
        fresh_memory()
        base = torch.cuda.memory_allocated()
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        z = enc(vae, clip, pixel_format="uint8")
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t
        px = dec(z)
        torch.cuda.synchronize()
        routes[route] = {"latents": z, "frames": px, "encode_s": t_enc, "decode_s": time.perf_counter() - t - t_enc,
                         "k2": _build.launch_counts()["conv3d_causal"],
                         "peak_gb": (torch.cuda.max_memory_allocated() - base) / 2**30}
    s, o = routes["streaming"], routes["one-shot"]
    _, lat_rel = errors(o["latents"], s["latents"])
    _, px_rel = errors(o["frames"], s["frames"])
    for route, r in routes.items():
        log(f"  {route:9s} VAE of {NUM_FRAMES} frames at {H}x{W}: encode {r['encode_s']:.2f} s, decode "
            f"{r['decode_s']:.2f} s, {r['k2']} K2 launches, peak {r['peak_gb']:.2f} GiB over the weights")
    log(f"  one-shot against streaming: latents rel_l2 {lat_rel:.3e} (limit {ONESHOT_LATENT_REL_L2}), uint8 frames "
        f"rel_l2 {px_rel:.3e} (limit {ONESHOT_FRAME_REL_L2})")
    if o["latents"].shape != s["latents"].shape or o["frames"].shape != (1, NUM_FRAMES, H, W, 3):
        raise AssertionError(f"one-shot shapes {tuple(o['latents'].shape)} {tuple(o['frames'].shape)}")
    if not (lat_rel <= ONESHOT_LATENT_REL_L2 and px_rel <= ONESHOT_FRAME_REL_L2) or o["k2"] == 0:
        raise AssertionError(f"the one-shot VAE disagrees with the streaming route or never ran K2: {lat_rel:.3e}, "
                             f"{px_rel:.3e}, {o['k2']} launches")
    del routes, s, o, clip

    oneshot = Video2WorldInference(dataclasses.replace(pipe.setup, streaming_vae=False), pipe.net, vae)
    emb = rng.standard_normal((1, 512, cfg.model.net.crossattn_proj_in_channels)).astype(np.float32)
    fresh_memory()
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    frames = oneshot.generate_vid2world(np.zeros((1, 3, NUM_FRAMES, H, W), np.uint8), emb, guidance=GUIDANCE,
                                        num_steps=NUM_STEPS, num_conditional_frames=0, seed=1, pixel_format="uint8")
    request_s = time.perf_counter() - t
    counts = _build.launch_counts()
    if frames.shape != (NUM_FRAMES, H, W, 3) or frames.dtype != np.uint8 or frames.std() == 0:
        raise AssertionError(f"one-shot text2world output {frames.shape} {frames.dtype}")
    check_launches("oneshot", counts, NUM_STEPS * 2 * NUM_BLOCKS)
    tm = oneshot.last_timings
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"  text2world on the one-shot route: {request_s:.2f} s: vae_encode {tm['vae_encode_s']:.2f} s, denoise "
        f"{tm['denoise_s']:.2f} s ({tm['denoise_step_s'] * 1e3:.1f} ms/step), vae_decode {tm['vae_decode_s']:.2f} s; "
        f"peak {peak_gb:.2f} GiB; launches {counts}")
    return {"counts": counts, "request_s": request_s, **tm, "peak_gb": peak_gb, "latent_rel_l2": lat_rel,
            "frame_rel_l2": px_rel}


# ------------- the serving front end with guardrails (phase 13a) -------------

GUARD_STEPS = 2  # a cut: phase 5 times 35-step requests at these shapes and kernels
GUARD_BLOCKED_PROMPT = "a beheading in the town square"
QWEN3GUARD_EOS = 151645  # Qwen3's <|im_end|>
# a cut: a verdict generates at most this many of the guard's 128 greedy
# tokens; each token is the same full 512-id forward (50-70 ms on an H100),
# and the seeded LM never ends a verdict early
QWEN3GUARD_TOKENS = 32
# the heads' last bias: class 0 ("Safe") or class 3 wins by this margin
# (the seeded heads' logits on normalized embeddings are ~1e-2)
SAFETY_BIAS = 10.0
NARROW_SIGLIP_LAYERS = 1  # the card-vs-CPU SigLIP: full width, 1 of 27 layers, fp32
# RetinaFace on one 192x320 frame, card fp32 (TF32 off) against CPU fp32:
# the same arithmetic in another order; 1e-6 relative L2 expected, 1e-4 allowed
RETINAFACE_REL_L2 = 1e-4


def vae_k2_launches(vae, frames: int, decode_chunk: int) -> int:
    """K2 launches of one sample's streaming encode and decode of a clip of
    ``frames`` (tokenizers/wan_vae_streaming.py): each causal 3x3x3 conv of
    the encoder / decoder that the kernel gate takes runs once per chunk,
    the encoder's chunks 1 + ceil((frames - 1) / 4), the decoder's 1 +
    ceil((t - 1) / decode_chunk) over the t latent frames; a batch's samples
    go through K2 one at a time, so a batch of B launches B times this."""
    import torch

    from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import _use_kernel_conv

    def gated(module) -> int:
        return sum(1 for m in module.modules() if isinstance(m, torch.nn.Conv3d)
                   and _use_kernel_conv(torch.empty((1, 3, 1, 1, m.weight.shape[1]), device="meta"), m))

    t = 1 + (frames - 1) // 4
    return gated(vae.encoder) * (1 + -(-(frames - 1) // 4)) + gated(vae.decoder) * (1 + -(-(t - 1) // decode_chunk))


def _http(port: int, path: str, payload=None, method: str | None = None):
    """(status, content type, body bytes) of one request to the local server."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _job(port: int, payload: dict) -> str:
    code, _, body = _http(port, "/generate", payload)
    if code != 200:
        raise AssertionError(f"POST /generate {payload.get('name')}: {code} {body[:200]!r}")
    return json.loads(body)["job_id"]


def _wait_job(port: int, job_id: str, states=("done", "error"), timeout: float = 600) -> dict:
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        status = json.loads(_http(port, f"/status/{job_id}")[2])
        if status["status"] in states:
            return status
        time.sleep(0.25)  # a poll takes the GIL from the worker's launches
    raise AssertionError(f"job {job_id} not {states} after {timeout} s")


def _decode_video(data: bytes, ctype: str) -> np.ndarray:
    """An mp4 or GIF served by /output -> (T, H, W, 3) uint8."""
    import io

    if ctype == "image/gif":
        from PIL import Image, ImageSequence

        return np.stack([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(Image.open(io.BytesIO(data)))])
    import imageio.v3 as iio

    return np.asarray(iio.imread(io.BytesIO(data), index=None, extension=".mp4"))


def _timed(fn, laps: list):
    """fn, its wall time per call appended to ``laps``."""

    def run(*a):
        t = time.perf_counter()
        out = fn(*a)
        laps.append(time.perf_counter() - t)
        return out

    return run


def guardrails_serving_slice(pipe, cfg, smi: str) -> dict:
    """The serving front end with the guardrails (A16): the guard towers at
    their released widths on seeded weights (Qwen3Guard-Gen-0.6B, SigLIP
    so400m with the 7-class safety head, RetinaFace-ResNet50), then
    ModelServer over Inference on the 2B pipeline of phases 11-13, spoken to
    over HTTP: a blocklisted prompt (no kernel), two same-key Image2World
    requests (by path and by upload) as one batched pass of GUARD_STEPS
    steps, the video guard's two outcomes decided by the head's weights;
    then the narrow card-vs-CPU checks."""
    import base64
    import threading

    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.inference.api import Inference
    from cosmos_predict2_tpu_torch.inference.serving import ModelServer
    from cosmos_predict2_tpu_torch.text_encoders.qwen import QwenConfig, build_qwen_lm
    from cosmos_predict2_tpu_torch.text_encoders.siglip_vision import (
        SigLIPVisionConfig,
        build_siglip_vision,
        make_frame_embedder,
        preprocess_siglip,
    )
    from cosmos_predict2_tpu_torch.utils import guardrails as G
    from cosmos_predict2_tpu_torch.utils.retinaface import RetinaFace, RetinaFaceDetector, build_retinaface

    H, W = SIZE
    out_dir = OUT_DIR / "guardrails"
    image, prompt = _request_files(out_dir, cfg, seed=61)
    fresh_memory()
    base = torch.cuda.memory_allocated()
    towers = {}

    def record(name, module, build_s):
        n = sum(p.numel() for p in module.parameters())
        towers[name] = {"params": n, "build_s": build_s,
                        "peak_gb": (torch.cuda.max_memory_allocated() - base) / 2**30}
        log(f"  {name}: {n / 1e9:.3f} B params, built on the card in {build_s:.2f} s; peak "
            f"{towers[name]['peak_gb']:.2f} GiB over the 2B pipeline [{smi}]")

    # Qwen3Guard-Gen-0.6B on a byte-level tokenizer (tests/test_guard_models.py's ids), bf16
    lm, build_s = _timed_build(lambda: build_qwen_lm(QwenConfig.qwen3guard_0_6b(), "cuda", seed=62, guard=True))
    record("Qwen3Guard-Gen-0.6B", lm, build_s)
    qwen3 = G.create_qwen3_guard(lm, lambda text: [ord(c) % 256 for c in text],
                                 lambda ids: "".join(chr(i % 256) for i in ids), eos_ids=(QWEN3GUARD_EOS,))
    qwen3.max_new_tokens = QWEN3GUARD_TOKENS
    verdicts = []

    def timed_verdict(prompt_text: str) -> bool:
        t = time.perf_counter()
        safe = qwen3(prompt_text)
        verdicts.append({"prompt": prompt_text, "s": time.perf_counter() - t, "tokens": qwen3.last_tokens, "safe": safe})
        return safe

    siglip, build_s = _timed_build(lambda: build_siglip_vision(SigLIPVisionConfig(), "cuda", seed=63))
    record("SigLIP so400m/14-384", siglip, build_s)
    heads = {}
    for label, cls in (("safe", 0), ("unsafe", 3)):
        head, build_s = _timed_build(lambda: G.build_safety_classifier(device="cuda", seed=64))
        head.network.layers[6].bias[cls] = SAFETY_BIAS
        heads[label] = head
    record("safety head (1152 -> 512 -> 256 -> 7)", heads["safe"], build_s)
    vfilter = G.VideoContentSafetyFilter(make_frame_embedder(siglip), heads["safe"])
    retina, build_s = _timed_build(lambda: build_retinaface("cuda", seed=65))
    record("RetinaFace-ResNet50", retina, build_s)
    detector = G.create_face_detector(retina)

    text_laps, video_laps, guarded = [], [], []
    text_guard = _timed(G.create_text_guardrail_runner(G.GuardrailConfig(llm_classifier=timed_verdict)), text_laps)
    video_runner = G.create_video_guardrail_runner(G.GuardrailConfig(video_classifier=vfilter,
                                                                     face_detector=detector, blur_faces=True))
    video_guard = _timed(lambda frames: guarded.append(frames) or video_runner(frames), video_laps)
    api = Inference(pipe, output_dir=str(out_dir), text_guardrail=text_guard, video_guardrail=video_guard,
                    keep_going=False)
    export_laps = []
    api._finish = _timed(api._finish, export_laps)
    # a request named "hold" keeps the worker busy until released, so that
    # the two Image2World requests go in before it drains the queue
    hold, generate_batch = threading.Event(), api.generate_batch
    api.generate_batch = lambda samples: {} if samples[0].name == "hold" and hold.wait(120) else generate_batch(samples)
    server = ModelServer(api, host="127.0.0.1", port=0)
    server.serve_background()
    port = server.port
    try:
        code, _, body = _http(port, "/health")
        health = json.loads(body)
        _check("/health", code == 200 and health == {"status": "ok", "devices": torch.cuda.device_count()}
               and health["devices"] >= 1, f"{code} {health}")
        code, _, body = _http(port, "/schema")
        _check("/schema", code == 200 and json.loads(body)["num_steps"]["min"] == 1, f"{code}")
        code, ctype, body = _http(port, "/")
        _check("/", code == 200 and ctype.startswith("text/html") and b"/generate" in body, f"{code} {ctype}")

        request = {"prompt": "a robot arm pours coffee into a mug", "text_embedding_path": prompt,
                   "num_steps": GUARD_STEPS, "guidance": GUIDANCE}
        request_b = {**request, "prompt": "a red car drives along a coastal road at dusk"}
        _build.reset_launch_counts()
        blocked = _wait_job(port, _job(port, {**request, "name": "blocked", "prompt": GUARD_BLOCKED_PROMPT}))
        blocked_counts = _build.launch_counts()
        _check("blocked prompt", blocked["status"] == "error" and "blocked by text guardrail" in blocked["error"]
               and blocked["output"] is None and not any(blocked_counts.values()), f"{blocked} {blocked_counts}")
        log(f"  a blocklisted prompt: status {blocked['status']} ({blocked['error']}); no kernel launched")

        hold_id = _job(port, {"name": "hold", "prompt": "hold"})
        _wait_job(port, hold_id, states=("running",))
        with open(image, "rb") as f:
            upload = "data:image/png;base64," + base64.b64encode(f.read()).decode()
        ids = {"i2w_path": _job(port, {**request, "name": "i2w_path", "input_path": image, "seed": 1}),
               "i2w_upload": _job(port, {**request_b, "name": "i2w_upload", "input_image_b64": upload, "seed": 2})}
        depth = json.loads(_http(port, "/queue")[2])["depth"]
        _check("queue", depth == 2, f"depth {depth} before the drain, want 2")
        text_laps.clear()
        export_laps.clear()
        fresh_memory()
        _build.reset_launch_counts()
        t = time.perf_counter()
        hold.set()
        statuses = {name: _wait_job(port, jid) for name, jid in ids.items()}
        request_s = time.perf_counter() - t
        counts = _build.launch_counts()
        batch_peak = torch.cuda.max_memory_allocated() / 2**30
        _check("batched requests", all(s["status"] == "done" for s in statuses.values()), f"{statuses}")
        # one batched pass: GUARD_STEPS batched-CFG forwards (one K1 launch per
        # attention, 2 x 28 a forward, whatever the batch); K2 per sample
        want = {"flash_attention_fwd": GUARD_STEPS * 2 * NUM_BLOCKS,
                "conv3d_causal": 2 * vae_k2_launches(pipe.vae, NUM_FRAMES, pipe.setup.decode_chunk_latent_frames)}
        _check("batched pass launches", {k: v for k, v in counts.items() if v} == want, f"{counts}, want {want}")
        videos = {}
        for name, jid in ids.items():
            code, ctype, data = _http(port, f"/output/{jid}")
            _, head_type, head_body = _http(port, f"/output/{jid}", method="HEAD")
            videos[name] = _decode_video(data, ctype)
            v = videos[name]
            _check(f"/output of {name}", code == 200 and head_type == ctype and not head_body
                   and v.shape == (NUM_FRAMES, H, W, 3) and v.dtype == np.uint8 and v.std() > 0,
                   f"{code} {ctype} {v.shape} {v.dtype}")
        _check("distinct outputs", not np.array_equal(videos["i2w_path"], videos["i2w_upload"]), "equal")
        tm = pipe.last_timings
        split = {"text_guard_s": sum(text_laps), "vae_encode_s": tm["vae_encode_s"], "denoise_s": tm["denoise_s"],
                 "vae_decode_s": tm["vae_decode_s"], "video_guard_s": sum(video_laps), "export_s": sum(export_laps)}
        split["rest_s"] = request_s - sum(split.values())
        log(f"  two Image2World requests (by path and by upload) as one batched pass of {GUARD_STEPS} steps: "
            f"{request_s:.2f} s from the release to both done: {', '.join(f'{k} {v:.2f}' for k, v in split.items())} "
            f"(rest: the worker's prep, the embedding files, HTTP); peak {batch_peak:.2f} GiB; launches {want}; "
            f"served as {ctype}, decoded {videos['i2w_path'].shape} [{smi}]")
        safe_classes = vfilter.last_classes
        for v in verdicts:
            log(f"  Qwen3Guard verdict on {v['prompt']!r} in the server: {'safe' if v['safe'] else 'unsafe'} in "
                f"{v['s'] * 1e3:.1f} ms, {v['tokens']} tokens generated (a 512-id buffer recomputed each token) [{smi}]")
        _check("Qwen3Guard", len(verdicts) == 2 and all(0 < v["tokens"] <= QWEN3GUARD_TOKENS for v in verdicts),
               f"{verdicts}")

        # the video guard's other outcome; Qwen3Guard's verdicts were taken above, so this
        # request's text guard is the blocklist alone
        vfilter.classifier = heads["unsafe"]
        api.text_guardrail = G.create_text_guardrail_runner()
        _build.reset_launch_counts()
        t = time.perf_counter()
        unsafe = _wait_job(port, _job(port, {**request, "name": "i2w_unsafe", "input_path": image, "seed": 3}))
        unsafe_s = time.perf_counter() - t
        unsafe_counts = _build.launch_counts()
        _check("unsafe video", unsafe["status"] == "error" and "video blocked by guardrail" in unsafe["error"]
               and unsafe["output"] is None and (vfilter.last_classes == 3).all() and (safe_classes == 0).all(),
               f"{unsafe} {vfilter.last_classes} {safe_classes}")
        _check("unsafe request launches", unsafe_counts["flash_attention_fwd"] == GUARD_STEPS * 2 * NUM_BLOCKS
               and unsafe_counts["conv3d_causal"] == want["conv3d_causal"] // 2, f"{unsafe_counts}")
        log(f"  the safe head: {len(safe_classes)} sampled frames all class 0, requests done; the unsafe head: "
            f"{unsafe['status']} ({unsafe['error']}) in {unsafe_s:.2f} s, nothing written")
    finally:
        hold.set()
        server.shutdown()
        server.httpd.server_close()
        server.worker.inference = None  # the worker thread waits on its queue for good; let it hold no pipeline

    frames = guarded[0]
    sampled = frames[:: vfilter.sample_every]
    classify_ms = cuda_ms(lambda: vfilter.classify(frames), warmup=1, iters=1)
    pixels = preprocess_siglip(sampled, siglip.cfg.image_size, "cuda")
    siglip_ms = cuda_ms(lambda: siglip(pixels), warmup=1, iters=1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    raw = [detector.forward(f) for f in frames]
    retina_s = time.perf_counter() - t
    retina_ms = cuda_ms(lambda: retina(torch.zeros((1, 3, H, W), device="cuda")), warmup=1, iters=5)
    t = time.perf_counter()
    boxes = [detector.boxes(loc, score, H, W) for loc, score in raw]
    nms_s = time.perf_counter() - t
    n_boxes = sum(len(b) for b in boxes)
    log(f"  SigLIP + head on {len(sampled)} sampled frames: {classify_ms:.2f} ms (the tower alone {siglip_ms:.2f} ms); "
        f"RetinaFace on {len(frames)} frames: forward {retina_s * 1e3:.1f} ms with the copies "
        f"({retina_ms:.2f} ms a frame on the card), host box math {nms_s * 1e3:.1f} ms, {n_boxes} boxes [{smi}]")

    # narrow card vs CPU, fp32 on both sides (TF32 off)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu_retina = RetinaFace().eval()
        cpu_retina.load_state_dict({k: v.cpu() for k, v in retina.state_dict().items()})
        frame = frames[0]
        (loc, score), (cloc, cscore) = detector.forward(frame), RetinaFaceDetector(cpu_retina).forward(frame)
        loc_rel = float(np.linalg.norm(loc - cloc) / np.linalg.norm(cloc))
        conf_rel = float(np.linalg.norm(score - cscore) / np.linalg.norm(cscore))
        # seeded weights score no face above 0.7; a threshold midway between the
        # CPU's 32nd and 33rd scores sends 32 candidates through the sort and NMS
        top = np.sort(cscore)[::-1]
        threshold = float(top[31] + top[32]) / 2
        card_boxes = RetinaFaceDetector(retina, confidence_threshold=threshold).boxes(loc, score, H, W)
        cpu_boxes = RetinaFaceDetector(cpu_retina, confidence_threshold=threshold).boxes(cloc, cscore, H, W)
        _check("RetinaFace card vs CPU", loc_rel <= RETINAFACE_REL_L2 and conf_rel <= RETINAFACE_REL_L2
               and card_boxes == cpu_boxes and len(cpu_boxes) > 0, f"loc {loc_rel:.3e}, conf {conf_rel:.3e}, "
               f"{len(card_boxes)} vs {len(cpu_boxes)} boxes")
        ncfg = dataclasses.replace(SigLIPVisionConfig(), num_layers=NARROW_SIGLIP_LAYERS, dtype=torch.float32)
        narrow = build_siglip_vision(ncfg, "cuda", seed=66)
        cpu_narrow = build_siglip_vision(ncfg, "cpu", seed=None)
        cpu_narrow.load_state_dict({k: v.cpu() for k, v in narrow.state_dict().items()})
        head = G.build_safety_classifier(device="cuda", seed=67)
        cpu_head = G.build_safety_classifier({k: v.cpu() for k, v in head.state_dict().items()}, device="cpu")
        card_filter = G.VideoContentSafetyFilter(make_frame_embedder(narrow), head)
        cpu_filter = G.VideoContentSafetyFilter(make_frame_embedder(cpu_narrow), cpu_head)
        t = time.perf_counter()
        card_classes, cpu_classes = card_filter.classify(frames), cpu_filter.classify(frames)
        _check("SigLIP + head card vs CPU", np.array_equal(card_classes, cpu_classes),
               f"{card_classes} vs {cpu_classes}")
        log(f"  narrow card fp32 vs CPU fp32: RetinaFace loc rel_l2 {loc_rel:.3e}, conf {conf_rel:.3e} (limit "
            f"{RETINAFACE_REL_L2}), the host box math on the card's outputs at confidence {threshold:.4f}: the "
            f"CPU's {len(cpu_boxes)} boxes; SigLIP ({NARROW_SIGLIP_LAYERS} of 27 layers at full width) + a seeded "
            f"head on {len(card_classes)} "
            f"sampled frames: classes {card_classes.tolist()} on both ({time.perf_counter() - t:.2f} s)")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    del lm, siglip, heads, retina, narrow, head, api, server
    fresh_memory()
    return {"counts": counts, "request_s": request_s, **split, "unsafe_s": unsafe_s, "towers": towers,
            "qwen3guard": verdicts,
            "classify_ms": classify_ms, "siglip_ms": siglip_ms, "retinaface_93_s": retina_s,
            "retinaface_frame_ms": retina_ms, "nms_s": nms_s, "boxes": n_boxes, "batch_peak_gb": batch_peak,
            "retinaface_loc_rel_l2": loc_rel, "retinaface_conf_rel_l2": conf_rel}


def fourteen_b_slice() -> dict:
    """One Text2World request on the 14B base (5120 channels, 36 blocks, 40
    heads of 128) on seeded random bf16 matmul weights, built by
    load_model_from_checkpoint: 93 frames at 192x320, FOURTEEN_B_STEPS steps, CFG 7."""
    import torch

    from cosmos_predict2_tpu_torch import _build

    fresh_memory()
    pipe, cfg = _serving_pipe(FOURTEEN_B_EXPERIMENT)
    net = cfg.model.net
    if (net.model_channels, net.num_blocks, net.num_heads, net.head_dim) != (5120, 36, 40, 128):
        raise AssertionError("the 14B slice must run the full-width 14B DiT")
    weights_gb = torch.cuda.memory_allocated() / 2**30
    H, W = SIZE
    emb = np.random.default_rng(8).standard_normal((1, 512, net.crossattn_proj_in_channels)).astype(np.float32)
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    frames = pipe.generate_vid2world(np.zeros((1, 3, NUM_FRAMES, H, W), np.uint8), emb, guidance=GUIDANCE,
                                     num_steps=FOURTEEN_B_STEPS, num_conditional_frames=0, seed=1,
                                     pixel_format="uint8")
    request_s = time.perf_counter() - t
    counts = _build.launch_counts()
    if frames.shape != (NUM_FRAMES, H, W, 3) or frames.dtype != np.uint8 or frames.std() == 0:
        raise AssertionError(f"14B text2world output {frames.shape} {frames.dtype}")
    check_launches("14b", counts, FOURTEEN_B_STEPS * 2 * net.num_blocks)
    tm = pipe.last_timings
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"  14B text2world: {request_s:.2f} s: vae_encode {tm['vae_encode_s']:.2f} s, denoise {tm['denoise_s']:.2f} s "
        f"({tm['denoise_step_s'] * 1e3:.1f} ms/step, one batched-CFG forward of 5,760 tokens), vae_decode "
        f"{tm['vae_decode_s']:.2f} s; weights {weights_gb:.2f} GiB, peak {peak_gb:.2f} GiB; launches {counts}")
    del pipe
    return {"counts": counts, "request_s": request_s, **tm, "weights_gb": weights_gb, "peak_gb": peak_gb}


def write_posttrain_folder(root: Path) -> None:
    """A local dataset of three clips (data/local_dataset.py's layout): two
    of 100 frames at 720x1280 (resized and cropped to 704x1280, a window
    drawn) and one of 60 (padded), as npz; captions for all three;
    (512, 100352) fp16 embeddings for the first two, none for the third.
    The frames are a colour ramp moving 4 levels per frame plus one of four
    noise frames, made in bulk."""
    rng = np.random.default_rng(15)
    for d in ("videos", "metas", "t5_xxl"):
        (root / d).mkdir(parents=True, exist_ok=True)
    h, w = POSTTRAIN_CLIP_HW
    ramp = (np.arange(h, dtype=np.uint16)[:, None] * 255 // (h - 1)
            + np.arange(w, dtype=np.uint16)[None, :] * 255 // (w - 1)).astype(np.uint8)  # wraps mod 256
    noise = rng.integers(0, 16, (4, h, w, 3), dtype=np.uint8)
    emb = rng.standard_normal((512, 100352), dtype=np.float32).astype(np.float16)
    for i, (name, frames) in enumerate((("clip_a", POSTTRAIN_LONG), ("clip_b", POSTTRAIN_LONG),
                                        ("clip_c", POSTTRAIN_SHORT))):
        t = (4 * np.arange(frames) + 64 * i).astype(np.uint8)
        video = ramp[None, :, :, None] + t[:, None, None, None] + np.array([0, 85, 170], np.uint8)
        video += noise[np.arange(frames) % 4]
        np.savez(root / "videos" / f"{name}.npz", video=video, fps=16.0)
        (root / "metas" / f"{name}.txt").write_text(f"{name}: a robot arm moves a block")
        if name != "clip_c":
            np.save(root / "t5_xxl" / f"{name}.npy", emb if i == 0 else -emb)


class StepProbe:
    """Per step: loss, gradient norm, launches and the trainer's timings.
    At the start and the end of the run it keeps, on the host, the watched
    trainable parameters and their EMA (all of them, with the optimizer
    state, when ``watch`` is None) and whether each moved; with
    ``keep_base``, whether the model's frozen base weights stayed bit-equal;
    with ``grads_of``, per step the learning rate and the largest |gradient|
    of each trainable tensor whose name ends so; and the dtypes of the
    optimizer's moments."""

    def __init__(self, watch: tuple | None = None, keep_base: bool = False, profile_step: int | None = None,
                 grads_of: str | None = None):
        self.steps, self.watch, self.keep_base, self.profile_step, self.profile = [], watch, keep_base, profile_step, None
        self.grads_of = grads_of

    def _host_state(self, state) -> dict:
        import torch

        names = self.watch if self.watch is not None else tuple(state.params)
        host = lambda t: t.detach().to("cpu", copy=True)
        out = {"params": {n: host(state.params[n]) for n in names},
               "ema_params": {n: host(state.ema_params[n]) for n in names}}
        if self.watch is None:
            out["optimizer"] = {i: {k: host(v) if torch.is_tensor(v) else v for k, v in st.items()}
                                for i, st in state.optimizer.state_dict()["state"].items()}
        return out

    def on_train_start(self, trainer, state):
        self.start, self.start_step = self._host_state(state), state.step
        self.base = ({k: v.detach().to("cpu", copy=True) for k, v in trainer.model.net.state_dict().items()}
                     if self.keep_base else None)

    def on_training_step_start(self, trainer, state, batch, iteration):
        import torch

        from cosmos_predict2_tpu_torch import _build

        self.counts0 = _build.launch_counts()
        self.lr = float(state.optimizer.param_groups[0]["lr"])  # the rate this step's update takes
        if iteration + 1 == self.profile_step:
            self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                            torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()

    def on_training_step_end(self, trainer, state, metrics, iteration):
        import torch

        from cosmos_predict2_tpu_torch import _build

        counts = {k: v - self.counts0[k] for k, v in _build.launch_counts().items()}
        if iteration == self.profile_step:
            self._prof.__exit__(None, None, None)
            self.profile = device_time_table(self._prof, trainer.last_timings["step_s"])
            del self._prof
        self.steps.append({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                           "counts": counts, **trainer.last_timings})
        st = self.steps[-1]
        if self.grads_of:
            names = [n for n in state.params if n.endswith(self.grads_of)]
            amax = torch.stack([state.params[n].grad.abs().amax() for n in names]).float().cpu()
            st["grads"] = {"lr": self.lr, "tensors": len(names), "zero": int((amax == 0).sum()),
                           "smallest_max": float(amax.min()), "largest": float(amax.max())}
            g = st["grads"]
            log(f"  step {iteration}: learning rate {g['lr']:.3e}; *{self.grads_of} gradients: {g['zero']} of "
                f"{g['tensors']} tensors all zero, largest |grad| {g['largest']:.3e}, smallest tensor max "
                f"{g['smallest_max']:.3e}")
        log(f"  step {iteration}: loss {st['loss']:.4f} grad_norm {st['grad_norm']:.3e} data+vae {st['data_s']:.3f} s, "
            f"fwd+bwd {st['forward_backward_s']:.3f} s, optimizer+ema {st['optimizer_s']:.3f} s; launches "
            f"K1 {counts['flash_attention_fwd']} K7 {counts['flash_attention_bwd_dq']} "
            f"K8 {counts['flash_attention_bwd_dkv']} K2 {counts['conv3d_causal']}")

    def on_save_checkpoint(self, trainer, state, iteration): ...

    def on_train_end(self, trainer, state):
        import torch

        self.end = self._host_state(state)
        self.moved = {group: all(not torch.equal(self.end[group][n], t) for n, t in self.start[group].items())
                      for group in ("params", "ema_params")}
        self.moment_dtypes = {str(st[k].dtype) for st in state.optimizer.state.values()
                              for k in ("exp_avg", "exp_avg_sq")}
        if self.keep_base:
            self.base_same = all(torch.equal(v.detach().cpu(), self.base[k])
                                 for k, v in trainer.model.net.state_dict().items())
            self.base = None


def check_step_launches(name: str, steps: list, k1: int) -> None:
    """K1 ``k1`` times and K7 and K8 56 times (one per attention call) in every step."""
    want = {"flash_attention_fwd": k1, "flash_attention_bwd_dq": 2 * NUM_BLOCKS,
            "flash_attention_bwd_dkv": 2 * NUM_BLOCKS}
    for i, s in enumerate(steps):
        got = {k: s["counts"][k] for k in want}
        if got != want:
            raise AssertionError(f"{name}: step {i + 1} launched {got}, want {want}")


def _equal_states(a, b) -> bool:
    """Nested dicts / lists of tensors and numbers, equal bit for bit."""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_states(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal_states(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    return a == b


def lora_posttrain_slice(root: Path) -> dict:
    """The LoRA recipe through training/train.py's main at its geometry (93
    frames at 704x1280, 84,480 tokens, batch 1, rank 32) on the local folder:
    2 iterations saved at 2. (A cut: the run resumed from that checkpoint for
    a third iteration, ~48 s on an H100, left to make room for phase 20; the
    CPU tests hold the resume.)"""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.training.checkpointing import Checkpointer
    from cosmos_predict2_tpu_torch.training.lora import count_lora_params
    from cosmos_predict2_tpu_torch.training.train import main
    from cosmos_predict2_tpu_torch.utils import native

    ckpt_dir = root / "ckpt"
    overrides = ["data_train=local_video", f"data_train.root={root}", "data_train.text_dim=100352",
                 "trainer.save_iter=2", "trainer.logging_iter=1"]
    cfg = make_config(LORA_EXPERIMENT, overrides)
    m, d = cfg.model, cfg.data_train
    if (m.net.num_blocks, m.net.model_channels, m.net.crossattn_proj_in_channels, m.net.remat, m.use_lora,
            m.lora_rank, d.num_frames, d.height, d.width) != (NUM_BLOCKS, 2048, 100352, "block", True, 32,
                                                              *POSTTRAIN_GEOMETRY):
        raise AssertionError("the post-training slice must run the released LoRA recipe at its geometry")
    tokens = (1 + (d.num_frames - 1) // 4) * (d.height // 16) * (d.width // 16)
    args = [f"--experiment={LORA_EXPERIMENT}", "--ckpt_dir", str(ckpt_dir), *overrides]  # the card: main's default

    fresh_memory()
    native.route_counts.update(native=0, numpy=0)
    _build.reset_launch_counts()
    first = StepProbe(keep_base=True, grads_of=".lora_A")
    t0 = time.perf_counter()
    if main(args + ["trainer.max_iter=2"], callbacks=[first]) != 0:
        raise AssertionError("the LoRA run exited non-zero")
    first_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    saved = Checkpointer(str(ckpt_dir)).read()
    counts = _build.launch_counts()
    routes = dict(native.route_counts)
    log(f"  launches: {counts}; media ops by route: {routes}")

    steps = first.steps
    if len(steps) != 2 or not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps):
        raise AssertionError(f"losses {[s['loss'] for s in steps]}: want 2 finite")
    check_step_launches("the LoRA run", steps, 4 * NUM_BLOCKS)
    if counts["conv3d_causal"] == 0:
        raise AssertionError("K2 never ran in the LoRA run's VAE encode")
    if native.get_lib() is None or routes["native"] == 0 or routes["numpy"]:
        raise AssertionError(f"the media ops took the NumPy fallback on the card's host: {routes}")
    # B starts at zero, so every A's gradient is exactly zero at step 1 and B alone moves, by about the
    # warm-up's first rate; at step 2 every A has a gradient, through that small B, and Adam's update
    # of it (|g| against eps) can stay under an fp32 step of A: the gradients and rates are printed
    g1, g2 = (s["grads"] for s in first.steps)
    if g1["zero"] != g1["tensors"] or g2["zero"]:
        raise AssertionError(f"lora_A gradients: want all zero at step 1 (B = 0) and none zero at step 2, "
                             f"got {g1['zero']} and {g2['zero']} of {g1['tensors']} tensors all zero")
    moved = {g: [n for n, t in first.start[g].items() if not torch.equal(first.end[g][n], t)]
             for g in ("params", "ema_params")}
    b_names = [n for n in first.start["params"] if n.endswith(".lora_B")]
    log(f"  after 2 iterations: {len(moved['params'])} of {len(first.start['params'])} adapter tensors moved "
        f"(every lora_B: {set(b_names) <= set(moved['params'])}), {len(moved['ema_params'])} of their EMA")
    if not (set(b_names) <= set(moved["params"]) and set(b_names) <= set(moved["ema_params"])):
        raise AssertionError("an adapter's B or its EMA did not move")
    if not first.base_same:
        raise AssertionError("the frozen base weights changed")
    if saved["step"] != 2 or not all(k.endswith((".lora_A", ".lora_B")) for k in saved["params"]):
        raise AssertionError("the checkpoint is not the adapters' at iteration 2")
    if not _equal_states({"params": saved["params"], "ema_params": saved["ema_params"],
                          "optimizer": saved["optimizer"]["state"]}, first.end):
        raise AssertionError("the checkpoint does not hold the first run's adapters, EMA and optimizer state")
    trainable = count_lora_params(first.end["params"])
    timed = steps[1]  # step 1 warms up
    out = {"counts": counts, "routes": routes, "trainable": trainable, "tokens": tokens, "peak_gb": peak_gb,
           "first_run_s": first_s,
           **{k: timed[k] for k in ("data_s", "forward_backward_s", "optimizer_s", "step_s")}}
    log(f"  {LORA_EXPERIMENT}: {trainable:,} trainable parameters (rank-32 adapters); step 2: data+vae "
        f"{out['data_s']:.3f} s, fwd+bwd {out['forward_backward_s']:.3f} s, optimizer+ema {out['optimizer_s']:.3f} s; "
        f"{tokens} tokens/step: {tokens / out['step_s']:.0f} tokens/s over the train step, "
        f"{tokens / (out['step_s'] + out['data_s']):.0f} over the iteration; peak device memory {peak_gb:.2f} GiB "
        f"; run {first_s:.1f} s; base weights bit-equal, adapters and EMA moved, the checkpoint equal to the "
        f"state")
    return out


def full_ft_rows(root: Path) -> dict:
    """The full fine-tune recipe on the same folder at 192x320 (5,760 tokens),
    one warm-up and FULL_FT_TIMED timed steps under each (remat, moments)
    row: the K1 launches per step follow the remat, K7 and K8 stay 56."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.training.train import launch

    H, W = SIZE
    rows, counts = [], dict.fromkeys(_build.launch_counts(), 0)
    for remat, moments, k1 in FULL_FT_ROWS:
        cfg = make_config(FULL_FT_EXPERIMENT, [
            "data_train=local_video", f"data_train.root={root}", "data_train.text_dim=100352",
            f"data_train.height={H}", f"data_train.width={W}", f"trainer.max_iter={1 + FULL_FT_TIMED}",
            "trainer.save_iter=0", "trainer.logging_iter=1", f"model.net.remat={remat}",
            f"trainer.optimizer.moments_dtype={moments}",
        ])
        probe = StepProbe(watch=("x_embedder.proj.1.weight", "blocks.0.self_attn.q_proj.weight",
                                 f"blocks.{NUM_BLOCKS - 1}.mlp.layer2.weight", "final_layer.linear.weight"))
        fresh_memory()
        _build.reset_launch_counts()
        launch(cfg, device="cuda", callbacks=[probe])
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        counts = {k: counts[k] + v for k, v in _build.launch_counts().items()}
        if len(probe.steps) != 1 + FULL_FT_TIMED or not all(np.isfinite(s["loss"]) for s in probe.steps):
            raise AssertionError(f"{remat}/{moments}: losses {[s['loss'] for s in probe.steps]}")
        check_step_launches(f"full fine-tune {remat}/{moments}", probe.steps, k1)
        if not (probe.moved["params"] and probe.moved["ema_params"]):
            raise AssertionError(f"{remat}/{moments}: parameters and EMA moved: {probe.moved}")
        if probe.moment_dtypes != {f"torch.{moments}"}:
            raise AssertionError(f"{remat}/{moments}: the optimizer kept {probe.moment_dtypes} moments")
        timed = probe.steps[1:]
        row = {"remat": remat, "moments": moments, "k1_per_step": k1, "peak_gb": peak_gb,
               **{k: sum(s[k] for s in timed) / len(timed) for k in ("step_s", "data_s", "forward_backward_s",
                                                                     "optimizer_s")}}
        rows.append(row)
        log(f"  remat {remat:9s} moments {moments:8s}: step {row['step_s']:.3f} s (fwd+bwd "
            f"{row['forward_backward_s']:.3f} + optimizer+ema {row['optimizer_s']:.3f}), data+vae {row['data_s']:.3f} s, "
            f"peak {peak_gb:.2f} GiB, K1 {k1} per step")
    return {"counts": counts, "rows": rows}


def small_posttrain_step(device: str, dtype, lora: bool, state=None):
    """One step of a narrow DiT (the 2B experiment, 2 blocks of 256 channels)
    with fixed weights, inputs and draws: with ``lora`` the rank-8 adapters
    (B drawn nonzero) over the frozen net, their loss and gradients; else the
    full net, its loss and gradients and the bf16 moments after one AdamWBF16
    step whose rounding noise comes from a CPU generator. Returns (loss,
    {name: fp32 CPU tensor}, the weights and adapters it started from, to
    hand to the other device)."""
    import torch

    from cosmos_predict2_tpu_torch.conditioning.conditioner import apply_train_dropout, make_condition
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.training.lora import LoRAModelWrapper
    from cosmos_predict2_tpu_torch.training.optim import AdamWBF16, clip_by_global_norm_, global_norm

    cfg = make_config(DENSE_EXPERIMENT)
    net_cfg = dataclasses.replace(cfg.model.net, model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32,
                                  crossattn_proj_in_channels=64, crossattn_emb_channels=128, dtype=dtype)
    net = build_dit(net_cfg, device, seed=10, trainable=not lora)
    if state is not None:
        net.load_state_dict(state["net"])
    model = Video2WorldModel(dataclasses.replace(cfg.model, net=net_cfg, state_t=4), net)
    if lora:
        model = LoRAModelWrapper(model, rank=8, alpha=16.0)
        adapters = model.init_lora(torch.Generator(device).manual_seed(3))
        with torch.no_grad():
            for n, p in adapters.items():
                if state is not None:
                    p.copy_(state["adapters"][n])
                elif n.endswith("lora_B"):
                    p.copy_(0.02 * torch.randn(p.shape, generator=torch.Generator().manual_seed(len(n))))
    params = model.trainable_parameters()
    start = {"net": {k: v.detach().to("cpu", copy=True) for k, v in net.state_dict().items()},
             "adapters": {n: p.detach().to("cpu", copy=True) for n, p in params.items()} if lora else None}
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((1, 16, 4, 16, 24)).astype(np.float32)).to(device)
    emb = torch.from_numpy(rng.standard_normal((1, 32, 64)).astype(np.float32)).to(device)
    draws = model.sample_train_draws(torch.Generator().manual_seed(0), tuple(x0.shape)).to(device)
    cond = apply_train_dropout(make_condition(emb).replace(gt_frames=x0), draws.text_keep, draws.use_video)
    loss, _ = model.training_step(x0, cond, draws)
    loss.backward()
    host = lambda t: t.detach().to("cpu", dtype=torch.float32, copy=True)  # a copy on either device
    out = {f"grad {n}": host(p.grad) for n, p in params.items()}
    if not lora:
        grads = [p.grad for p in params.values()]
        clip_by_global_norm_(grads, global_norm(grads), 10.0)
        opt = AdamWBF16(params.values(), lr=1e-4, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.001,
                        generator=torch.Generator().manual_seed(7))
        opt.step()
        for n, p in params.items():
            out[f"exp_avg {n}"] = host(opt.state[p]["exp_avg"])
            out[f"exp_avg_sq {n}"] = host(opt.state[p]["exp_avg_sq"])
    return float(loss.detach()), out, start


def small_posttrain_reference() -> None:
    """The narrow LoRA step and the narrow bf16-moment step in bf16 on the
    card (K1, K7, K8) against the same weights, adapters, draws and rounding
    noise in fp32 on the CPU: phase 6's limits on the loss, on all gradients
    (and moments) together and on each tensor."""
    import torch

    from cosmos_predict2_tpu_torch import _build

    for lora in (True, False):
        _build.reset_launch_counts()
        loss, got, state = small_posttrain_step("cuda", torch.bfloat16, lora)
        counts = _build.launch_counts()
        ref_loss, want, _ = small_posttrain_step("cpu", torch.float32, lora, state)
        for kind in ("grad", "exp_avg", "exp_avg_sq") if not lora else ("grad",):
            names = [n for n in want if n.startswith(kind + " ")]
            num = sum(float((got[n] - want[n]).norm()) ** 2 for n in names) ** 0.5
            den = sum(float(want[n].norm()) ** 2 for n in names) ** 0.5
            worst = max((float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30)), n) for n in names)
            log(f"  {'LoRA' if lora else 'bf16-moment'} step, {kind}: rel_l2 {num / den:.3e} (limit "
                f"{TRAIN_GRAD_REL_L2}), worst tensor {worst[0]:.3e} {worst[1]} (limit {TRAIN_GRAD_TENSOR_REL_L2})")
            if not (all(torch.isfinite(got[n]).all() for n in names) and num / den <= TRAIN_GRAD_REL_L2
                    and worst[0] <= TRAIN_GRAD_TENSOR_REL_L2):
                raise AssertionError(f"the small {'LoRA' if lora else 'bf16-moment'} step's {kind} on the card "
                                     "disagrees with its fp32 CPU reference")
        loss_rel = abs(loss / ref_loss - 1)
        log(f"  {'LoRA' if lora else 'bf16-moment'} step: card bf16 loss {loss:.6f} vs cpu fp32 {ref_loss:.6f}: rel "
            f"{loss_rel:.3e} (limit {TRAIN_LOSS_REL}); launches {counts}")
        want_counts = {"flash_attention_fwd": 8, "flash_attention_bwd_dq": 4, "flash_attention_bwd_dkv": 4}
        if loss_rel > TRAIN_LOSS_REL or {k: counts[k] for k in want_counts} != want_counts:
            raise AssertionError("the small post-training step on the card disagrees with its CPU reference")


def posttrain_slice() -> dict:
    """Phase 15: the local folder, the LoRA recipe at 704x1280, the full
    fine-tune rows at 192x320 and the small references; the folder
    is deleted at the end."""
    import shutil

    root = OUT_DIR / "posttrain"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_posttrain_folder(root)
    log(f"  wrote the local dataset (3 clips, 2 embeddings) in {time.perf_counter() - t0:.1f} s")
    try:
        lora = lora_posttrain_slice(root)
        rows = full_ft_rows(root)
        small_posttrain_reference()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"lora": lora, "rows": rows, "counts": {k: lora["counts"][k] + rows["counts"][k] for k in lora["counts"]}}


# ---------------- post-training from remote shards (phase 15b) ----------------

REMOTE_SHARDS = 2
REMOTE_CLIPS_PER_SHARD = 2
REMOTE_SEED = 0  # ShardedTarDataset's shuffle seed
REMOTE_TIMED = 2  # after one warm-up iteration; the first timed one runs under the profiler
# the launches of one clip's streaming VAE encode at 93 x 192x320 (PERF.md's K2 row)
REMOTE_K2_PER_CLIP = 480
REMOTE_KERNELS = ("flash_attention_fwd_kernel", "flash_attention_bwd_dq_kernel", "flash_attention_bwd_dkv_kernel")


def write_remote_shards(root: Path, text_dim: int) -> list[Path]:
    """REMOTE_SHARDS tar shards of REMOTE_CLIPS_PER_SHARD clips each under
    ``root``: per clip a uint8 npz of NUM_FRAMES frames at SIZE (a colour ramp
    moving 4 levels per frame plus one of four noise frames, as
    write_posttrain_folder makes them), its (512, text_dim) fp16 text
    embedding as npy, and its fps and caption as json. Made in bulk."""
    import io
    import tarfile

    rng = np.random.default_rng(151)
    h, w = SIZE
    ramp = (np.arange(h, dtype=np.uint16)[:, None] * 255 // (h - 1)
            + np.arange(w, dtype=np.uint16)[None, :] * 255 // (w - 1)).astype(np.uint8)  # wraps mod 256
    noise = rng.integers(0, 16, (4, h, w, 3), dtype=np.uint8)
    emb = rng.standard_normal((512, text_dim), dtype=np.float32).astype(np.float16)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for s in range(REMOTE_SHARDS):
        paths.append(root / f"shard-{s:05d}.tar")
        with tarfile.open(paths[-1], "w") as tf:
            for c in range(REMOTE_CLIPS_PER_SHARD):
                i = s * REMOTE_CLIPS_PER_SHARD + c
                t = (4 * np.arange(NUM_FRAMES) + 64 * i).astype(np.uint8)
                video = ramp[None, :, :, None] + t[:, None, None, None] + np.array([0, 85, 170], np.uint8)
                video += noise[np.arange(NUM_FRAMES) % 4]
                members = {}
                for ext, save, value in (("npz", np.savez, {"video": video}), ("npy", np.save, emb if i % 2 else -emb)):
                    buf = io.BytesIO()
                    save(buf, **value) if ext == "npz" else save(buf, value)
                    members[ext] = buf.getvalue()
                members["json"] = json.dumps({"fps": 16.0, "caption": f"clip {i}: a robot arm moves a block"}).encode()
                for ext, data in members.items():
                    info = tarfile.TarInfo(f"clip_{i:03d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return paths


def fake_s3_store():
    """A threaded http.server on 127.0.0.1 speaking the S3 calls the port's
    S3Backend makes (PUT, GET, HEAD of an object), counting the bytes its
    GETs serve. Returns (server, its thread, the endpoint URL, the
    served-bytes counter)."""
    import threading
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    objects, served, lock = {}, {"bytes": 0, "gets": 0}, threading.Lock()

    class Store(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _key(self):
            return urllib.parse.unquote(urllib.parse.urlparse(self.path).path.lstrip("/"))

        def do_PUT(self):
            objects[self._key()] = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_GET(self):
            data = objects.get(self._key())
            self.send_response(200 if data is not None else 404)
            self.send_header("Content-Length", str(len(data or b"")))
            self.end_headers()
            if self.command == "GET" and data is not None:
                self.wfile.write(data)
                with lock:
                    served["bytes"] += len(data)
                    served["gets"] += 1

        do_HEAD = do_GET

    server = ThreadingHTTPServer(("127.0.0.1", 0), Store)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_port}", served


def _same_sample(a: dict, b: dict) -> bool:
    """Two decoded shard samples equal bit for bit: keys, arrays (dtype,
    shape, bytes) and the json."""
    if a.keys() != b.keys():
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict) and k == "npz":
            if x.keys() != y.keys() or not all(x[n].dtype == y[n].dtype and np.array_equal(x[n], y[n]) for n in x):
                return False
        elif isinstance(x, np.ndarray):
            if not (x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()):
                return False
        elif x != y:
            return False
    return True


class RemoteProbe:
    """Phase 15b's callback: each iteration inside maybe_enable_profiling's
    window test and the TrainingTimer's "step" section, entered and left from
    the trainer's step hooks."""

    def __init__(self, profiling_config, timer):
        self.config, self.timer, self.active = profiling_config, timer, []

    def on_train_start(self, trainer, state): ...

    def on_training_step_start(self, trainer, state, batch, iteration):
        from cosmos_predict2_tpu_torch.utils.profiling import maybe_enable_profiling

        self._prof = maybe_enable_profiling(self.config, iteration, device="cuda")
        self.active.append(self._prof.__enter__())
        self._step = self.timer("step")
        self._step.__enter__()

    def on_training_step_end(self, trainer, state, metrics, iteration):
        self._step.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def on_save_checkpoint(self, trainer, state, iteration): ...

    def on_train_end(self, trainer, state): ...


def remote_posttrain(root: Path, served: dict, shard_paths: list[Path]) -> dict:
    """The full fine-tune recipe at SIZE on the remote shards: the trainer
    built as training/train.py's launch builds it, fed by ShardedTarDataset
    -> latent_batches (the streaming VAE encode), one warm-up and
    REMOTE_TIMED timed iterations under the profile window and the section
    timers; then the rest of the epoch, the spool, the bytes served and the
    samples held against the local route."""
    import itertools

    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.data.loaders import ShardedTarDataset
    from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae
    from cosmos_predict2_tpu_torch.training.train import latent_batches
    from cosmos_predict2_tpu_torch.training.trainer import IterSpeedCallback, Trainer
    from cosmos_predict2_tpu_torch.utils.profiling import ProfilingConfig, TrainingTimer, device_memory_report

    H, W = SIZE
    iters = 1 + REMOTE_TIMED
    cfg = make_config(FULL_FT_EXPERIMENT, [f"data_train.height={H}", f"data_train.width={W}",
                                           f"trainer.max_iter={iters}", "trainer.save_iter=0",
                                           "trainer.logging_iter=1"])
    m, tc = cfg.model, cfg.trainer
    if (m.net.num_blocks, m.net.model_channels, m.net.crossattn_proj_in_channels, m.net.remat, m.use_lora,
            tc.optimizer.moments_dtype, cfg.data_train.num_frames) != (NUM_BLOCKS, 2048, 100352, "block", False,
                                                                      "float32", NUM_FRAMES):
        raise AssertionError("phase 15b must run the full fine-tune recipe (block remat, fp32 moments, 93 frames)")
    remote = [f"s3://bucket/{p.name}" for p in shard_paths]
    spool_dir = root / "spool"
    trace_dir = root / "profile"
    pcfg = ProfilingConfig(enabled=True, skip_first_n=1, first_n_iterations=1, trace_dir=str(trace_dir))
    device = torch.device("cuda")
    timer = TrainingTimer(device)

    fresh_memory()
    # the trainer as launch builds it (seeded 2B, the VAE), handed the remote batches
    net = build_dit(m.net, device, seed=tc.seed, trainable=True)
    model = Video2WorldModel(m, net)
    vae = build_vae(cfg.tokenizer, device, seed=tc.seed + 1)
    probe = StepProbe(watch=("x_embedder.proj.1.weight", "blocks.0.self_attn.q_proj.weight",
                             f"blocks.{NUM_BLOCKS - 1}.mlp.layer2.weight", "final_layer.linear.weight"))
    rprobe = RemoteProbe(pcfg, timer)
    trainer = Trainer(tc, model, callbacks=[IterSpeedCallback(tc.logging_iter), probe, rprobe])
    state = trainer.init_state()

    dataset = ShardedTarDataset(remote, shuffle_seed=REMOTE_SEED, spool_dir=str(spool_dir))
    samples_it = iter(dataset)
    seen, data_counts = [], []

    def to_batches(samples):
        for s in samples:
            seen.append(s)
            yield {"video": s["npz"]["video"].transpose(3, 0, 1, 2)[None],  # (1, 3, T, H, W) uint8
                   "t5_text_embeddings": s["npy"][None].astype(np.float32),
                   "fps": np.asarray([s["json"]["fps"]], np.float32)}

    def timed(batches):
        while True:
            c0 = _build.launch_counts()
            with timer("data"):
                try:
                    batch = next(batches)
                except StopIteration:
                    return
            data_counts.append({k: v - c0[k] for k, v in _build.launch_counts().items()})
            yield batch

    batches = timed(latent_batches(to_batches(samples_it), vae, device))
    served.update(bytes=0, gets=0)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.train(state, batches)
    # the rest of the epoch: its clips through the same encode, then the
    # dataset closed at the epoch's end (the last shard leaves the spool)
    rest = list(itertools.islice(batches, REMOTE_SHARDS * REMOTE_CLIPS_PER_SHARD - iters))
    samples_it.close()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    memory = device_memory_report()
    summary = timer.summary()
    log(f"  launches over the epoch (3 iterations and the last clip's encode): {counts}")
    log("  device_memory_report() after the last step: " + ", ".join(
        f"{k} {v / 2**30:.2f} GiB" for k, v in memory[0].items() if k.endswith(("all.peak", "all.current"))))

    n_clips = REMOTE_SHARDS * REMOTE_CLIPS_PER_SHARD
    shard_bytes = sum(p.stat().st_size for p in shard_paths)
    spool_left = sorted(p.name for p in spool_dir.iterdir())
    if len(probe.steps) != iters or not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
                                            for s in probe.steps):
        raise AssertionError(f"losses {[s['loss'] for s in probe.steps]}: want {iters} finite")
    check_step_launches("phase 15b", probe.steps, 4 * NUM_BLOCKS)
    if len(rest) != n_clips - iters or len(seen) != n_clips or len(data_counts) != n_clips:
        raise AssertionError(f"the epoch gave {len(seen)} clips, want {n_clips}")
    for i, c in enumerate(data_counts):
        if {k: v for k, v in c.items() if v} != {"conv3d_causal": REMOTE_K2_PER_CLIP}:
            raise AssertionError(f"clip {i}'s data phase launched {c}, want K2 {REMOTE_K2_PER_CLIP} and nothing else")
    if not (probe.moved["params"] and probe.moved["ema_params"]) or probe.moment_dtypes != {"torch.float32"}:
        raise AssertionError(f"parameters / EMA moved {probe.moved}, moments {probe.moment_dtypes}")
    if served["bytes"] != shard_bytes or served["gets"] != REMOTE_SHARDS:
        raise AssertionError(f"the store served {served} for {REMOTE_SHARDS} shards of {shard_bytes} bytes")
    if spool_left:
        raise AssertionError(f"the spool holds {spool_left} after the epoch")
    local = ShardedTarDataset([str(p) for p in shard_paths], shuffle_seed=REMOTE_SEED)
    local_samples = list(itertools.islice(local, n_clips))
    if [s["__key__"] for s in seen] != [s["__key__"] for s in local_samples] or not all(
            _same_sample(a, b) for a, b in zip(seen, local_samples)):
        raise AssertionError("a remote sample differs from the local route's")
    if rprobe.active != [False, True, False]:
        raise AssertionError(f"profile window {rprobe.active}, want iteration 1 only")
    trace = trace_dir / "iteration_000001.json"
    text = trace.read_text() if trace.exists() else ""
    missing = [k for k in REMOTE_KERNELS if k not in text]
    if missing:
        raise AssertionError(f"the Chrome trace {trace} ({len(text)} bytes) does not name {missing}")
    if set(summary) != {"data", "step"}:
        raise AssertionError(f"TrainingTimer.summary() {summary}")

    timed_steps = probe.steps[1:]
    out = {"counts": counts, "epoch_s": epoch_s, "peak_gb": peak_gb, "fetched_mb": served["bytes"] / 1e6,
           "timer": summary, "trace_mb": len(text) / 1e6, "first_clip": seen[0]["npz"]["video"],
           "steps": [{k: s[k] for k in ("loss", "data_s", "step_s", "forward_backward_s", "optimizer_s")}
                     for s in probe.steps],
           "vae": vae}
    for i, s in enumerate(probe.steps):
        log(f"  iteration {i}{' (profiled)' if rprobe.active[i] else ''}: data {s['data_s']:.3f} s (fetch, decode, "
            f"VAE encode), step {s['step_s']:.3f} s, iteration {s['data_s'] + s['step_s']:.3f} s, loss {s['loss']:.4f}")
    log(f"  TrainingTimer.summary(): data {summary['data']:.3f} s over {timer.counts['data']} clips, step "
        f"{summary['step']:.3f} s over {timer.counts['step']} steps (the card synchronised at each end); the "
        f"unprofiled timed step {timed_steps[-1]['step_s']:.3f} s; peak {peak_gb:.2f} GiB; "
        f"{served['bytes'] / 1e6:.1f} MB fetched in {served['gets']} GETs (the shards' {shard_bytes} bytes); spool "
        f"empty; {n_clips} samples bit-equal to the local route; trace {trace.name} {len(text) / 1e6:.1f} MB names "
        f"K1, K7, K8; epoch {epoch_s:.1f} s")
    del trainer, state, model, net, probe, rprobe, batches, rest
    return out


def interface_and_golden_checks(vae, clip_u8: np.ndarray) -> dict:
    """WanVAEInterface on one clip on the card with seeded statistics against
    the streaming encode, normalized; decode(encode(x)) shapes; golden dumps of
    small_reference's narrow 2B net, card bf16 (K1) against CPU fp32."""
    import dataclasses as dc

    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.tokenizers.interface import VAEInterfaceConfig, WanVAEInterface
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import encode_streaming
    from cosmos_predict2_tpu_torch.utils.golden_activations import compare_activation_dumps, dump_dit_activations

    fresh_memory()
    rng = np.random.default_rng(152)
    stats = dict(img_mean=rng.standard_normal((1, 16, 1, 1, 1)).astype(np.float32),
                 img_std=rng.uniform(0.5, 2.0, (1, 16, 1, 1, 1)).astype(np.float32),
                 video_mean=rng.standard_normal((1, 1, 50, 1, 1)).astype(np.float32),
                 video_std=rng.uniform(0.5, 2.0, (1, 1, 50, 1, 1)).astype(np.float32))
    tok = WanVAEInterface(VAEInterfaceConfig(vae=vae.config), vae, **stats)
    u8 = torch.from_numpy(clip_u8).cuda()[None]  # (1, T, H, W, 3)
    x = (u8.to(vae.config.dtype) / 127.5 - 1.0).permute(0, 4, 1, 2, 3)  # (1, 3, T, H, W)
    _build.reset_launch_counts()
    z = tok.encode(x)
    k2_encode = _build.launch_counts()["conv3d_causal"]
    stream = encode_streaming(vae, u8, pixel_format="uint8").permute(0, 4, 1, 2, 3).float()
    mean, std = tok._stats(stream.shape[2])
    _, rel = errors(z, (stream - mean) / std)
    px = tok.decode(z)
    t = tok.get_latent_num_frames(NUM_FRAMES)
    H, W = SIZE
    log(f"  WanVAEInterface on one clip (seeded statistics): encode {tuple(z.shape)} {z.dtype} against the streaming "
        f"encode normalized: rel_l2 {rel:.3e} (limit {ONESHOT_LATENT_REL_L2}); K2 {k2_encode} in the one-shot "
        f"encode; decode(encode(x)) {tuple(px.shape)}")
    if not (z.shape == (1, 16, t, H // 8, W // 8) and z.dtype == torch.float32 and rel <= ONESHOT_LATENT_REL_L2
            and px.shape == (1, 3, NUM_FRAMES, H, W) and bool(torch.isfinite(px).all()) and k2_encode > 0):
        raise AssertionError(f"WanVAEInterface: {tuple(z.shape)} rel_l2 {rel:.3e}, {tuple(px.shape)}, K2 {k2_encode}")
    del tok, z, px, stream, u8, x

    cfg = make_config(DENSE_EXPERIMENT)
    net_cfg = dc.replace(cfg.model.net, model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32,
                         crossattn_proj_in_channels=64, crossattn_emb_channels=128)
    net = build_dit(net_cfg, "cuda", seed=10)
    net32 = build_dit(dc.replace(net_cfg, dtype=torch.float32), "cpu", seed=0)
    net32.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    xs = torch.from_numpy(rng.standard_normal((1, 16, 4, 16, 24)).astype(np.float32))
    ts = torch.tensor([[0.6]])
    emb = torch.from_numpy(rng.standard_normal((1, 32, 64)).astype(np.float32))
    root = OUT_DIR / "golden"
    root.mkdir(parents=True, exist_ok=True)
    _build.reset_launch_counts()
    card = dump_dit_activations(net, xs.cuda(), ts.cuda(), emb.cuda(), str(root / "card.npz"))
    k1 = _build.launch_counts()["flash_attention_fwd"]
    cpu = dump_dit_activations(net32, xs, ts, emb, str(root / "cpu.npz"))
    diffs = compare_activation_dumps(str(root / "card.npz"), str(root / "cpu.npz"))
    rels = {k: float(np.linalg.norm(card[k] - cpu[k]) / max(np.linalg.norm(cpu[k]), 1e-30)) for k in cpu}
    names = {d.name for d in diffs}
    want = {f"block_{i:02d}" for i in range(net_cfg.num_blocks)} | {"output", "input"}
    log(f"  golden dumps of the narrow 2B net (2 blocks of 256), card bf16 (K1 {k1}) vs cpu fp32: rel_l2 " + ", ".join(
        f"{k} {v:.3e}" for k, v in sorted(rels.items())) + f" (limit {PIPELINE_REL_L2}); worst max_abs {diffs[0]}")
    if names != want or any(n.startswith("MISSING:") for n in names) or max(rels.values()) > PIPELINE_REL_L2 \
            or k1 != 2 * net_cfg.num_blocks:
        raise AssertionError(f"golden dumps: keys {sorted(names)}, rel_l2 {rels}, K1 {k1}")
    return {"interface_rel_l2": rel, "golden_rel_l2": rels}


def remote_shards_slice() -> dict:
    """Phase 15b: the shards written and put into the fake S3 store, the
    remote post-training epoch, then the interface and golden checks; the
    store is stopped and the files deleted at the end."""
    import shutil

    import torch

    from cosmos_predict2_tpu_torch.utils import easy_io
    from cosmos_predict2_tpu_torch.utils.remote_io import S3Backend

    root = OUT_DIR / "remote_shards"
    shutil.rmtree(root, ignore_errors=True)
    server, thread, url, served = fake_s3_store()
    try:
        t0 = time.perf_counter()
        shard_paths = write_remote_shards(root / "local", text_dim=100352)
        easy_io.register_backend("s3", S3Backend(access_key="chip", secret_key="smoke", endpoint_url=url))
        for p in shard_paths:  # a signed PUT each
            easy_io.get_backend("s3").put(p.read_bytes(), f"s3://bucket/{p.name}")
        log(f"  wrote {len(shard_paths)} shards ({sum(p.stat().st_size for p in shard_paths) / 1e6:.1f} MB) and put "
            f"them in the fake S3 store at {url} in {time.perf_counter() - t0:.1f} s")
        out = remote_posttrain(root, served, shard_paths)
        vae, clip = out.pop("vae"), out.pop("first_clip")
        out.update(interface_and_golden_checks(vae, clip))
        del vae
    finally:
        easy_io._BACKENDS.pop("s3", None)
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(OUT_DIR / "golden", ignore_errors=True)
    fresh_memory()
    torch.cuda.synchronize()
    return out


def dit_forward_flops(net, batch: int, tokens: int, ctx_tokens: int) -> float:
    """The multiply-adds (x2) of one DiT forward over ``tokens`` tokens per
    sample: per block the q/k/v/o and MLP products (28 S D^2 with the
    cross-attention's q and o), self-attention 4 S^2 D, cross-attention's
    k and v of the caption and 4 S M D against each view's M = ctx_tokens /
    n_views caption tokens; and the caption projection."""
    D, S, M = net.model_channels, tokens, ctx_tokens
    per_block = 28 * S * D * D + 4 * S * S * D + 4 * M * net.crossattn_emb_channels * D + 4 * S * (M // net.n_views) * D
    proj = 2 * M * net.crossattn_proj_in_channels * net.crossattn_emb_channels if net.use_crossattn_projection else 0
    return batch * (net.num_blocks * per_block + proj)


class ForwardTimer:
    """Times each forward of ``net`` on the host clock between device
    synchronizes (one forward is one batched-CFG denoise step), runs the
    forward numbered ``profile_index`` under torch.profiler (``profile``:
    device time by kernel family) and splits the peak device memory since
    the caller's last ``reset_peak_memory_stats``: ``forward_peak_gb``
    inside the forwards, ``before_gb`` before the first (the VAE encode),
    ``after_gb`` after the last (the decode; read by :meth:`remove`) and
    ``outside_peak_gb`` anywhere outside them."""

    def __init__(self, net, profile_index: int | None = None):
        import torch

        self.seconds: list[float] = []
        self.forward_peak_gb = self.outside_peak_gb = self.before_gb = self.after_gb = 0.0
        self.profile, self.profile_index = None, profile_index
        self._t, self._prof, self._prof_s = 0.0, None, None

        def start(*_):
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            if not self.seconds:
                self.before_gb = peak
            self.outside_peak_gb = max(self.outside_peak_gb, peak)
            torch.cuda.reset_peak_memory_stats()
            if len(self.seconds) == profile_index:
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                self._prof = torch.profiler.profile(activities=acts)
                self._prof.__enter__()
                torch.cuda.synchronize()
            self._t = time.perf_counter()  # inside the profiler: its start and teardown are not the forward's

        def stop(*_):
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - self._t)
            self.forward_peak_gb = max(self.forward_peak_gb, torch.cuda.max_memory_allocated() / 2**30)
            if self._prof is not None and self._prof_s is None:
                self._prof.__exit__(None, None, None)
                self._prof_s = self.seconds[-1]
            torch.cuda.reset_peak_memory_stats()

        self.handles = [net.register_forward_pre_hook(start), net.register_forward_hook(stop)]

    def remove(self) -> float:
        """Detach the hooks; returns the request's peak (GiB)."""
        import torch

        for h in self.handles:
            h.remove()
        self.after_gb = torch.cuda.max_memory_allocated() / 2**30
        self.outside_peak_gb = max(self.outside_peak_gb, self.after_gb)
        if self._prof is not None:
            log(f"  forward {self.profile_index} of the request (one batched-CFG denoise step) under torch.profiler:")
            self.profile = device_time_table(self._prof, self._prof_s)
        return max(self.outside_peak_gb, self.forward_peak_gb)


def _variant_net(experiment: str, net_cfg=None):
    """The full-width 2B DiT of ``experiment`` on seeded random bf16 matmul
    weights and its VAE."""
    import torch

    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.networks.dit import build_serving_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae

    cfg = make_config(experiment)
    net_cfg = net_cfg or cfg.model.net
    if (net_cfg.model_channels, net_cfg.num_blocks, net_cfg.num_heads, net_cfg.head_dim) != (2048, NUM_BLOCKS, 16, 128):
        raise AssertionError(f"{experiment}: the slice must run the full-width 2B DiT")
    fresh_memory()
    t = time.perf_counter()
    net = build_serving_dit(net_cfg, "cuda", seed=0)
    vae = build_vae(cfg.tokenizer, "cuda", seed=1)
    torch.cuda.synchronize()
    log(f"  {experiment}: {sum(p.numel() for p in net.parameters()) / 1e9:.3f} B DiT params, VAE dim "
        f"{cfg.tokenizer.dim}: built in {time.perf_counter() - t:.1f} s")
    return cfg, net, vae


def multiview_slice() -> dict:
    """One video2world request of the 7-view model through MultiviewInference:
    7 views of 29 frames at 704x1280 (197,120 DiT tokens), conditioned on 2
    latent frames of every view, guidance 7, MULTIVIEW_STEPS steps."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.inference.multiview import MultiviewInference, MultiviewInferenceArguments
    from cosmos_predict2_tpu_torch.models.multiview import MultiviewVid2VidModel

    cfg, net, vae = _variant_net(MULTIVIEW_EXPERIMENT)
    V = cfg.model.net.n_views
    H, W = VARIANT_HW
    model = MultiviewVid2VidModel(cfg.model, net)
    emb = torch.randn((1, 512, cfg.model.net.crossattn_proj_in_channels), generator=torch.Generator().manual_seed(13))
    pipe = MultiviewInference(model, vae, text_encoder=lambda prompts: emb, height=H, width=W)
    if pipe.frames_per_view != VARIANT_FRAMES or V != 7:
        raise AssertionError(f"multiview geometry: {V} views of {pipe.frames_per_view} frames")
    videos = np.random.default_rng(14).integers(0, 256, (V, 9, H, W, 3), dtype=np.uint8)
    args = MultiviewInferenceArguments(prompt="a drive", inference_type="video2world", n_views=V,
                                       num_steps=MULTIVIEW_STEPS, guidance=GUIDANCE)
    timer = ForwardTimer(net, profile_index=MULTIVIEW_STEPS - 1)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t = time.perf_counter()
    frames, grid = pipe.generate(args, videos)
    request_s = time.perf_counter() - t
    counts = _build.launch_counts()
    peak_gb = timer.remove()
    if frames.shape != (V, VARIANT_FRAMES, H, W, 3) or frames.dtype != np.uint8 or frames[:, -1].std() == 0:
        raise AssertionError(f"multiview output {frames.shape} {frames.dtype}")
    if grid.shape != (VARIANT_FRAMES, 2 * H, 4 * W, 3):
        raise AssertionError(f"multiview grid {grid.shape}")
    check_launches("multiview", counts, MULTIVIEW_STEPS * 2 * NUM_BLOCKS)
    tokens = cfg.model.state_t * (H // 16) * (W // 16)
    flops = dit_forward_flops(cfg.model.net, 2, tokens, V * 512)
    tm = pipe.last_timings
    steps = timer.seconds
    log(f"  multiview video2world: {V} views x {VARIANT_FRAMES} frames at {H}x{W}, {tokens:,} tokens, "
        f"{MULTIVIEW_STEPS} steps: request {request_s:.2f} s, denoise {tm['denoise_s']:.2f} s")
    for i, sec in enumerate(steps):
        log(f"    step {i}: {sec:.3f} s, {flops / 1e15:.2f} PFLOP: {flops / sec / 1e12:.1f} TFLOP/s, "
            f"{flops / sec / PEAK_BF16_FLOPS:.1%} of the bf16 peak")
    log(f"    VAE encode per view {[round(x, 2) for x in tm['vae_encode_s']]} s, decode per view "
        f"{[round(x, 2) for x in tm['vae_decode_s']]} s; peak {peak_gb:.2f} GiB ({timer.forward_peak_gb:.2f} in the "
        f"DiT forwards, {timer.before_gb:.2f} before the first (text and VAE encode of {V} views), "
        f"{timer.after_gb:.2f} after the last (VAE decode of {V} views)); launches {counts}")
    del pipe, model, net, vae, frames, grid
    return {"counts": counts, "request_s": request_s, "step_s": steps, "step_flops": flops, "profile": timer.profile,
            "encode_peak_gb": timer.before_gb, "decode_peak_gb": timer.after_gb,
            "step_share_of_peak": [flops / x / PEAK_BF16_FLOPS for x in steps], "vae_encode_s": tm["vae_encode_s"],
            "vae_decode_s": tm["vae_decode_s"], "denoise_s": tm["denoise_s"], "peak_gb": peak_gb,
            "forward_peak_gb": timer.forward_peak_gb, "outside_peak_gb": timer.outside_peak_gb, "tokens": tokens}


def small_cross_view_reference() -> dict:
    """A narrow 7-view net (2 blocks) with cross-view attention over a ring
    (each view attends its two neighbours) at the 44 x 80 token grid, one
    latent frame per view: one forward in bf16 on the card against the same
    weights in fp32 on the CPU; K1 2 x (2 + 7) times."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.networks.dit import build_dit

    V = 7
    ring = tuple(((v - 1) % V, (v + 1) % V) for v in range(V))
    net_cfg = dataclasses.replace(
        make_config(MULTIVIEW_EXPERIMENT).model.net, model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32,
        crossattn_proj_in_channels=64, crossattn_emb_channels=128, tokens_per_view=16, enable_cross_view_attn=True,
        cross_view_attn_map=ring,
    )
    net = build_dit(net_cfg, "cuda", seed=15)
    net32 = build_dit(dataclasses.replace(net_cfg, dtype=torch.float32), "cpu", seed=0)
    net32.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    rng = np.random.default_rng(16)
    h, w = 2 * INTERACTIVE_HW[0], 2 * INTERACTIVE_HW[1]
    x = torch.from_numpy(rng.standard_normal((1, 16, V, h, w)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, V * 16, 64)).astype(np.float32))
    t = torch.tensor([600.0])
    with torch.no_grad():
        _build.reset_launch_counts()
        got = net(x.cuda(), t.cuda(), ctx.cuda()).float().cpu()
        counts = _build.launch_counts()
        ref = net32(x, t, ctx)
    max_abs, rel = errors(got, ref)
    want = net_cfg.num_blocks * (2 + V)
    log(f"  narrow 7-view net with cross-view attention ({V * h * w // 4:,} tokens; cross-view B1 Sq{h * w // 4} "
        f"Skv{2 * h * w // 4}): card bf16 vs cpu fp32 max_abs {max_abs:.3e} rel_l2 {rel:.3e} (limit "
        f"{PIPELINE_REL_L2}); launches {counts}")
    if counts["flash_attention_fwd"] != want or not torch.isfinite(got).all() or rel > PIPELINE_REL_L2:
        raise AssertionError(f"the cross-view net: K1 {counts['flash_attention_fwd']} (want {want}), rel_l2 {rel:.3e}")
    return {"counts": counts, "rel_l2": rel, "max_abs": max_abs}


def camera_slice() -> dict:
    """The camera-conditioned model: a 29-frame 704x1280 clip encoded and
    packed [0 | clip | 0] into 24 latent frames (84,480 tokens), Plücker
    rays of a seeded camera track at the 44 x 80 token grid reordered to the
    model's chunk order, CAMERA_STEPS steps at guidance 1.5, each generated
    chunk decoded as its own 29-frame clip."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.models.camera import CameraVideo2WorldModel, reorder_camera_chunks
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import decode_streaming, encode_streaming, truncate_u8
    from cosmos_predict2_tpu_torch.utils import camera_math as cm
    from cosmos_predict2_tpu_torch.utils.misc import arch_invariant_rand

    cfg, net, vae = _variant_net(CAMERA_EXPERIMENT)
    model = CameraVideo2WorldModel(cfg.model, net)
    H, W = VARIANT_HW
    gh, gw = H // 16, W // 16
    tc = 1 + (VARIANT_FRAMES - 1) // 4  # latent frames per chunk
    rng = np.random.default_rng(17)
    clip = torch.from_numpy(rng.integers(0, 256, (1, VARIANT_FRAMES, H, W, 3), dtype=np.uint8)).cuda()
    # a camera track: 3 chunks of tc poses (the input chunk first), a slow yaw and a sideways drift
    n = 3 * tc
    yaw = torch.linspace(0.0, 0.6, n)
    q = torch.stack([torch.zeros(n), torch.sin(yaw / 2), torch.zeros(n), torch.cos(yaw / 2)], dim=-1)
    params = torch.cat([q, torch.stack([torch.linspace(-1.0, 1.0, n), torch.zeros(n), torch.zeros(n)], dim=-1)], dim=-1)
    poses = cm.extrinsic_params_to_matrices(params)
    intr = cm.intrinsic_params_to_matrices(torch.tensor([[gw * 0.9, gw * 0.9, gw / 2, gh / 2]]).expand(n, 4))
    rays = cm.get_plucker_rays(poses, intr, (gh, gw)).reshape(1, n, gh, gw, 6)
    camera = reorder_camera_chunks(rays, 3).cuda()
    emb = torch.randn((1, 512, cfg.model.net.crossattn_proj_in_channels), generator=torch.Generator().manual_seed(18))
    timer = ForwardTimer(net, profile_index=CAMERA_STEPS - 1)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        latents = encode_streaming(vae, clip, pixel_format="uint8").permute(0, 4, 1, 2, 3).float()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gt = model.pack_inference_latents(latents)
        condition = make_condition(emb.cuda()).replace(gt_frames=gt, camera=camera)
        noise = arch_invariant_rand(tuple(gt.shape), seed=1, device=gt.device)
        samples = model.generate(noise, condition, guidance=CAMERA_GUIDANCE, num_steps=CAMERA_STEPS,
                                 num_conditional_frames=tc)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        outs = [truncate_u8(decode_streaming(vae, samples[:, :, i * tc : (i + 1) * tc].to(torch.bfloat16)
                                             .permute(0, 2, 3, 4, 1))[0]).cpu().numpy() for i in (0, 2)]
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = _build.launch_counts()
    peak_gb = timer.remove()
    tokens = 3 * tc * gh * gw
    if gt.shape[2] != 3 * tc or not torch.isfinite(samples).all():
        raise AssertionError(f"camera latents {tuple(gt.shape)}, {tokens} tokens")
    for out in outs:
        if out.shape != (VARIANT_FRAMES, H, W, 3) or out.std() == 0:
            raise AssertionError(f"camera output chunk {out.shape}")
    check_launches("camera", counts, CAMERA_STEPS * 2 * NUM_BLOCKS)
    flops = dit_forward_flops(cfg.model.net, 2, tokens, 512)
    log(f"  camera: {tokens:,} tokens, {CAMERA_STEPS} steps at guidance {CAMERA_GUIDANCE}: encode {t1 - t0:.2f} s, "
        f"denoise {t2 - t1:.2f} s (steps {[round(x, 3) for x in timer.seconds]} s, "
        f"{flops / min(timer.seconds) / PEAK_BF16_FLOPS:.1%} of the bf16 peak at best), two chunks decoded "
        f"{t3 - t2:.2f} s; peak {peak_gb:.2f} GiB ({timer.forward_peak_gb:.2f} in the DiT forwards, "
        f"{timer.before_gb:.2f} before the first (VAE encode), {timer.after_gb:.2f} after the last (two chunks "
        f"decoded)); launches {counts}")
    del model, net, vae, samples, latents, gt, condition
    return {"counts": counts, "step_s": timer.seconds, "step_flops": flops, "profile": timer.profile,
            "encode_peak_gb": timer.before_gb, "decode_peak_gb": timer.after_gb, "encode_s": t1 - t0, "denoise_s": t2 - t1,
            "decode_s": t3 - t2, "peak_gb": peak_gb, "forward_peak_gb": timer.forward_peak_gb,
            "outside_peak_gb": timer.outside_peak_gb, "tokens": tokens}


def action_slice() -> dict:
    """The action-conditioned model at 2B width with 12 actions of 7 per
    chunk (what get_action_sequence_from_states gives for a 13-frame clip;
    the registry's 84 x 12 cannot take it) through ActionConditionedInference:
    13 frames at 256x320 (1,280 tokens), all 35 steps, guidance 3."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.action_conditioned import (
        ActionConditionedInference,
        action_conditioned_model_config,
        get_action_sequence_from_states,
    )
    from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel

    base = make_config(ACTION_EXPERIMENT).model
    mc = action_conditioned_model_config(base.net, action_dim=7, num_action_per_chunk=12, state_t=base.state_t)
    cfg, net, vae = _variant_net(ACTION_EXPERIMENT, mc.net)
    pipe = ActionConditionedInference(Video2WorldModel(mc, net), vae)
    H, W = ACTION_HW
    rng = np.random.default_rng(19)
    arm = np.cumsum(rng.standard_normal((ACTION_FRAMES, 6)) * 0.01, axis=0)
    actions = get_action_sequence_from_states(arm, rng.uniform(0, 1, ACTION_FRAMES))
    video = np.zeros((1, ACTION_FRAMES, H, W, 3), np.uint8)
    video[:, 0] = rng.integers(0, 256, (H, W, 3))
    emb = rng.standard_normal((1, 512, net.cfg.crossattn_proj_in_channels)).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t = time.perf_counter()
    frames = pipe.generate(video, actions, emb, guidance=ACTION_GUIDANCE, num_steps=NUM_STEPS)
    request_s = time.perf_counter() - t
    counts = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if actions.shape != (12, 7) or frames.shape != (ACTION_FRAMES, H, W, 3) or frames.std() == 0:
        raise AssertionError(f"action request: actions {actions.shape}, output {frames.shape}")
    check_launches("action", counts, NUM_STEPS * 2 * NUM_BLOCKS)
    tm = pipe.last_timings
    log(f"  action: {mc.state_t * (H // 16) * (W // 16):,} tokens, {NUM_STEPS} steps: request {request_s:.2f} s "
        f"(encode {tm['vae_encode_s']:.2f} s, denoise {tm['denoise_s']:.2f} s = "
        f"{tm['denoise_s'] / NUM_STEPS * 1e3:.1f} ms/step, decode {tm['vae_decode_s']:.2f} s); peak {peak_gb:.2f} GiB; "
        f"launches {counts}")
    del pipe, net, vae
    return {"counts": counts, "request_s": request_s, **tm, "peak_gb": peak_gb}


def variants_slice() -> dict:
    """Phase 16: the post-trained 2B variants."""
    mv = multiview_slice()
    cross_view = small_cross_view_reference()
    cam = camera_slice()
    act = action_slice()
    fresh_memory()
    return {"multiview": mv, "cross_view": cross_view, "camera": cam, "action": act}


# ------------------- the rest of A13 and A12.2 (phase 17) -------------------

GR00T_EXPERIMENTS = ("cosmos_predict2p5_2B_action_conditioned_gr00t_gr1_customized_13frame_sf_warmup",
                     "cosmos_predict2p5_2B_action_gr00t_gr1_warmup")
GR00T_BLOCKS = 6
GR00T_STEPS = 4
WAN_HW = (480, 832)
WAN_FRAMES = 81
WAN_STEPS = 3
WAN_GUIDANCE = 5.0
WAN22_HW = (704, 1280)
WAN22_FRAMES = 121
SPARSE_14B_EXPERIMENTS = ("predict2_video2world_14b_sparse", "predict2_video2world_14b_sparse_comb02")
SPARSE_14B_LATENT = (24, 88, 160)  # 93 frames at 704x1280: 24 x 44 x 80 = 84,480 tokens
# The narrow versions of phase 17's paths in bf16 on the card against fp32
# on the CPU. On the CPU, bf16 against fp32 (same weights, inputs and noise;
# relative L2) gives: the small Wan i2v request (2 layers, dim 256, VAE dim
# 64, 2 steps at guidance 5) 1.07e-2 on the latents and 1.66e-2 on the
# pixels; the small Wan2.2 VAE round trip (dim 64) 1.18e-2 and 1.79e-2; the
# small EDM request (4 steps at guidance 2 from sigma 80, VAE dim 64)
# 1.81e-2 and 2.24e-2; the small sparse step (a comb02-kind per-layer list,
# one UniPC step at guidance 7) 2.75e-2; the small action stream (the gr00t
# action width on the narrow causal net) 3.53e-3; about 3x margin on each.
WAN_SMALL_REL_L2 = 5e-2
WAN22_SMALL_REL_L2 = 6e-2
EDM_SMALL_REL_L2 = 7e-2
SPARSE_SMALL_REL_L2 = 8e-2
ACTION_STREAM_REL_L2 = 1e-2


def _cpu_fp32(module_cls, cfg, state_dict):
    """``module_cls(cfg)`` in fp32 on the CPU holding ``state_dict`` (the
    card's weights, upcast)."""
    import torch

    m = module_cls(dataclasses.replace(cfg, dtype=torch.float32))
    m.load_state_dict({k: v.float().cpu() for k, v in state_dict.items()})
    return m.eval().requires_grad_(False)


def small_action_stream(device: str, dtype, state_dict=None):
    """small_stream's narrow causal net with the gr00t names' action
    embedders (84 x 12 inputs) streaming 3 one-frame blocks of 4 steps after
    one prefilled frame, cache 2 + 1 frames, one seeded action chunk.
    Returns (latents fp32 on the CPU, launches, state_dict)."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.scripts.interactive_latency import NET_TINY, build_stream

    stream = build_stream(dataclasses.replace(NET_TINY, dtype=dtype, action_dim=7 * 12), 1, 2, 4, -1, device, seed=30)
    if state_dict is not None:
        stream.model.net.load_state_dict(state_dict)
    rng = np.random.default_rng(1)
    emb = torch.from_numpy((rng.standard_normal((1, 8, 1024)) * 0.05).astype(np.float32)).to(device)
    action = torch.from_numpy(rng.standard_normal((1, 12, 7 * 12)).astype(np.float32)).to(device)
    init = torch.from_numpy(rng.standard_normal((1, 16, 1, 16, 24)).astype(np.float32)).to(device)
    draw = lambda step, shape: torch.from_numpy(np.random.default_rng(200 + step).standard_normal(shape).astype(np.float32))
    _build.reset_launch_counts()
    out = stream.generate(make_condition(emb).replace(action=action), init, 4, (16, 24), draw=draw)
    counts = _build.launch_counts()
    return out.float().cpu(), counts, {k: v.cpu() for k, v in stream.model.net.state_dict().items()}


def gr00t_slice() -> dict:
    """The two gr00t names (one config, checked equal: the causal 2B with
    action embedders of 84 x 12 inputs, 4 latent frames) on seeded random
    bf16 matmul weights: StreamingInference streams GR00T_BLOCKS one-frame
    blocks of GR00T_STEPS steps at 256x320 after one prefilled frame, a
    cache of state_t + 1 frames (the window slides), one seeded action
    chunk; the first name's stream, then the same with the action zeroed on
    the same noise. Then the narrow stream card bf16 against CPU fp32."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.interactive import CausalVideo2WorldModel, StreamingConfig, StreamingInference
    from cosmos_predict2_tpu_torch.networks.dit import build_serving_dit

    models = [make_config(n).model for n in GR00T_EXPERIMENTS]
    mc = models[0]
    net_cfg = mc.net
    if models[1] != mc or (net_cfg.action_dim, net_cfg.num_action_per_chunk, mc.state_t) != (84, 12, 4) or \
            not net_cfg.temporal_causal or (net_cfg.model_channels, net_cfg.num_blocks) != (2048, NUM_BLOCKS):
        raise AssertionError("the gr00t names must give one causal 2B model with 84 x 12 action inputs")
    fresh_memory()
    t = time.perf_counter()
    net = build_serving_dit(net_cfg, "cuda", seed=21)
    stream = StreamingInference(StreamingConfig(num_frame_per_block=1, cache_frame_size=mc.state_t,
                                                num_steps=GR00T_STEPS), CausalVideo2WorldModel(mc, net))
    torch.cuda.synchronize()
    log(f"  causal 2B with action embedders built in {time.perf_counter() - t:.1f} s")
    h, w = ACTION_HW[0] // 8, ACTION_HW[1] // 8
    rng = np.random.default_rng(22)
    emb = torch.from_numpy(rng.standard_normal((1, 512, net_cfg.crossattn_proj_in_channels)).astype(np.float32)).cuda()
    action = torch.from_numpy(rng.standard_normal((1, net_cfg.num_action_per_chunk, net_cfg.action_dim))
                              .astype(np.float32)).cuda()
    init = torch.from_numpy(rng.standard_normal((1, 16, 1, h, w)).astype(np.float32)).cuda()
    draw = lambda step, shape: torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(300 + step),
                                           device="cuda")
    cond = make_condition(emb).replace(action=action)
    out = {}
    for name in GR00T_EXPERIMENTS[:1]:  # the second name builds the same model
        laps, state = [], {}

        def on_block(step, x, caches):
            torch.cuda.synchronize()
            laps.append(time.perf_counter() - state["t"])
            state["t"] = time.perf_counter()

        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        state["t"] = t = time.perf_counter()
        latents = stream.generate(cond, init, 1 + GR00T_BLOCKS, (h, w), draw=draw, on_block=on_block)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t
        counts = _build.launch_counts()
        want = NUM_BLOCKS * (1 + GR00T_BLOCKS * (GR00T_STEPS + 1))
        if (counts["flash_attention_kv_cache"], counts["flash_attention_fwd"]) != (want, want) or \
                sum(counts.values()) != 2 * want:
            raise AssertionError(f"{name}: launches {counts}, want K5 and K1 {want} times each")
        if latents.shape != (1, 16, 1 + GR00T_BLOCKS, h, w) or not bool(torch.isfinite(latents).all()):
            raise AssertionError(f"{name}: streamed latents {tuple(latents.shape)}")
        out[name] = {"counts": counts, "latents": latents, "total_s": total_s, "laps": laps,
                     "p50_s": float(np.median(laps[1:])), "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
        log(f"  {name}: {GR00T_BLOCKS} blocks of {GR00T_STEPS} steps at {ACTION_HW[0]}x{ACTION_HW[1]} "
            f"({h // 2 * w // 2} tokens a frame, cache {mc.state_t} + 1 frames): {total_s:.2f} s, first block with "
            f"the prefill {laps[0] * 1e3:.1f} ms, p50 block {out[name]['p50_s'] * 1e3:.1f} ms; peak "
            f"{out[name]['peak_gb']:.2f} GiB; launches {counts}")
    first = out[GR00T_EXPERIMENTS[0]]
    zero = stream.generate(cond.replace(action=torch.zeros_like(action)), init, 1 + GR00T_BLOCKS, (h, w), draw=draw)
    moved = float((first["latents"][:, :, 1:] - zero[:, :, 1:]).abs().max())
    log(f"  the action reaches the output: max |stream - stream with the action zeroed| {moved:.3e}")
    if not moved > 1e-2:
        raise AssertionError(f"zeroing the action moved the stream by {moved:.3e}")
    del stream, net, zero
    fresh_memory()

    got, counts, sd = small_action_stream("cuda", torch.bfloat16)
    ref, _, _ = small_action_stream("cpu", torch.float32, sd)
    max_abs, rel = errors(got, ref)
    want = 2 * (1 + 3 * 5)
    log(f"  narrow action stream: card bf16 vs cpu fp32: max_abs {max_abs:.3e} rel_l2 {rel:.3e} (limit "
        f"{ACTION_STREAM_REL_L2}); launches {counts}")
    if (counts["flash_attention_kv_cache"], counts["flash_attention_fwd"]) != (want, want):
        raise AssertionError(f"the narrow action stream launched {counts}, want K5 and K1 {want} times each")
    if not (torch.isfinite(got).all() and rel <= ACTION_STREAM_REL_L2):
        raise AssertionError(f"the narrow action stream disagrees with its fp32 CPU reference: rel_l2 {rel:.3e}")
    return {name: {k: v for k, v in o.items() if k != "latents"} for name, o in out.items()} | {
        "counts": first["counts"], "action_moved": moved, "narrow_rel_l2": rel}


def wan_forward_flops(cfg, batch: int, tokens: int) -> float:
    """Multiply-adds (x2) of one WanModel forward: per layer the self q/k/v/o
    and FFN products, the cross q/o, self-attention 4 S^2 D and the two
    cross-attentions 4 S (512 + 257) D (the context's k/v projections are
    left out: 769 rows)."""
    D, S = cfg.dim, tokens
    per_layer = 2 * S * (6 * D * D + 2 * D * cfg.ffn_dim) + 4 * S * S * D + 4 * S * (512 + 257) * D
    return batch * cfg.num_layers * per_layer


def small_wan(device: str, dtype, state=None):
    """A narrow Wan i2v (2 layers, dim 256: 2 heads of 128) through
    models/wan_video2world.image2world with a dim-64 Wan2.1 VAE: 5 frames at
    64x96, 2 UniPC steps at guidance 5, the noise from a CPU generator.
    Returns (latents, pixels fp32 on the CPU, launches, (net, vae) state
    dicts)."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.models.wan_video2world import WanModelConfig, WanVideo2WorldModel, image2world
    from cosmos_predict2_tpu_torch.networks.wan_dit import WanConfig, WanModel, build_wan
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE, WanVAEConfig, build_vae

    cfg = WanConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=64, clip_dim=64, dtype=dtype)
    vc = WanVAEConfig(dim=64, dtype=dtype)
    if state is None:
        net, vae = build_wan(cfg, device, seed=31), build_vae(vc, device, seed=32)
    else:
        net, vae = _cpu_fp32(WanModel, cfg, state[0]), _cpu_fp32(WanVAE, vc, state[1])
    rng = np.random.default_rng(3)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    frame = t(rng.uniform(-1, 1, (1, 64, 96, 3)))
    text, clip = t(rng.standard_normal((1, 512, 64))), t(rng.standard_normal((1, 257, 64)))
    model = WanVideo2WorldModel(WanModelConfig(net=net.cfg, state_t=2), net)
    _build.reset_launch_counts()
    latents, px = image2world(model, vae, frame, text, clip, torch.Generator().manual_seed(4), num_frames=5,
                              guidance=WAN_GUIDANCE, num_steps=2)
    counts = _build.launch_counts()
    return latents.float().cpu(), px.float().cpu(), counts, (net.state_dict(), vae.state_dict())


def wan_slice() -> dict:
    """Wan2.1 1.3B i2v (dim 1536, 12 heads of 128, 30 layers, in_dim 36) on
    seeded random bf16 matmul weights with the full Wan2.1 VAE: one
    image2world request, 81 frames at 480x832 (21 x 60 x 104 latents: the
    DiT sees 32,760 tokens), WAN_STEPS UniPC steps with CFG against zero
    text at batch 2, the VAE decode; the CLIP tokens (257 x 1280) seeded.
    Then the narrow request card bf16 against CPU fp32."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.models.wan_video2world import WanModelConfig, WanVideo2WorldModel, image2world
    from cosmos_predict2_tpu_torch.networks.wan_dit import WAN_PRESETS, build_wan
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAEConfig, build_vae

    cfg = WAN_PRESETS["1.3B"]
    if (cfg.dim, cfg.num_heads, cfg.head_dim, cfg.num_layers, cfg.in_dim) != (1536, 12, 128, 30, 36):
        raise AssertionError("the Wan slice must run the 1.3B preset")
    fresh_memory()
    t = time.perf_counter()
    net = build_wan(cfg, "cuda", seed=23)
    vae = build_vae(WanVAEConfig(), "cuda", seed=24)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in net.parameters())
    log(f"  Wan 1.3B: {n / 1e9:.3f} B params built in {time.perf_counter() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card with the VAE")
    H, W = WAN_HW
    gen = torch.Generator(device="cuda").manual_seed(25)
    frame = torch.rand((1, H, W, 3), generator=gen, device="cuda") * 2 - 1
    text = torch.randn((1, 512, cfg.text_dim), generator=gen, device="cuda")
    clip = torch.randn((1, 257, cfg.clip_dim), generator=gen, device="cuda")
    model = WanVideo2WorldModel(WanModelConfig(net=cfg), net)
    timer = ForwardTimer(net, profile_index=WAN_STEPS - 1)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    latents, px = image2world(model, vae, frame, text, clip, torch.Generator(device="cuda").manual_seed(26),
                              num_frames=WAN_FRAMES, guidance=WAN_GUIDANCE, num_steps=WAN_STEPS)
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    peak_gb = timer.remove()
    tokens = latents.shape[2] * (latents.shape[3] // 2) * (latents.shape[4] // 2)
    if latents.shape != (1, 16, 21, 60, 104) or tokens != 32760 or px.shape != (1, WAN_FRAMES, H, W, 3) or \
            not bool(torch.isfinite(px).all()) or float(px.float().std()) == 0:
        raise AssertionError(f"Wan request: latents {tuple(latents.shape)}, pixels {tuple(px.shape)}")
    check_launches("wan", counts, WAN_STEPS * 3 * cfg.num_layers)
    flops = wan_forward_flops(cfg, 2, tokens)
    denoise_s = sum(timer.seconds)
    log(f"  Wan i2v: {tokens:,} tokens, {WAN_STEPS} steps with batched CFG: request {request_s:.2f} s (encode "
        f"{timer.before_gb:.2f} GiB peak, steps {[round(x, 3) for x in timer.seconds]} s = "
        f"{flops / 1e12:.0f} TFLOP each, {flops / min(timer.seconds) / PEAK_BF16_FLOPS:.1%} of the bf16 peak at best; "
        f"encode + decode {request_s - denoise_s:.2f} s); peak {peak_gb:.2f} GiB (forwards "
        f"{timer.forward_peak_gb:.2f}, decode {timer.after_gb:.2f}); launches {counts}")
    del net, vae, model, latents, px
    fresh_memory()

    got_z, got_px, small_counts, state = small_wan("cuda", torch.bfloat16)
    ref_z, ref_px, _, _ = small_wan("cpu", torch.float32, state)
    rel_z, rel_px = errors(got_z, ref_z)[1], errors(got_px, ref_px)[1]
    log(f"  narrow Wan i2v: card bf16 vs cpu fp32: latents rel_l2 {rel_z:.3e}, pixels rel_l2 {rel_px:.3e} (limit "
        f"{WAN_SMALL_REL_L2}); launches {small_counts}")
    check_launches("narrow wan", small_counts, 2 * 3 * 2)
    if not max(rel_z, rel_px) <= WAN_SMALL_REL_L2:
        raise AssertionError(f"the narrow Wan request disagrees with its fp32 CPU reference: {rel_z:.3e} {rel_px:.3e}")
    return {"counts": counts, "request_s": request_s, "step_s": timer.seconds, "step_flops": flops,
            "tokens": tokens, "peak_gb": peak_gb, "forward_peak_gb": timer.forward_peak_gb,
            "encode_peak_gb": timer.before_gb, "decode_peak_gb": timer.after_gb, "profile": timer.profile,
            "narrow_rel_l2": max(rel_z, rel_px)}


def small_wan22(device: str, dtype, state=None):
    """A narrow Wan2.2 VAE (dim 64, dec_dim 64: every encoder conv and the
    decoder's wide ones take K2 on the card) round trip of 9 frames at
    64x64, streaming. Returns (latents, pixels fp32 on the CPU, launches,
    state dict)."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.tokenizers.wan22_vae import Wan22VAE, Wan22VAEConfig, build_vae
    from cosmos_predict2_tpu_torch.tokenizers.wan22_vae_streaming import decode_streaming, encode_streaming

    vc = Wan22VAEConfig(dim=64, dec_dim=64, dtype=dtype)
    vae = build_vae(vc, device, seed=33) if state is None else _cpu_fp32(Wan22VAE, vc, state)
    x = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (1, 9, 64, 64, 3)).astype(np.float32)).to(device)
    _build.reset_launch_counts()
    z = encode_streaming(vae, x.to(dtype))
    px = decode_streaming(vae, z)
    counts = _build.launch_counts()
    return z.float().cpu(), px.float().cpu(), counts, vae.state_dict()


def wan22_vae_slice() -> dict:
    """The Wan2.2 VAE (dim 160, dec_dim 256, z_dim 48) on seeded random
    weights: a streaming round trip of a seeded 121-frame 704x1280 clip (31
    x 44 x 80 x 48 latents), the encode in chunks [1, 4, ...] and the
    decode one latent frame at a time; times and peak memory of each. Then
    the narrow round trip card bf16 against CPU fp32."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.tokenizers.wan22_vae import Wan22VAEConfig, build_vae
    from cosmos_predict2_tpu_torch.tokenizers.wan22_vae_streaming import decode_streaming, encode_streaming

    fresh_memory()
    vae = build_vae(Wan22VAEConfig(), "cuda", seed=27)
    H, W = WAN22_HW
    x = (torch.rand((1, WAN22_FRAMES, H, W, 3), generator=torch.Generator(device="cuda").manual_seed(28),
                    device="cuda") * 2 - 1).to(torch.bfloat16)
    base = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = encode_streaming(vae, x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    enc_counts = _build.launch_counts()
    enc_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    px = decode_streaming(vae, z)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _build.launch_counts()
    dec_peak = torch.cuda.max_memory_allocated() / 2**30
    if z.shape != (1, 31, 44, 80, 48) or px.shape != (1, WAN22_FRAMES, H, W, 3) or \
            not (bool(torch.isfinite(z).all()) and bool(torch.isfinite(px).all())) or float(px.float().std()) == 0:
        raise AssertionError(f"Wan2.2 round trip: latents {tuple(z.shape)}, pixels {tuple(px.shape)}")
    check_launches("wan2.2 vae", counts, 0)
    log(f"  Wan2.2 VAE round trip of {WAN22_FRAMES} x {H}x{W}: encode {t1 - t0:.2f} s (peak {enc_peak:.2f} GiB, "
        f"K2 {enc_counts['conv3d_causal']}), decode {t2 - t1:.2f} s (peak {dec_peak:.2f} GiB, K2 "
        f"{counts['conv3d_causal'] - enc_counts['conv3d_causal']}); {base:.2f} GiB held before (weights and clip)")
    del vae, x, z, px
    fresh_memory()

    got_z, got_px, small_counts, sd = small_wan22("cuda", torch.bfloat16)
    ref_z, ref_px, _, _ = small_wan22("cpu", torch.float32, sd)
    rel_z, rel_px = errors(got_z, ref_z)[1], errors(got_px, ref_px)[1]
    log(f"  narrow Wan2.2 VAE: card bf16 vs cpu fp32: latents rel_l2 {rel_z:.3e}, pixels rel_l2 {rel_px:.3e} "
        f"(limit {WAN22_SMALL_REL_L2}); launches {small_counts}")
    check_launches("narrow wan2.2 vae", small_counts, 0)
    if not max(rel_z, rel_px) <= WAN22_SMALL_REL_L2:
        raise AssertionError(f"the narrow Wan2.2 VAE disagrees with its fp32 CPU reference: {rel_z:.3e} {rel_px:.3e}")
    return {"counts": counts, "encode_s": t1 - t0, "decode_s": t2 - t1, "encode_peak_gb": enc_peak,
            "decode_peak_gb": dec_peak, "narrow_rel_l2": max(rel_z, rel_px)}


def _edm_request(model, vae, video_u8, emb, guidance: float, num_steps: int):
    """Encode the clip, EDM-sample from seeded noise (CPU generator) with
    one conditional frame, decode. Returns (latents fp32, pixels)."""
    import torch

    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import decode_streaming, encode_streaming

    gt = encode_streaming(vae, video_u8, pixel_format="uint8").permute(0, 4, 1, 2, 3).float()
    noise = torch.randn(gt.shape, generator=torch.Generator().manual_seed(6)).to(gt.device)
    out = model.generate(noise, make_condition(emb).replace(gt_frames=gt), guidance=guidance, num_steps=num_steps,
                         num_conditional_frames=1)
    if float((out[:, :, 0] - gt[:, :, 0]).abs().max()) > 1e-3 * max(1.0, float(gt.abs().max())):
        raise AssertionError("the EDM request's conditional frame is not the encoded one")
    return out, decode_streaming(vae, out.permute(0, 2, 3, 4, 1).to(vae.config.dtype))


def small_edm(device: str, dtype, state=None):
    """small_reference's narrow net (2 blocks of 2 heads of 128) and dim-64
    VAE as the EDM model: a 9-frame 64x64 clip, 4 steps at guidance 2.
    Returns (latents, pixels fp32 on the CPU, launches, (net, vae) state
    dicts)."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.edm import EDMModelConfig, EDMVideo2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT, build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE, build_vae

    cfg = make_config(DENSE_EXPERIMENT)
    net_cfg = dataclasses.replace(cfg.model.net, model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32,
                                  crossattn_proj_in_channels=64, crossattn_emb_channels=128, dtype=dtype)
    vc = dataclasses.replace(cfg.tokenizer, dim=64, dtype=dtype)
    if state is None:
        net, vae = build_dit(net_cfg, device, seed=34), build_vae(vc, device, seed=35)
    else:
        net, vae = _cpu_fp32(MiniTrainDIT, net_cfg, state[0]), _cpu_fp32(WanVAE, vc, state[1])
    model = EDMVideo2WorldModel(EDMModelConfig(model=dataclasses.replace(cfg.model, net=net.cfg, state_t=3)), net)
    rng = np.random.default_rng(7)
    video = torch.from_numpy(rng.integers(0, 256, (1, 9, 64, 64, 3), dtype=np.uint8)).to(device)
    emb = torch.from_numpy(rng.standard_normal((1, 16, 64)).astype(np.float32)).to(device)
    _build.reset_launch_counts()
    out, px = _edm_request(model, vae, video, emb, 2.0, 4)
    counts = _build.launch_counts()
    return out.float().cpu(), px.float().cpu(), counts, (net.state_dict(), vae.state_dict())


def edm_slice() -> dict:
    """The EDM model over the full-width 2B DiT and Wan2.1 VAE on seeded
    random weights: one Video2World request at the dense serving geometry,
    93 frames at 192x320 encoded, all 35 2ab steps from sigma 80 with CFG 7
    at batch 2 and the clean denoise, one conditional frame, the decode.
    Then the narrow request card bf16 against CPU fp32."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.models.edm import EDMModelConfig, EDMVideo2WorldModel

    fresh_memory()
    pipe, cfg = _serving_pipe(DENSE_EXPERIMENT)
    model = EDMVideo2WorldModel(EDMModelConfig(model=cfg.model), pipe.net)
    H, W = SIZE
    rng = np.random.default_rng(29)
    video = torch.from_numpy(rng.integers(0, 256, (1, NUM_FRAMES, H, W, 3), dtype=np.uint8)).cuda()
    emb = torch.from_numpy(rng.standard_normal((1, 512, cfg.model.net.crossattn_proj_in_channels))
                           .astype(np.float32)).cuda()
    timer = ForwardTimer(pipe.net)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out, px = _edm_request(model, pipe.vae, video, emb, GUIDANCE, NUM_STEPS)
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    peak_gb = timer.remove()
    if out.shape != (1, 16, 24, H // 8, W // 8) or px.shape != (1, NUM_FRAMES, H, W, 3) or \
            not bool(torch.isfinite(px).all()) or float(px.float().std()) == 0:
        raise AssertionError(f"EDM request: latents {tuple(out.shape)}, pixels {tuple(px.shape)}")
    # 35 steps and the clean denoise, one batched-CFG forward each
    check_launches("edm", counts, (NUM_STEPS + 1) * 2 * NUM_BLOCKS)
    denoise_s = sum(timer.seconds)
    log(f"  EDM video2world: {NUM_STEPS} 2ab steps + the clean denoise at batch 2: request {request_s:.2f} s "
        f"(denoise {denoise_s:.2f} s = {denoise_s / len(timer.seconds) * 1e3:.1f} ms a forward, encode + decode "
        f"{request_s - denoise_s:.2f} s); peak {peak_gb:.2f} GiB; launches {counts}")
    del pipe, model, out, px
    fresh_memory()

    got_z, got_px, small_counts, state = small_edm("cuda", torch.bfloat16)
    ref_z, ref_px, _, _ = small_edm("cpu", torch.float32, state)
    rel_z, rel_px = errors(got_z, ref_z)[1], errors(got_px, ref_px)[1]
    log(f"  narrow EDM request: card bf16 vs cpu fp32: latents rel_l2 {rel_z:.3e}, pixels rel_l2 {rel_px:.3e} "
        f"(limit {EDM_SMALL_REL_L2}); launches {small_counts}")
    check_launches("narrow edm", small_counts, 5 * 2 * 2)
    if not max(rel_z, rel_px) <= EDM_SMALL_REL_L2:
        raise AssertionError(f"the narrow EDM request disagrees with its fp32 CPU reference: {rel_z:.3e} {rel_px:.3e}")
    return {"counts": counts, "request_s": request_s, "denoise_s": denoise_s, "forward_s": timer.seconds,
            "peak_gb": peak_gb, "narrow_rel_l2": max(rel_z, rel_px)}


# comb02's kinds of layer at a narrow grid where each passes unscaled: a
# dilated full sub-grid window, stride and dilation mixed, a strided window
SMALL_COMB02 = (((-1, 4, 8), (1, 1, 1), (1, 2, 2), (-1, 8, 16)), ((-1, 4, 8), (1, 2, 1), (1, 1, 2), (-1, 8, 16)),
                ((-1, 3, 4), (1, 1, 2), (1, 1, 1), (-1, 8, 16)), None)


def small_sparse_step(device: str, dtype, state=None):
    """A narrow 4-block DiT (2 heads of 128) with SMALL_COMB02's per-layer
    list at a 4 x 8 x 16 token grid: one batched-CFG UniPC step of Text2World
    from seeded noise. Returns (latents fp32 on the CPU, launches, state
    dict)."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT, build_dit

    cfg = make_config(SPARSE_14B_EXPERIMENTS[1]).model
    net_cfg = dataclasses.replace(cfg.net, model_channels=256, num_heads=2, num_blocks=4, adaln_lora_dim=32,
                                  crossattn_proj_in_channels=64, crossattn_emb_channels=128,
                                  natten_parameters=SMALL_COMB02, dtype=dtype)
    net = build_dit(net_cfg, device, seed=36) if state is None else _cpu_fp32(MiniTrainDIT, net_cfg, state)
    model = Video2WorldModel(dataclasses.replace(cfg, net=net.cfg, state_t=4), net)
    rng = np.random.default_rng(8)
    noise = torch.from_numpy(rng.standard_normal((1, 16, 4, 16, 32)).astype(np.float32)).to(device)
    emb = torch.from_numpy(rng.standard_normal((1, 16, 64)).astype(np.float32)).to(device)
    _build.reset_launch_counts()
    out = model.generate(noise, make_condition(emb), guidance=GUIDANCE, num_steps=1)
    counts = _build.launch_counts()
    return out.float().cpu(), counts, net.state_dict()


def sparse_14b_slice() -> dict:
    """Each 14B sparse name (5120 channels, 36 blocks, 40 heads) built in
    bf16 on the meta device with seeded random weights: one batched-CFG
    UniPC step of Text2World at 720p (24 x 44 x 80 = 84,480 tokens), with
    the K10 launch of each of comb02's dilated layers checked by a hook on
    its block. Then the narrow comb02-kind step card bf16 against CPU fp32."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import block_layout, build_serving_dit

    result = {}
    for name in SPARSE_14B_EXPERIMENTS:
        cfg = make_config(name)
        net_cfg = cfg.model.net
        if (net_cfg.model_channels, net_cfg.num_blocks, net_cfg.num_heads) != (5120, 36, 40):
            raise AssertionError(f"{name}: the slice must run the full-width 14B DiT")
        layout = block_layout(net_cfg)
        fresh_memory()
        t = time.perf_counter()
        net = build_serving_dit(net_cfg, "cuda", seed=37)
        torch.cuda.synchronize()
        weights_gb = torch.cuda.memory_allocated() / 2**30
        log(f"  {name}: built in {time.perf_counter() - t:.1f} s, {weights_gb:.2f} GiB; "
            f"{sum(p is None for p in layout)} dense blocks")
        dilated = [i for i, p in enumerate(layout) if p is not None and p[2] != (1, 1, 1)]
        per_block = {}

        def hook(i):
            def pre(*_):
                per_block[i] = _build.launch_counts()["na_fwd"]

            def post(*_):
                per_block[i] = _build.launch_counts()["na_fwd"] - per_block[i]
            return net.blocks[i].register_forward_pre_hook(pre), net.blocks[i].register_forward_hook(post)

        handles = [h for i in dilated for h in hook(i)]
        rng = np.random.default_rng(38)
        emb = torch.from_numpy(rng.standard_normal((1, 512, net_cfg.crossattn_proj_in_channels))
                               .astype(np.float32)).cuda()
        noise = torch.randn((1, 16) + SPARSE_14B_LATENT, generator=torch.Generator(device="cuda").manual_seed(39),
                            device="cuda")
        model = Video2WorldModel(cfg.model, net)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model.generate(noise, make_condition(emb), guidance=GUIDANCE, num_steps=1)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        counts = _build.launch_counts()
        for h in handles:
            h.remove()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        n_sparse = sum(p is not None for p in layout)
        want = {"na_fwd": n_sparse, "flash_attention_fwd": 36 + (36 - n_sparse)}
        if {k: v for k, v in counts.items() if v} != want:
            raise AssertionError(f"{name}: launches {counts}, want {want}")
        if any(per_block.get(i) != 1 for i in dilated):
            raise AssertionError(f"{name}: K10 launches of the dilated blocks {per_block}")
        if out.shape != noise.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: output {tuple(out.shape)}")
        tokens = int(np.prod(SPARSE_14B_LATENT)) // 4
        log(f"  {name}: one batched-CFG step at {tokens:,} tokens in {step_s:.2f} s; peak {peak_gb:.2f} GiB; "
            f"launches {counts}; K10 once on each of the {len(dilated)} dilated blocks {dilated}")
        result[name] = {"counts": counts, "step_s": step_s, "peak_gb": peak_gb, "weights_gb": weights_gb,
                        "dilated_blocks": dilated}
        del net, model, out, noise
        fresh_memory()

    got, small_counts, sd = small_sparse_step("cuda", torch.bfloat16)
    ref, _, _ = small_sparse_step("cpu", torch.float32, sd)
    max_abs, rel = errors(got, ref)
    log(f"  narrow comb02-kind step: card bf16 vs cpu fp32: max_abs {max_abs:.3e} rel_l2 {rel:.3e} (limit "
        f"{SPARSE_SMALL_REL_L2}); launches {small_counts}")
    if (small_counts["na_fwd"], small_counts["flash_attention_fwd"]) != (3, 5):
        raise AssertionError(f"the narrow sparse step launched {small_counts}, want K10 3 and K1 5 times")
    if not (torch.isfinite(got).all() and rel <= SPARSE_SMALL_REL_L2):
        raise AssertionError(f"the narrow sparse step disagrees with its fp32 CPU reference: rel_l2 {rel:.3e}")
    result["narrow_rel_l2"] = rel
    return result


def a13_slice() -> dict:
    """Phase 17: the gr00t action stream, Wan 1.3B i2v, the Wan2.2 VAE, EDM
    and the 14B sparse pair."""
    out = {"gr00t": gr00t_slice(), "wan": wan_slice(), "wan22_vae": wan22_vae_slice(), "edm": edm_slice()}
    out["sparse_14b"] = sparse_14b_slice()
    fresh_memory()
    return out


# prompt encoders (phase 18): every tower at its released width on seeded weights
REASON1_FILE_LAYERS = 2  # the Reason1 file written for the CLI's --text-encoder route
REASON1_PAD_ID = 151643  # Qwen2.5's <|endoftext|>, its tokenizer's padding
REASON1_PROMPT_TOKENS = (377, 211)  # real ids of the prompt and the negative prompt; padded to 512
REASON1_STEPS = NUM_STEPS
# The first 2 Reason1 layers in bf16 on the card against fp32 on the CPU, on
# the same (bf16) weights and ids: 3x the 1.015e-2 relative L2 on the pooled
# embedding that this check measures on an H100.
REASON1_REL_L2 = 3e-2
UMT5_TOKENS = 200  # real ids of the Wan prompt; padded to 512
T5_11B_TOKENS = 300
XLMR_TOKENS = 400
QWEN_VISION_CLIP = (2, 448, 448)  # frames, height, width: one temporal patch of 32 x 32 patches
QWEN_VISION_OFFSET = 16  # where the 256 merged vision tokens sit among the 512 ids
SIGLIP_FRAMES = 4


class SeededTokenizer:
    """The chat tokenizer's stand-in on the card, which has no transformers:
    a prompt (the user turn) maps to the phase's seeded ids, and
    CosmosTextEncoder.tokenize pads them to 512 as it pads a real
    tokenizer's."""

    pad_token_id = REASON1_PAD_ID

    def __init__(self, table: dict):
        self.table = table

    def apply_chat_template(self, conversation, tokenize=True, add_generation_prompt=False):
        return self.table[conversation[-1]["content"]]


def tower_record(name: str, module, build_s: float, forward, what: str) -> dict:
    """A tower's parameters, build time, forward time (CUDA events: one
    warm-up, three timed calls) and peak memory since the last fresh_memory."""
    import torch

    n = sum(p.numel() for p in module.parameters())
    ms = cuda_ms(forward, warmup=1, iters=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {name}: {n / 1e9:.3f} B params, built on the card in {build_s:.2f} s; forward ({what}) {ms:.2f} ms; "
        f"peak {peak:.2f} GiB")
    return {"params": n, "build_s": build_s, "forward_ms": ms, "peak_gb": peak}


def _timed_build(build):
    import torch

    t = time.perf_counter()
    module = build()
    torch.cuda.synchronize()
    return module, time.perf_counter() - t


def _check(name: str, ok: bool, detail: str) -> None:
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def reason1_slice(out: dict) -> dict:
    """Phase 18, Reason1: the CLI's --text-encoder route on a 2-layer
    full-width file, those layers card bf16 against CPU fp32, the Qwen2.5-VL
    vision tower spliced into them, and the 28-layer 7B serving a Text2World
    request through Inference."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.inference import cli
    from cosmos_predict2_tpu_torch.inference.api import InferenceArguments
    from cosmos_predict2_tpu_torch.text_encoders.qwen import QwenConfig, build_qwen_lm
    from cosmos_predict2_tpu_torch.text_encoders.qwen_vision import (
        QwenVisionConfig,
        build_qwen_vision,
        encode_pixels,
        patchify,
    )
    from cosmos_predict2_tpu_torch.text_encoders.text_encoder import (
        CosmosTextEncoder,
        TextEncoderConfig,
        build_text_encoder,
        load_text_encoder,
    )
    from cosmos_predict2_tpu_torch.utils import flags

    towers = out["towers"]
    cfg7b = QwenConfig.qwen2_5_vl_7b()
    rng = np.random.default_rng(41)
    prompt, negative = "a robot arm stacks red cubes on a table", "blurry, low quality"
    tokenizer = SeededTokenizer({p: rng.integers(0, cfg7b.vocab_size, n).tolist()
                                 for p, n in zip((prompt, negative), REASON1_PROMPT_TOKENS)})
    ids = CosmosTextEncoder(TextEncoderConfig(), tokenizer=tokenizer).tokenize([prompt, negative])
    out_dir = OUT_DIR / "reason1"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"reason1_{REASON1_FILE_LAYERS}layers.pt"

    # 1. the CLI's route: a 2-layer full-width file with HF Qwen2.5-VL keys
    fresh_memory()
    t = time.perf_counter()
    lm2 = build_qwen_lm(dataclasses.replace(cfg7b, num_hidden_layers=REASON1_FILE_LAYERS), "cuda", seed=42)
    torch.save({f"model.language_model.{k}": v.cpu() for k, v in lm2.state_dict().items()}, path)
    write_s, size_gb = time.perf_counter() - t, path.stat().st_size / 2**30
    del lm2
    smoke, flags.SMOKE = flags.SMOKE, True
    try:
        pipe, load_s = _timed_build(lambda: cli.build_pipeline(cli.parse_args(
            [f"--experiment={DENSE_EXPERIMENT}", "--text-encoder", str(path)])))
    finally:
        flags.SMOKE = smoke
    enc2 = pipe.text_encoder
    _check("the CLI's --text-encoder", isinstance(enc2, CosmosTextEncoder) and pipe.video_size() == SIZE
           and enc2.config.model.num_hidden_layers == REASON1_FILE_LAYERS
           and enc2.config.model.dtype == torch.bfloat16 and enc2.config.tokenizer_path is None,
           f"attached {type(enc2).__name__} at {pipe.video_size()}")
    try:
        enc2([prompt])
        raise AssertionError("a text encoder without --tokenizer-path tokenized a prompt")
    except ValueError:
        pass
    log(f"  a {REASON1_FILE_LAYERS}-layer full-width Reason1 file with HF keys ({size_gb:.2f} GiB, bf16) written in "
        f"{write_s:.2f} s; cli.build_pipeline --text-encoder (COSMOS_SMOKE, {DENSE_EXPERIMENT}) in {load_s:.2f} s "
        f"attached it; without --tokenizer-path a prompt raises")

    # 3. those layers: card bf16 against CPU fp32, the same weights and ids
    got = enc2.encode_tokens(ids[:1])
    t = time.perf_counter()
    cpu = load_text_encoder(str(path), device="cpu")
    ref = cpu.encode_tokens(ids[:1])
    cpu_s = time.perf_counter() - t
    del cpu
    max_abs, rel = errors(got.cpu(), ref)
    log(f"  {REASON1_FILE_LAYERS} full-width layers, 512 ids, card bf16 vs cpu fp32 ({cpu_s:.1f} s): pooled "
        f"{tuple(got.shape)} max_abs {max_abs:.3e} rel_l2 {rel:.3e} (limit {REASON1_REL_L2})")
    _check("Reason1 card vs CPU", bool(torch.isfinite(got).all()) and rel <= REASON1_REL_L2, f"rel_l2 {rel:.3e}")
    out["reason1_cpu_rel_l2"] = rel

    # 5a. the Qwen2.5-VL vision tower on a 2-frame 448x448 clip, spliced into those layers
    vcfg = dataclasses.replace(QwenVisionConfig(), dtype=torch.bfloat16)
    vision, build_s = _timed_build(lambda: build_qwen_vision(vcfg, "cuda", seed=49))
    T, H, W = QWEN_VISION_CLIP
    frames = torch.rand((T, 3, H, W), generator=torch.Generator(device="cuda").manual_seed(50), device="cuda") * 2 - 1
    patches, grid = patchify(frames, vcfg)
    feats = encode_pixels(vision, patches, grid)
    n_vis = int(np.prod(grid)) // vcfg.spatial_merge_size ** 2
    _check("Qwen vision tower", feats.shape == (n_vis, cfg7b.hidden_size) and bool(torch.isfinite(feats).all()),
           f"{tuple(feats.shape)}")
    towers["qwen2_5_vl_vision"] = tower_record("Qwen2.5-VL vision tower", vision, build_s,
                                               lambda: encode_pixels(vision, patches, grid),
                                               f"{T} frames {H}x{W}: {patches.shape[0]} patches -> {n_vis} tokens")
    mask = np.zeros((1, ids.shape[1]), dtype=bool)
    mask[0, QWEN_VISION_OFFSET:QWEN_VISION_OFFSET + n_vis] = True
    embeds = torch.zeros((1, ids.shape[1], cfg7b.hidden_size), dtype=feats.dtype, device="cuda")
    embeds[0, QWEN_VISION_OFFSET:QWEN_VISION_OFFSET + n_vis] = feats
    mm = enc2.encode_multimodal(ids[:1], embeds, mask)
    _check("encode_multimodal", mm.shape == got.shape and bool(torch.isfinite(mm).all())
           and float((mm - got).abs().max()) > 0, f"{tuple(mm.shape)}")
    log(f"  encode_multimodal: {n_vis} vision tokens at ids {QWEN_VISION_OFFSET}-{QWEN_VISION_OFFSET + n_vis - 1} "
        f"of 512 through the {REASON1_FILE_LAYERS}-layer LM -> {tuple(mm.shape)}")
    del vision, feats, embeds, mm, enc2, got
    pipe.text_encoder = None
    path.unlink()
    fresh_memory()

    # 2. the 7B at 28 layers: a prompt and a negative prompt, then a Text2World request
    enc, build_s = _timed_build(lambda: build_text_encoder(TextEncoderConfig(), "cuda", seed=43, tokenizer=tokenizer))
    emb = enc([prompt, negative])
    width = cfg7b.num_hidden_layers * cfg7b.hidden_size
    _check("Reason1 7B", emb.shape == (2, 512, width) and bool(torch.isfinite(emb).all()), f"{tuple(emb.shape)}")
    for row, n in enumerate(REASON1_PROMPT_TOKENS):
        real = emb[row, :n]
        mean_err = float(real.mean(dim=-1).abs().max())
        std_err = float((real.std(dim=-1) - 1).abs().max())
        _check("Reason1 7B pooling", mean_err < 1e-3 and std_err < 1e-3,
               f"row {row}: channel mean off by {mean_err:.2e}, std by {std_err:.2e}")
    log(f"  Reason1 7B: (2, 512, {width:,}) fp32, finite; over each row's {REASON1_PROMPT_TOKENS} real tokens the "
        f"channel mean is 0 and the std 1 within 1e-3")
    towers["reason1_7b"] = tower_record("Reason1 7B (Qwen2.5-VL LM, 28 layers)", enc.lm, build_s,
                                        lambda: enc.encode_tokens(ids), "2 x 512 ids, FULL_CONCAT pooling")
    del emb
    pipe.text_encoder = enc
    api, export_s = _timed_api(pipe, out_dir)
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    (video,) = api.generate([InferenceArguments(name="reason1_text2world", prompt=prompt, negative_prompt=negative,
                                                num_steps=REASON1_STEPS, guidance=GUIDANCE, seed=1)])
    request_s = time.perf_counter() - t
    counts = _build.launch_counts()
    check_launches("reason1 text2world", counts, REASON1_STEPS * 2 * NUM_BLOCKS)
    _check("the Reason1 request", Path(video).stat().st_size > 0, f"wrote {video}")
    tm = pipe.last_timings
    log(f"  Text2World through Inference with the 7B's embeddings ({NUM_FRAMES} frames at {SIZE[0]}x{SIZE[1]}, "
        f"{REASON1_STEPS} steps, CFG {GUIDANCE} against the negative prompt): {request_s:.2f} s (denoise "
        f"{tm['denoise_s']:.2f} s, export {export_s[0]:.2f} s); launches {counts}")
    result = {"counts": counts, "request_s": request_s, "export_s": export_s[0], **tm,
              "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
    del enc, pipe, api
    fresh_memory()
    return result


def wan_encoders_slice(out: dict) -> dict:
    """Phase 18, Wan i2v: umT5-XXL encodes the prompt, CLIP ViT-H/14 the
    first frame inside make_i2v_condition, and Wan 1.3B serves the request."""
    import dataclasses as dc

    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.models.wan_video2world import WanModelConfig, WanVideo2WorldModel, image2world
    from cosmos_predict2_tpu_torch.networks.wan_dit import WAN_PRESETS, build_wan
    from cosmos_predict2_tpu_torch.text_encoders.clip_vision import (
        CLIPVisionConfig,
        build_clip_vision,
        encode_first_frame,
    )
    from cosmos_predict2_tpu_torch.text_encoders.t5_encoder import T5Config, build_t5_encoder
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAEConfig, build_vae

    towers = out["towers"]
    ucfg = dc.replace(T5Config.umt5_xxl(), dtype=torch.bfloat16)
    umt5, build_s = _timed_build(lambda: build_t5_encoder(ucfg, "cuda", seed=44))
    rng = np.random.default_rng(45)
    mask = torch.zeros((1, 512), dtype=torch.long, device="cuda")
    mask[:, :UMT5_TOKENS] = 1
    ids = torch.from_numpy(rng.integers(1, ucfg.vocab_size, (1, 512))).to("cuda") * mask
    with torch.no_grad():
        text = umt5(ids, mask)
    _check("umT5-XXL", text.shape == (1, 512, 4096) and bool(torch.isfinite(text).all())
           and not bool(text[0, UMT5_TOKENS:].any()), f"{tuple(text.shape)}")
    towers["umt5_xxl"] = tower_record("umT5-XXL encoder (24 x 4096)", umt5, build_s, lambda: umt5(ids, mask),
                                      f"512 ids, {UMT5_TOKENS} real")
    del umt5
    fresh_memory()

    clip, build_s = _timed_build(lambda: build_clip_vision(CLIPVisionConfig(), "cuda", seed=46))
    H, W = WAN_HW
    gen = torch.Generator(device="cuda").manual_seed(47)
    frame = torch.rand((1, H, W, 3), generator=gen, device="cuda") * 2 - 1
    tokens = encode_first_frame(clip, frame[:, None])
    _check("CLIP ViT-H/14", tokens.shape == (1, 257, 1280) and bool(torch.isfinite(tokens).all()),
           f"{tuple(tokens.shape)}")
    towers["clip_vit_h14"] = tower_record("CLIP ViT-H/14 (31 of 32 blocks)", clip, build_s,
                                          lambda: encode_first_frame(clip, frame[:, None]),
                                          f"one {H}x{W} frame -> 257 tokens")
    del tokens

    cfg = WAN_PRESETS["1.3B"]
    net = build_wan(cfg, "cuda", seed=23)
    vae = build_vae(WanVAEConfig(), "cuda", seed=24)
    model = WanVideo2WorldModel(WanModelConfig(net=cfg), net)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    latents, px = image2world(model, vae, frame, text, None, torch.Generator(device="cuda").manual_seed(26),
                              num_frames=WAN_FRAMES, guidance=WAN_GUIDANCE, num_steps=WAN_STEPS, clip_tower=clip)
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t
    counts = _build.launch_counts()
    check_launches("wan i2v with umT5 and CLIP", counts, WAN_STEPS * 3 * cfg.num_layers)
    _check("the Wan request", latents.shape == (1, 16, 21, 60, 104) and px.shape == (1, WAN_FRAMES, H, W, 3)
           and bool(torch.isfinite(px).all()) and float(px.float().std()) > 0,
           f"latents {tuple(latents.shape)}, pixels {tuple(px.shape)}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"  Wan 1.3B i2v on umT5's text and CLIP's first-frame tokens ({WAN_FRAMES} x {H}x{W}, {WAN_STEPS} steps, "
        f"the frame CLIP-encoded inside make_i2v_condition): {request_s:.2f} s; peak {peak_gb:.2f} GiB; "
        f"launches {counts}")
    del net, vae, model, latents, px, clip, text
    fresh_memory()
    return {"counts": counts, "request_s": request_s, "peak_gb": peak_gb}


def other_towers_slice(out: dict) -> None:
    """Phase 18, the rest at full width: T5-11B through OfflineT5Encoder's
    tower route, SigLIP so400m on 384x384 frames, XLM-R large on 512 ids."""
    import dataclasses as dc

    import torch

    from cosmos_predict2_tpu_torch.text_encoders.siglip_vision import (
        SigLIPVisionConfig,
        build_siglip_vision,
        make_frame_embedder,
        preprocess_siglip,
    )
    from cosmos_predict2_tpu_torch.text_encoders.t5 import OfflineT5Encoder
    from cosmos_predict2_tpu_torch.text_encoders.t5_encoder import T5Config, build_t5_encoder
    from cosmos_predict2_tpu_torch.text_encoders.xlm_roberta import XLMRobertaConfig, build_xlm_roberta

    towers = out["towers"]
    rng = np.random.default_rng(51)
    tcfg = dc.replace(T5Config.t5_11b(), dtype=torch.bfloat16)
    t5, build_s = _timed_build(lambda: build_t5_encoder(tcfg, "cuda", seed=52))
    mask = np.zeros((1, 512), dtype=np.int64)
    mask[:, :T5_11B_TOKENS] = 1
    ids = rng.integers(1, tcfg.vocab_size, (1, 512)) * mask
    offline = OfflineT5Encoder(encoder=t5, device="cuda")
    emb = offline.encode_ids(ids, mask)
    _check("T5-11B", emb.shape == (1, 512, 1024) and np.isfinite(emb).all() and not emb[0, T5_11B_TOKENS:].any()
           and np.abs(emb[0, :T5_11B_TOKENS]).sum(-1).min() > 0, f"{emb.shape}")
    ids_t, mask_t = torch.from_numpy(ids).to("cuda"), torch.from_numpy(mask).to("cuda")
    towers["t5_11b"] = tower_record("T5-11B encoder (published widths: d_kv 128, d_ff 65,536)", t5, build_s,
                                    lambda: t5(ids_t, mask_t), f"512 ids, {T5_11B_TOKENS} real, via OfflineT5Encoder")
    del t5, offline
    fresh_memory()

    siglip, build_s = _timed_build(lambda: build_siglip_vision(SigLIPVisionConfig(), "cuda", seed=53))
    frames = rng.integers(0, 256, (SIGLIP_FRAMES, 384, 384, 3), dtype=np.uint8)
    feats = make_frame_embedder(siglip)(frames)
    _check("SigLIP so400m", feats.shape == (SIGLIP_FRAMES, 1152) and np.isfinite(feats).all(), f"{feats.shape}")
    pixels = preprocess_siglip(frames, 384, "cuda")
    towers["siglip_so400m"] = tower_record("SigLIP so400m/14-384", siglip, build_s, lambda: siglip(pixels),
                                           f"{SIGLIP_FRAMES} frames 384x384 -> 729 tokens each")
    del siglip, pixels
    fresh_memory()

    xcfg = dc.replace(XLMRobertaConfig.large(), dtype=torch.bfloat16)
    xlm, build_s = _timed_build(lambda: build_xlm_roberta(xcfg, "cuda", seed=54, with_head=True))
    xids = torch.from_numpy(rng.integers(2, xcfg.vocab_size, (1, 512))).to("cuda")
    xids[:, XLMR_TOKENS:] = xcfg.pad_id
    with torch.no_grad():
        pooled, hidden = xlm(xids), xlm.encode(xids)
    _check("XLM-R large", pooled.shape == (1, xcfg.out_dim) and hidden.shape == (1, 512, xcfg.dim)
           and bool(torch.isfinite(pooled).all()) and bool(torch.isfinite(hidden).all()), f"{tuple(pooled.shape)}")
    towers["xlm_roberta_large"] = tower_record("XLM-R large with its head", xlm, build_s, lambda: xlm(xids),
                                               f"512 ids, {XLMR_TOKENS} real")
    del xlm
    fresh_memory()


def prompt_encoders_slice() -> dict:
    """Phase 18: A15, the prompt encoders."""
    out: dict = {"towers": {}}
    out["reason1"] = reason1_slice(out)
    out["wan_encoders"] = wan_encoders_slice(out)
    other_towers_slice(out)
    if "transformers" in sys.modules:
        raise AssertionError("the prompt encoders' phase imported transformers")
    return out


# ------------- self-forcing and the variants' training steps (phase 19) -------------

SF_EXPERIMENT = "predict2_interactive_2b_causal"
SF_BLOCKS = 2  # one-frame blocks of the rollout, at phase 9's 352x640
# 7 latent frames of 30 x 52 tokens: 10,920 tokens. The Wan net keeps every
# activation (no remat, as the JAX net): ~4.3 MiB a token on an H100 beside
# 23.3 GiB of fp32 weights, gradients and moments, so 81 frames (32,760
# tokens) would take ~160 GiB
WAN_TRAIN_FRAMES = 25
WAN_TRAIN_TIMED = 2  # after one warm-up step
EDM_TRAIN_TIMED = 2
SF_WATCH = ("blocks.0.self_attn.k_proj.weight", "blocks.27.mlp.layer2.weight", "final_layer.linear.weight")
# The narrow steps are held at phase 6's limits (TRAIN_*). On the CPU, bf16
# against fp32 (same weights and draws) gives, for the self-forcing
# generator / critic step, the Wan step and the EDM step: losses within
# 7.3e-4 / 7.1e-4 / 1.2e-4 / 3.2e-4 relative, all gradients within 4.5e-3 /
# 5.3e-3 / 4.4e-3 / 4.5e-3 relative L2 together, every parameter's within
# 1.35e-2 / 9.1e-3 / 2.05e-2 / 8.4e-3.


def _grad_norm(net) -> float:
    from cosmos_predict2_tpu_torch.training.optim import global_norm

    grads = [p.grad for p in net.parameters() if p.grad is not None]
    return float(global_norm(grads)) if grads else 0.0


def _self_forcing_setup(mc, device: str, nets, hw: tuple[int, int], seed: int, steps: int = INTERACTIVE_STEPS):
    """StreamingInference over the student and SelfForcingDMD2, a seeded
    text condition of the experiment's width and the loss draws of a CPU
    generator."""
    import torch

    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.models.distillation import DistillationConfig
    from cosmos_predict2_tpu_torch.models.interactive import (CausalVideo2WorldModel, SelfForcingDMD2, StreamingConfig,
                                                              StreamingInference)

    scfg = StreamingConfig(distill=DistillationConfig(model=mc), num_frame_per_block=1, cache_frame_size=SF_BLOCKS,
                           num_steps=steps)
    sf = SelfForcingDMD2(StreamingInference(scfg, CausalVideo2WorldModel(mc, nets[0])))
    rng = np.random.default_rng(seed)
    emb = torch.from_numpy((rng.standard_normal((1, 512, mc.net.crossattn_proj_in_channels)) * 0.5)
                           .astype(np.float32)).to(device)
    draws = sf.sample_draws(torch.Generator().manual_seed(seed), 1, SF_BLOCKS, hw).to(device)
    return sf, make_condition(emb), draws


def sf_want(blocks: int, steps: int, layers: int, remat: bool) -> dict:
    """Launches and backward recomputes of one generator and one critic
    step over a rollout of ``blocks`` one-frame blocks of ``steps`` denoise
    steps and a commit each, ``layers`` DiT blocks: each cached forward
    launches K5 and K1 (its cross-attention) once a layer; the denoise
    forwards record the graph and, under block remat, run again in the
    backward; the generator adds the teacher's and the fake score's full
    forwards (no graph: 2 K1 a layer each), the critic the fake score's
    (a graph under remat: twice)."""
    cached = blocks * (steps + 1) * layers
    graph = blocks * steps * layers
    again = graph if remat else 0
    full = 2 * layers
    return {
        "generator": {"flash_attention_kv_cache": cached + again, "flash_attention_fwd": cached + again + 2 * full,
                      "flash_attention_bwd_dq": graph, "flash_attention_bwd_dkv": graph, "recomputes": graph},
        "critic": {"flash_attention_kv_cache": cached, "flash_attention_fwd": cached + full * (2 if remat else 1),
                   "flash_attention_bwd_dq": full, "flash_attention_bwd_dkv": full, "recomputes": 0},
    }


def _sf_counts(counts0: dict, recomputes0: int) -> dict:
    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.ops.flash_attention import kv_cache_vjp

    counts = {k: v - counts0[k] for k, v in _build.launch_counts().items()}
    counts["recomputes"] = kv_cache_vjp.recomputes - recomputes0
    return counts


def self_forcing_slice() -> dict:
    """Self-forcing DMD2 of the full-width causal 2B (the interactive
    experiment's net, fp32 student, frozen teacher and fake score as phase
    7's nets, block remat; seeded random weights): a rollout of SF_BLOCKS
    one-frame blocks of INTERACTIVE_STEPS steps at 352x640 (880 tokens a
    block), one generator_loss backward and an AdamW step of the student,
    then one critic_loss backward and a step of the fake score."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.ops.flash_attention import kv_cache_vjp
    from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig, make_optimizer

    mc = make_config(SF_EXPERIMENT).model
    net_cfg = mc.net
    if (net_cfg.num_blocks, net_cfg.model_channels, net_cfg.remat) != (NUM_BLOCKS, 2048, "block") or \
            not net_cfg.temporal_causal:
        raise AssertionError("the self-forcing slice must run the full-width causal 2B DiT with block remat")
    fresh_memory()
    t = time.perf_counter()
    nets = [build_dit(net_cfg, "cuda", seed=50 + i, trainable=i != 1) for i in range(3)]  # student, teacher, fake
    student, teacher, fake = nets
    torch.cuda.synchronize()
    nets_gb = torch.cuda.memory_allocated() / 2**30
    log(f"  three causal 2B DiTs (fp32) built in {time.perf_counter() - t:.1f} s: {nets_gb:.2f} GiB")
    hw = INTERACTIVE_HW
    sf, cond, draws = _self_forcing_setup(mc, "cuda", nets, hw, seed=51)
    want = sf_want(SF_BLOCKS, INTERACTIVE_STEPS, NUM_BLOCKS, remat=True)
    out = {}
    for phase, net, loss_fn in (
        ("generator", student, lambda: sf.generator_loss(teacher, fake, cond, None, SF_BLOCKS, hw, draws)),
        ("critic", fake, lambda: sf.critic_loss(fake, cond, SF_BLOCKS, hw, draws)),
    ):
        opt, _ = make_optimizer(OptimizerConfig(lr=1e-5, warm_up_steps=(0,)), [p for p in net.parameters()])
        watch = {n: p.detach().clone() for n, p in net.named_parameters() if n in SF_WATCH}
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        counts0, recomputes0 = _build.launch_counts(), kv_cache_vjp.recomputes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = loss_fn()
        loss.backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = _sf_counts(counts0, recomputes0)
        norm = _grad_norm(net)
        stray = [i for i, n in enumerate(nets) if n is not net and any(p.grad is not None for p in n.parameters())]
        opt.step()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        moved = all(not torch.equal(p.detach(), watch[n]) for n, p in net.named_parameters() if n in SF_WATCH)
        peak = torch.cuda.max_memory_allocated() / 2**30
        loss_v = float(loss.detach())
        owner = "the student" if net is student else "the fake score"
        log(f"  {phase} step: loss {loss_v:.6f}, gradient norm {norm:.4e} over {owner}; loss + backward "
            f"{t1 - t0:.3f} s, AdamW {t2 - t1:.3f} s; peak {peak:.2f} GiB; launches {counts}")
        if not (np.isfinite(loss_v) and np.isfinite(norm) and norm > 0 and moved):
            raise AssertionError(f"the {phase} step: loss {loss_v}, gradient norm {norm}, parameters moved {moved}")
        if stray or any(p.grad is not None for p in teacher.parameters()):
            raise AssertionError(f"the {phase} step put gradients on nets {stray} (0 student, 1 teacher, 2 fake)")
        got = {k: counts[k] for k in want[phase]}
        if got != want[phase] or counts["flash_attention_kv_cache_window"]:
            raise AssertionError(f"the {phase} step launched {counts}, want {want[phase]}")
        out[phase] = {"loss": loss_v, "grad_norm": norm, "loss_backward_s": t1 - t0, "optimizer_s": t2 - t1,
                      "peak_gb": peak, "counts": counts}
        net.zero_grad(set_to_none=True)
        del opt, loss
    del nets, student, teacher, fake, sf, cond, draws
    fresh_memory()
    counts = {k: out["generator"]["counts"][k] + out["critic"]["counts"][k] for k in out["generator"]["counts"]}
    return {"counts": counts, "nets_gb": nets_gb, **out}


class VariantStepProbe:
    """Training callback of phase 19: per step the launches, the loss (and
    sigma_mean where the model gives it), the trainer's timings and the
    peak memory; every parameter's gradient finite at step 1."""

    def __init__(self):
        self.steps = []

    def on_train_start(self, trainer, state):
        self.start = {n: p.detach()[..., :4].clone() for n, p in state.params.items()}

    def on_training_step_start(self, trainer, state, batch, iteration):
        import torch

        from cosmos_predict2_tpu_torch import _build

        self.counts0 = _build.launch_counts()
        torch.cuda.reset_peak_memory_stats()

    def on_training_step_end(self, trainer, state, metrics, iteration):
        import torch

        from cosmos_predict2_tpu_torch import _build

        counts = {k: v - self.counts0[k] for k, v in _build.launch_counts().items()}
        if iteration == 1:
            bad = [n for n, p in state.params.items() if p.grad is None or not bool(torch.isfinite(p.grad).all())]
            if bad:
                raise AssertionError(f"{len(bad)} parameters without a finite gradient at step 1, e.g. {bad[:3]}")
        st = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]), "counts": counts,
              "peak_gb": torch.cuda.max_memory_allocated() / 2**30, **trainer.last_timings}
        if "sigma_mean" in metrics:
            st["sigma_mean"] = float(metrics["sigma_mean"])
        self.steps.append(st)
        sigma = f" sigma_mean {st['sigma_mean']:.4f}" if "sigma_mean" in st else ""
        log(f"  step {iteration}: loss {st['loss']:.4f}{sigma} grad_norm {st['grad_norm']:.3e} step {st['step_s']:.3f} s (data+vae {st['data_s']:.3f} s, fwd+bwd "
            f"{st['forward_backward_s']:.3f} s, optimizer {st['optimizer_s']:.3f} s); peak {st['peak_gb']:.2f} GiB; "
            f"launches {counts}")

    def on_save_checkpoint(self, trainer, state, iteration): ...

    def on_train_end(self, trainer, state): ...

    def moved(self, state) -> bool:
        import torch

        return all(not torch.equal(p.detach()[..., :4], self.start[n]) for n, p in state.params.items())


def _train_variant(name: str, model, batches, steps: int, ema: bool, want: dict) -> dict:
    """training/trainer.py's Trainer over ``model`` for ``steps`` steps (one
    warm-up and the timed rest); checks finite losses, a finite gradient on
    every parameter, every parameter moved, and each step's launches."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
    from cosmos_predict2_tpu_torch.training.trainer import Trainer, TrainerConfig

    probe = VariantStepProbe()
    # no warm-up: the schedule's first factor is f_start (1e-6), which leaves most weights where they were
    optimizer = OptimizerConfig(lr=1e-4, warm_up_steps=(0,))
    trainer = Trainer(TrainerConfig(max_iter=steps, logging_iter=1, save_iter=0, ema_enabled=ema, optimizer=optimizer),
                      model, callbacks=[probe])
    state = trainer.init_state()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.train(state, batches)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    if state.step != steps or not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in probe.steps):
        raise AssertionError(f"{name}: {state.step} steps, losses {[s['loss'] for s in probe.steps]}")
    if not probe.moved(state):
        raise AssertionError(f"{name}: not every parameter moved")
    for i, s in enumerate(probe.steps):
        if {k: s["counts"][k] for k in want} != want:
            raise AssertionError(f"{name} step {i + 1} launched {s['counts']}, want {want}")
    if counts["conv3d_causal"] == 0:
        raise AssertionError(f"{name}: conv3d_causal never ran in the data phase's VAE encode")
    timed = probe.steps[1:]
    mean = lambda key: sum(s[key] for s in timed) / len(timed)  # noqa: E731
    out = {"counts": counts, "steps": probe.steps, "total_s": total_s, "params": len(state.params),
           "peak_gb": max(s["peak_gb"] for s in probe.steps),
           **{k: mean(k) for k in ("step_s", "data_s", "forward_backward_s", "optimizer_s")}}
    del trainer, state
    return out


def wan_train_slice() -> dict:
    """Wan2.1 1.3B i2v training at full width (fp32 parameters, bf16
    matmuls, no remat as the JAX net): WAN_TRAIN_FRAMES-frame clips at
    480x832 through the Wan2.1 VAE (K2) in the data phase, seeded umT5 and
    CLIP tokens, frame 0 conditional; one warm-up and WAN_TRAIN_TIMED timed
    steps of the Trainer, no EMA."""
    import torch

    from cosmos_predict2_tpu_torch.models.wan_video2world import WanModelConfig, WanVideo2WorldModel, make_i2v_condition
    from cosmos_predict2_tpu_torch.networks.wan_dit import WAN_PRESETS, WanModel, init_wan_weights
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAEConfig, build_vae
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import encode_streaming

    cfg = WAN_PRESETS["1.3B"]
    fresh_memory()
    with torch.device("meta"):
        net = WanModel(cfg)
    net = init_wan_weights(net.to_empty(device="cuda"), torch.Generator(device="cuda").manual_seed(60)).train()
    vae = build_vae(WanVAEConfig(), "cuda", seed=61)
    model = WanVideo2WorldModel(WanModelConfig(net=cfg), net)
    H, W = WAN_HW

    def batches():
        gen = torch.Generator(device="cuda").manual_seed(62)
        while True:
            clip = torch.randint(0, 256, (1, WAN_TRAIN_FRAMES, H, W, 3), generator=gen, device="cuda",
                                 dtype=torch.uint8)
            with torch.no_grad():
                x0 = encode_streaming(vae, clip, pixel_format="uint8").permute(0, 4, 1, 2, 3).float()
            text = torch.randn((1, 512, cfg.text_dim), generator=gen, device="cuda")
            yield x0, make_i2v_condition(text, x0, torch.randn((1, 257, cfg.clip_dim), generator=gen, device="cuda"))

    per_step = 3 * cfg.num_layers  # self, text cross and CLIP cross attention a layer, no remat
    out = _train_variant("wan", model, batches(), 1 + WAN_TRAIN_TIMED, ema=False, want={
        "flash_attention_fwd": per_step, "flash_attention_bwd_dq": per_step, "flash_attention_bwd_dkv": per_step})
    tokens = (1 + (WAN_TRAIN_FRAMES - 1) // 4) * (H // 16) * (W // 16)
    out["tokens"] = tokens
    log(f"  Wan 1.3B i2v training, {WAN_TRAIN_FRAMES} frames at {H}x{W} ({tokens:,} tokens): {out['params']} "
        f"parameters; step {out['step_s']:.3f} s (fwd+bwd {out['forward_backward_s']:.3f}, optimizer "
        f"{out['optimizer_s']:.3f}), data+vae {out['data_s']:.3f} s; {tokens / out['step_s']:.0f} tokens/s; peak "
        f"{out['peak_gb']:.2f} GiB")
    del net, vae, model
    fresh_memory()
    return out


def edm_train_slice() -> dict:
    """EDM training of the full-width 2B (phase 7's arrangement: fp32, block
    remat, EMA; 93 frames at 192x320, 5,760 tokens, mock clips through the
    VAE): one warm-up and EDM_TRAIN_TIMED timed steps of the Trainer."""
    import torch

    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.edm import EDMModelConfig, EDMVideo2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae
    from cosmos_predict2_tpu_torch.training.train import latent_batches, make_loader

    H, W = SIZE
    cfg = make_config(DENSE_EXPERIMENT, [f"data_train.num_frames={NUM_FRAMES}", f"data_train.height={H}",
                                         f"data_train.width={W}", "data_train.text_dim=100352"])
    fresh_memory()
    net = build_dit(cfg.model.net, "cuda", seed=70, trainable=True)
    vae = build_vae(cfg.tokenizer, "cuda", seed=71)
    model = EDMVideo2WorldModel(EDMModelConfig(model=cfg.model), net)
    per_step = 2 * NUM_BLOCKS  # self and cross attention a block
    out = _train_variant("edm", model, latent_batches(make_loader(cfg.data_train), vae, torch.device("cuda")),
                         1 + EDM_TRAIN_TIMED, ema=True, want={"flash_attention_fwd": 2 * per_step,
                                                              "flash_attention_bwd_dq": per_step,
                                                              "flash_attention_bwd_dkv": per_step})
    sigmas = [s["sigma_mean"] for s in out["steps"]]
    if not all(np.isfinite(sigmas)) or min(sigmas) <= 0:
        raise AssertionError(f"edm: sigma_mean {sigmas}")
    log(f"  EDM 2B training at {NUM_FRAMES} x {H}x{W} (5,760 tokens): sigma_mean by step {sigmas}; step "
        f"{out['step_s']:.3f} s (fwd+bwd {out['forward_backward_s']:.3f}, optimizer+ema {out['optimizer_s']:.3f}), "
        f"data+vae {out['data_s']:.3f} s; peak {out['peak_gb']:.2f} GiB")
    del net, vae, model
    fresh_memory()
    return out


def small_self_forcing(device: str, dtype, state=None):
    """A generator step and a critic step of self-forcing on narrow causal
    nets (the interactive experiment, 2 blocks of 256 channels, head_dim
    128, block remat; student, teacher and fake score on their own seeds), a
    rollout of SF_BLOCKS one-frame blocks of 2 steps at a 16 x 24 latent
    (8 x 12 tokens), bf16 caches, fixed draws. Returns ({phase: (loss, {name:
    grad fp32 on the CPU})}, launches per phase, state dicts)."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.ops.flash_attention import kv_cache_vjp

    mc = make_config(SF_EXPERIMENT).model
    net_cfg = dataclasses.replace(mc.net, model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32,
                         crossattn_proj_in_channels=64, crossattn_emb_channels=128, dtype=dtype)
    mc = dataclasses.replace(mc, net=net_cfg)
    nets = [build_dit(net_cfg, device, seed=80 + i, trainable=i != 1) for i in range(3)]
    if state is not None:
        for net, sd in zip(nets, state):
            net.load_state_dict(sd)
    hw = (16, 24)
    sf, cond, draws = _self_forcing_setup(mc, device, nets, hw, seed=81, steps=2)
    student, teacher, fake = nets
    out, counts = {}, {}
    for phase, net, loss_fn in (
        ("generator", student, lambda: sf.generator_loss(teacher, fake, cond, None, SF_BLOCKS, hw, draws)),
        ("critic", fake, lambda: sf.critic_loss(fake, cond, SF_BLOCKS, hw, draws)),
    ):
        _build.reset_launch_counts()
        counts0, recomputes0 = _build.launch_counts(), kv_cache_vjp.recomputes
        loss, _ = loss_fn()
        loss.backward()
        counts[phase] = _sf_counts(counts0, recomputes0)
        out[phase] = (float(loss.detach()), {n: p.grad.float().cpu() for n, p in net.named_parameters()})
        net.zero_grad(set_to_none=True)
    return out, counts, [{k: v.cpu() for k, v in n.state_dict().items()} for n in nets]


def small_wan_step(device: str, dtype, state=None):
    """One training step of a narrow Wan i2v (2 layers, dim 256: 2 heads of
    128; text and CLIP width 64) on 3 latent frames of 16 x 24, frame 0
    conditional, fixed weights, inputs and draws. Returns (loss, {name:
    grad fp32 on the CPU}, launches, state dict)."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.models.wan_video2world import WanModelConfig, WanVideo2WorldModel, make_i2v_condition
    from cosmos_predict2_tpu_torch.networks.wan_dit import WanConfig, WanModel, init_wan_weights

    cfg = WanConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_dim=64, clip_dim=64, dtype=dtype)
    with torch.device("meta"):
        net = WanModel(cfg)
    net = net.to_empty(device=device)
    if state is None:
        init_wan_weights(net, torch.Generator(device=device).manual_seed(90))
    else:
        net.load_state_dict(state)
    model = WanVideo2WorldModel(WanModelConfig(net=cfg, state_t=3), net.train())
    rng = np.random.default_rng(91)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)  # noqa: E731
    x0 = t(1, 16, 3, 16, 24)
    cond = make_i2v_condition(t(1, 512, 64), x0, t(1, 257, 64))
    draws = model.sample_train_draws(torch.Generator().manual_seed(92), tuple(x0.shape)).to(device)
    _build.reset_launch_counts()
    loss, _ = model.training_step(x0, cond, draws)
    loss.backward()
    counts = _build.launch_counts()
    grads = {n: p.grad.float().cpu() for n, p in net.named_parameters()}
    return float(loss.detach()), grads, counts, {k: v.cpu() for k, v in net.state_dict().items()}


def small_edm_step(device: str, dtype, state=None):
    """One EDM training step of small_train_step's narrow DiT (2 blocks of
    256 channels, head_dim 128, block remat) on 4 latent frames of 16 x 24
    with the clean latents as gt_frames, fixed weights, inputs and draws.
    Returns (loss, {name: grad fp32 on the CPU}, launches, state dict)."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.edm import EDMModelConfig, EDMVideo2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import build_dit

    cfg = make_config(DENSE_EXPERIMENT)
    net_cfg = dataclasses.replace(cfg.model.net, model_channels=256, num_heads=2, num_blocks=2, adaln_lora_dim=32,
                                  crossattn_proj_in_channels=64, crossattn_emb_channels=128, dtype=dtype)
    net = build_dit(net_cfg, device, seed=93, trainable=True)
    if state is not None:
        net.load_state_dict(state)
    model = EDMVideo2WorldModel(EDMModelConfig(model=dataclasses.replace(cfg.model, net=net_cfg, state_t=4)), net)
    rng = np.random.default_rng(94)
    x0 = torch.from_numpy((0.5 * rng.standard_normal((1, 16, 4, 16, 24))).astype(np.float32)).to(device)
    emb = torch.from_numpy(rng.standard_normal((1, 32, 64)).astype(np.float32)).to(device)
    draws = model.sample_train_draws(torch.Generator().manual_seed(95), tuple(x0.shape)).to(device)
    _build.reset_launch_counts()
    loss, metrics = model.training_step(x0, make_condition(emb).replace(gt_frames=x0), draws)
    loss.backward()
    counts = _build.launch_counts()
    grads = {n: p.grad.float().cpu() for n, p in net.named_parameters()}
    return float(loss.detach()), grads, counts, {k: v.cpu() for k, v in net.state_dict().items()}


def _hold_step(name: str, loss: float, grads: dict, ref_loss: float, ref_grads: dict) -> dict:
    """A step's loss and gradients on the card against fp32 on the CPU at
    phase 6's limits."""
    import torch

    num = sum(float((grads[n] - g).norm()) ** 2 for n, g in ref_grads.items()) ** 0.5
    den = sum(float(g.norm()) ** 2 for g in ref_grads.values()) ** 0.5
    worst = max((float((grads[n] - g).norm() / g.norm().clamp_min(1e-30)), n) for n, g in ref_grads.items())
    loss_rel = abs(loss / ref_loss - 1)
    log(f"  {name}: card bf16 loss {loss:.6f} vs cpu fp32 {ref_loss:.6f}: rel {loss_rel:.3e} (limit {TRAIN_LOSS_REL}); "
        f"gradients rel_l2 {num / den:.3e} (limit {TRAIN_GRAD_REL_L2}), worst parameter {worst[0]:.3e} {worst[1]} "
        f"(limit {TRAIN_GRAD_TENSOR_REL_L2})")
    if not (all(torch.isfinite(g).all() for g in grads.values()) and loss_rel <= TRAIN_LOSS_REL
            and num / den <= TRAIN_GRAD_REL_L2 and worst[0] <= TRAIN_GRAD_TENSOR_REL_L2):
        raise AssertionError(f"the narrow {name} on the card disagrees with its fp32 CPU reference")
    return {"loss_rel": loss_rel, "grad_rel_l2": num / den, "worst_tensor_rel_l2": worst[0]}


def small_training_variants_reference() -> dict:
    """The narrow self-forcing generator and critic steps, Wan step and EDM
    step in bf16 on the card against the same weights and draws in fp32 on
    the CPU (plain versions), with their exact launches."""
    import torch

    out = {}
    got, counts, sds = small_self_forcing("cuda", torch.bfloat16)
    ref, _, _ = small_self_forcing("cpu", torch.float32, sds)
    want = sf_want(SF_BLOCKS, 2, 2, remat=True)
    for phase in ("generator", "critic"):
        out[f"self_forcing_{phase}"] = _hold_step(f"self-forcing {phase} step", *got[phase], *ref[phase])
        if {k: counts[phase][k] for k in want[phase]} != want[phase]:
            raise AssertionError(f"the narrow self-forcing {phase} step launched {counts[phase]}, want {want[phase]}")
    loss, grads, counts, sd = small_wan_step("cuda", torch.bfloat16)
    ref_loss, ref_grads, _, _ = small_wan_step("cpu", torch.float32, sd)
    out["wan"] = _hold_step("Wan training step", loss, grads, ref_loss, ref_grads)
    if (counts["flash_attention_fwd"], counts["flash_attention_bwd_dq"], counts["flash_attention_bwd_dkv"]) != (6, 6, 6):
        raise AssertionError(f"the narrow Wan step launched {counts}, want K1, K7 and K8 6 times each")
    loss, grads, counts, sd = small_edm_step("cuda", torch.bfloat16)
    ref_loss, ref_grads, _, _ = small_edm_step("cpu", torch.float32, sd)
    out["edm"] = _hold_step("EDM training step", loss, grads, ref_loss, ref_grads)
    if (counts["flash_attention_fwd"], counts["flash_attention_bwd_dq"], counts["flash_attention_bwd_dkv"]) != (8, 4, 4):
        raise AssertionError(f"the narrow EDM step launched {counts}, want K1 8, K7 and K8 4 times")
    return out


def training_variants_slice() -> dict:
    """Phase 19: self-forcing DMD2 and the Wan and EDM training steps."""
    out = {"self_forcing": self_forcing_slice(), "wan_train": wan_train_slice(), "edm_train": edm_train_slice(),
           "narrow": small_training_variants_reference()}
    fresh_memory()
    return out


# ---------------- context parallelism (phase 20) ----------------

CP_LATENT = (24, 88, 160)  # 93 frames at 704x1280: 24 x 44 x 80 = 84,480 tokens
CP_DEPTH = 4  # blocks of the full-width 2B nets in (a) (a cut: depth)
CP_STREAM_HW = (88, 160)  # the stream's latent frame at 720p: 3,520 tokens a block
CP_STREAM_CACHE = 8  # frames the stream's cache holds beside the block (8 + 1: 31,680 tokens)
CP_STREAM_BLOCKS = 2  # streamed one-frame blocks after one prefilled frame
CP_WINDOW = 2 * INTERACTIVE_WINDOW  # the 720p row window (phase 3's 720p K6 case)
CP_SHARDS = 4  # the cp degree of (b)'s rank programs


def _cp_nets(device):
    """(a)'s nets on seeded weights: the dense 2B at full width and CP_DEPTH
    blocks, the sparse 2B's NA block (one block, the sparse recipe's window),
    and their configs."""
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.networks.dit import build_serving_dit

    dense_cfg = dataclasses.replace(make_config(DENSE_EXPERIMENT).model.net, num_blocks=CP_DEPTH, remat="none")
    sparse_cfg = dataclasses.replace(make_config(SPARSE_EXPERIMENT).model.net, num_blocks=1, n_dense_blocks=0,
                                     natten_parameters=None, remat="none")
    return build_serving_dit(dense_cfg, device, seed=0), build_serving_dit(sparse_cfg, device, seed=1)


def cp_entry(world: int, device: str = "cuda") -> dict:
    """(a): on every rank of a NCCL group of ``world`` (one card each,
    parallel/launch.py::init_distributed, a mesh of cp = world): the 2B DiT
    at 720p through Ulysses and through ring, the sparse 2B's Ulysses + NA
    block, and the causal 2B stream at 720p with head-sharded caches (dense,
    then with the row window), each against the same net unsharded on the
    rank; launches counted per path, from 0 just before it."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.networks.dit import set_context_parallel
    from cosmos_predict2_tpu_torch.parallel.comm import COMM
    from cosmos_predict2_tpu_torch.parallel.launch import init_distributed, world_info
    from cosmos_predict2_tpu_torch.parallel.mesh import make_mesh
    from cosmos_predict2_tpu_torch.scripts import interactive_latency as il

    info = init_distributed(device=device)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    group = make_mesh(cp=world, device_type=dev.type).get_group("cp")
    rank = info["process_index"]
    out = {"world": world_info(), "paths": {}}
    gen = torch.Generator(device=dev).manual_seed(5)
    dense, sparse = _cp_nets(dev)
    T, H, W = CP_LATENT
    text_dim = dense.cfg.crossattn_proj_in_channels if dense.cfg.use_crossattn_projection else \
        dense.cfg.crossattn_emb_channels
    x = torch.randn((1, 16, T, H, W), generator=gen, device=dev)
    ctx = (torch.randn((1, 512, text_dim), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    ts = torch.full((1,), 700.0, device=dev)

    def drive(name, net, strategy, want):
        """net unsharded, then context-parallel by ``strategy``: the errors of the CP output and its launches."""
        set_context_parallel(net, None)
        with torch.no_grad():
            ref = net(x, ts, ctx)
        net.cfg = dataclasses.replace(net.cfg, cp_strategy=strategy)
        set_context_parallel(net, group)
        torch.cuda.synchronize()
        COMM.reset()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            got = net(x, ts, ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _build.launch_counts()
        set_context_parallel(net, None)
        max_abs, rel = errors(got, ref)
        ok = bool(torch.isfinite(got).all()) and got.shape == ref.shape and rel <= KERNEL_REL_L2
        seen = {k: counts[k] for k in want}
        out["paths"][name] = {"counts": counts, "max_abs": max_abs, "rel_l2": rel, "s": wall,
                              "comm_bytes": dict(COMM.bytes), "comm_calls": dict(COMM.calls)}
        if rank == 0:
            log(f"  (a) {name}: cp={world} vs unsharded on rank 0: max_abs {max_abs:.3e} rel_l2 {rel:.3e} (limit "
                f"{KERNEL_REL_L2}); {wall:.2f} s; launches {seen} (want {want}); collectives {dict(COMM.calls)}, "
                f"bytes in {dict(COMM.bytes)}")
        if not ok or seen != want:
            raise AssertionError(f"(a) {name}: rel_l2 {rel:.3e}, launches {seen}, want {want}")

    # a block: one self-attention (Ulysses) or one K1 per ring step (world), and the cross-attention
    drive("cp_ulysses", dense, "ulysses", {"flash_attention_fwd": 2 * CP_DEPTH})
    drive("cp_ring", dense, "ring", {"flash_attention_fwd": (world + 1) * CP_DEPTH})
    drive("cp_sparse", sparse, "ulysses", {"na_fwd": 1, "flash_attention_fwd": 1})
    del dense, sparse
    fresh_memory()

    # the causal 2B stream at 720p, head-sharded caches, against the same loop unsharded
    h, w = CP_STREAM_HW
    cfg = dataclasses.replace(il.NET_2B, num_blocks=CP_DEPTH)
    noise = [torch.randn((1, 16, 1, h, w), generator=gen, device=dev) for _ in range(CP_STREAM_BLOCKS)]
    init = torch.randn((1, 16, 1, h, w), generator=gen, device=dev)
    for window, kernel in ((-1, "flash_attention_kv_cache"), (CP_WINDOW, "flash_attention_kv_cache_window")):
        stream = il.build_stream(cfg, 1, CP_STREAM_CACHE, INTERACTIVE_STEPS, window, dev, seed=2)
        cond = il.text_condition(stream, dev)
        run = lambda: stream.generate(cond, init, 1 + CP_STREAM_BLOCKS, (h, w), draw=lambda s, shape: noise[s])
        ref = run()
        set_context_parallel(stream.model.net, group)
        heads = stream.model.init_kv_caches(1, 1, h, w, dev)[0]["k"].shape[1]
        torch.cuda.synchronize()
        COMM.reset()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _build.launch_counts()
        max_abs, rel = errors(got, ref)
        n = CP_DEPTH * (1 + CP_STREAM_BLOCKS * (INTERACTIVE_STEPS + 1))
        want = {kernel: n, "flash_attention_fwd": n}
        seen = {k: counts[k] for k in want}
        name = "cp_stream" if window < 0 else "cp_stream_window"
        out["paths"][name] = {"counts": counts, "max_abs": max_abs, "rel_l2": rel, "s": wall, "cache_heads": heads,
                              "comm_bytes": dict(COMM.bytes), "comm_calls": dict(COMM.calls)}
        if rank == 0:
            log(f"  (a) {name}: causal 2B ({CP_DEPTH} blocks) at {h}x{w}, {CP_STREAM_BLOCKS} blocks after a "
                f"prefilled frame, caches of {heads} of 16 heads a rank: cp={world} vs unsharded max_abs {max_abs:.3e} "
                f"rel_l2 {rel:.3e} (limit {STREAM_REL_L2}); {wall:.2f} s; launches {seen} (want {want}); bytes into "
                f"collectives {dict(COMM.bytes)}")
        if not (bool(torch.isfinite(got).all()) and rel <= STREAM_REL_L2 and seen == want
                and heads == 16 // world):
            raise AssertionError(f"(a) {name}: rel_l2 {rel:.3e}, launches {seen}, heads {heads}")
        del stream, cond, ref, got
        fresh_memory()
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def world_slice(entry: str, device: str = "cuda") -> dict:
    """A world-size entry (cp_entry, mesh_entry) at the machine's world
    size, every card a NCCL rank. One card: the rank runs in this process;
    more: spawned, one process a card; rank 0's result."""
    import torch

    world = torch.cuda.device_count()
    log(f"  (a) world size {world} (torch.cuda.device_count()), {'NCCL' if device == 'cuda' else device}, "
        "tcp://localhost")
    port = _free_port()
    if world == 1:
        saved = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(port))
        from cosmos_predict2_tpu_torch.parallel.launch import shutdown_distributed

        try:
            return globals()[entry](1, device)
        finally:
            shutdown_distributed()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    import torch.multiprocessing as mp

    result_dir = OUT_DIR / f"{entry}_ranks"
    result_dir.mkdir(parents=True, exist_ok=True)
    mp.spawn(_world_rank, args=(world, port, str(result_dir), entry, device), nprocs=world, join=True)
    return json.loads((result_dir / "rank0.json").read_text())


def _shard_heads(fn, tensors, shards: int, head_dim_of):
    """fn over head shards of ``tensors`` (each with its heads at
    ``head_dim_of[i]``), the outputs concatenated on their head dim 2."""
    import torch

    outs = []
    for r in range(shards):
        part = []
        for t, hd in zip(tensors, head_dim_of):
            n = t.shape[hd] // shards
            part.append(t.narrow(hd, r * n, n).contiguous())
        outs.append(fn(*part))
    return torch.cat(outs, dim=2)


def cp_rank_programs(smi: str) -> dict:
    """(b): the rank programs of cp = CP_SHARDS at full width on this card.
    Each rank's local computation gets the shards the collectives would
    deliver; the results are assembled and held against the unsharded
    kernel's at KERNEL_REL_L2; one rank's program is timed (CUDA events)."""
    import torch
    import torch.nn.functional as F

    from cosmos_predict2_tpu_torch.ops import neighborhood_attention as na
    from cosmos_predict2_tpu_torch.ops.conv3d import conv3d_causal
    from cosmos_predict2_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_kv_cache,
        flash_attention_kv_cache_window,
    )
    from cosmos_predict2_tpu_torch.parallel.ring_attention import merge

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    c = CP_SHARDS
    rows = []

    def hold(name, got, ref, rank_ms, whole_ms, note):
        max_abs, rel = errors(got, ref)
        rows.append({"name": name, "max_abs": max_abs, "rel_l2": rel, "rank_ms": rank_ms, "whole_ms": whole_ms})
        log(f"  (b) {name}: assembled vs unsharded max_abs {max_abs:.3e} rel_l2 {rel:.3e} (limit {KERNEL_REL_L2}); "
            f"one rank's program {rank_ms:.3f} ms, the unsharded call {whole_ms:.3f} ms; {note}")
        if not (bool(torch.isfinite(got).all()) and rel <= KERNEL_REL_L2):
            raise AssertionError(f"(b) {name}: rel_l2 {rel:.3e}")

    T, Hl, Wl = CP_LATENT
    S, H, D = T * (Hl // 2) * (Wl // 2), 16, 128
    q, k, v = (torch.randn((1, S, H, D), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    ref, _ = flash_attention_fwd(q, k, v)
    whole = cuda_ms(lambda: flash_attention_fwd(q, k, v), 0, 1)
    got = _shard_heads(lambda a, b, d: flash_attention_fwd(a, b, d)[0], (q, k, v), c, (2, 2, 2))
    qs = q[:, :, :H // c].contiguous()
    ks, vs = k[:, :, :H // c].contiguous(), v[:, :, :H // c].contiguous()
    hold("K1 Ulysses", got, ref, cuda_ms(lambda: flash_attention_fwd(qs, ks, vs), 0, 1), whole,
         f"{S} tokens x {H // c} heads a rank")
    del qs, ks, vs
    # ring: rank r's queries against each source shard in ring order, merged by lse
    sl = S // c
    parts = []
    for r in range(c):
        qr = q[:, r * sl:(r + 1) * sl].contiguous()
        acc = (torch.zeros((1, sl, H, D), dtype=torch.float32, device=dev),
               torch.full((1, H, sl), float("-inf"), dtype=torch.float32, device=dev))
        for step in range(c):
            src = (r - step) % c
            acc = merge(acc, flash_attention_fwd(qr, k[:, src * sl:(src + 1) * sl].contiguous(),
                                                 v[:, src * sl:(src + 1) * sl].contiguous()))
        parts.append(acc[0].to(torch.bfloat16))
    got = torch.cat(parts, dim=1)
    q0, k0, v0 = (t[:, :sl].contiguous() for t in (q, k, v))
    hold("K1 ring", got, ref, c * cuda_ms(lambda: flash_attention_fwd(q0, k0, v0), 0, 1), whole,
         f"{c} x {c} blocks of {sl} x {sl} x {H} heads, merged by lse in fp32; a rank's {c} blocks")
    del q0, k0, v0, parts, got, ref
    # K10 on head shards: the sparse 2B's 720p window
    grid = (T, Hl // 2, Wl // 2)
    size = na.VideoSize(*grid)
    wdw, std, dil = na.adaptive_na_parameters((-1, 12, 24), (1, 4, 8), grid, NA_BASE, (1, 1, 1))
    nat = lambda a, b, d: na.neighborhood_attention(a, b, d, size, wdw, std, dil)
    ref = nat(q, k, v)
    whole = cuda_ms(lambda: nat(q, k, v), 0, 1)
    got = _shard_heads(nat, (q, k, v), c, (2, 2, 2))
    qs, ks, vs = (t[:, :, :H // c].contiguous() for t in (q, k, v))
    hold("K10 Ulysses + NA", got, ref, cuda_ms(lambda: nat(qs, ks, vs), 0, 1), whole,
         f"window {wdw} stride {std} on {grid}, {H // c} heads a rank (layout copies included)")
    del q, k, v, qs, ks, vs, ref, got
    fresh_memory()
    # K5 / K6 on head-sharded caches of 9 frames of 3,520 tokens
    gh, gw = CP_STREAM_HW[0] // 2, CP_STREAM_HW[1] // 2
    sb, smax = gh * gw, (CP_STREAM_CACHE + 1) * gh * gw
    qb = torch.randn((1, sb, H, D), generator=gen, device=dev).to(torch.bfloat16)
    kb, vb = (torch.randn((1, H, smax, D), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    for name, fn in (("K5 head-sharded cache", lambda a, b, d: flash_attention_kv_cache(a, b, d, smax)),
                     ("K6 head-sharded cache", lambda a, b, d: flash_attention_kv_cache_window(
                         a, b, d, smax, (gh, gw), CP_WINDOW))):
        ref = fn(qb, kb, vb)
        whole = cuda_ms(lambda: fn(qb, kb, vb), 0, 3)
        got = _shard_heads(fn, (qb, kb, vb), c, (2, 1, 1))
        qs, ks, vs = qb[:, :, :H // c].contiguous(), kb[:, :H // c].contiguous(), vb[:, :H // c].contiguous()
        hold(name, got, ref, cuda_ms(lambda: fn(qs, ks, vs), 0, 3), whole,
             f"q {sb} tokens, cache {smax} tokens, {H // c} heads a rank")
    del qb, kb, vb, qs, ks, vs
    fresh_memory()
    # K2 on halo'd 720p decoder slabs of a 2 x 2 grid, cropped
    for label, (t_in, ch, hh, ww) in (("K2 halo'd decoder slab 88x160 384->384", (4, 384, 88, 160)),
                                      ("K2 halo'd decoder slab 704x1280 96->96", (3, 96, 704, 1280))):
        xw = torch.randn((1, t_in, hh, ww, ch), generator=gen, device=dev).to(torch.bfloat16)
        wt = (torch.randn((3, 3, 3, ch, ch), generator=gen, device=dev) / (27 * ch) ** 0.5).to(torch.bfloat16)
        bias = torch.zeros(ch, device=dev)
        ref = conv3d_causal(xw, wt, bias)
        whole = cuda_ms(lambda: conv3d_causal(xw, wt, bias), 0, 1)
        padded = F.pad(xw, (0, 0, 1, 1, 1, 1))  # zeros beyond the clip: the halo an edge rank gets
        h2, w2 = hh // 2, ww // 2
        got = torch.empty_like(ref)
        for ih in range(2):
            for iw in range(2):
                slab = padded[:, :, ih * h2:ih * h2 + h2 + 2, iw * w2:iw * w2 + w2 + 2].contiguous()
                got[:, :, ih * h2:(ih + 1) * h2, iw * w2:(iw + 1) * w2] = conv3d_causal(slab, wt, bias)[:, :, 1:-1, 1:-1]
        slab = padded[:, :, :h2 + 2, :w2 + 2].contiguous()
        hold(label, got, ref, cuda_ms(lambda: conv3d_causal(slab, wt, bias), 0, 1), whole,
             f"T_in {t_in}, a rank's slab {h2 + 2}x{w2 + 2} with its 1-pixel halo, cropped to {h2}x{w2}")
        del xw, padded, slab, ref, got
        fresh_memory()
    return {"rows": rows}


def context_parallel_slice(smi: str) -> dict:
    """Phase 20: (a) the real entry at the machine's world size, (b) the
    rank programs of cp = 4 at full width; with the reckoning of what cp = 4
    would move. (A cut: (c), scripts/interactive_latency.py's --cp-proxy
    ladder, a measurement with no check, left to make room for phase 21;
    its last figures are in PERF.md.)"""
    T, H, W = CP_LATENT
    tokens = T * (H // 2) * (W // 2)
    share = tokens // CP_SHARDS * 16 * 128 * 2  # a rank's q, k, v or output at cp = 4, bf16
    cache = NUM_BLOCKS * 2 * 16 * (CP_STREAM_CACHE + 1) * (CP_STREAM_HW[0] // 2) * (CP_STREAM_HW[1] // 2) * 128 * 2
    log(f"  reckoning at cp={CP_SHARDS}, {tokens} tokens: Ulysses moves 4 x {share / 1e6:.1f} MB x 3/4 = "
        f"{4 * share * 3 / 4 / 1e6:.1f} MB a rank per self-attention, {NUM_BLOCKS * 4 * share * 3 / 4 / 1e9:.2f} GB "
        f"a {NUM_BLOCKS}-block forward; ring {2 * share * (CP_SHARDS - 1) / 1e6:.1f} MB a rank per call; the "
        f"720p cache ({CP_STREAM_CACHE} + 1 frames) {cache / 1e9:.2f} GB whole, {cache / CP_SHARDS / 1e9:.2f} GB a rank")
    a = world_slice("cp_entry")
    b = cp_rank_programs(smi)
    return {"world": a["world"], "paths": a["paths"], "programs": b["rows"]}


# ---------------- the training mesh (phase 21) ----------------

MESH_DEPTH = 4  # blocks of the full-width 2B in (a) (a cut: depth)
MESH_CLIP = (29, 192, 320)  # (a)'s mock clips: 8 latent frames of 12 x 20 tokens, 1,920 tokens a sample
MESH_STEPS = 2
# the wrapped run against the unwrapped one: at world size 1 step 0's loss
# is bit-equal (FSDP2 at one rank all-gathers copies) and its gradient norm
# within fp32 sums in another order (the norm over DTensor shards); the clip
# by that norm moves the update by fp32 ulps, which the next bf16 forward
# rounds on, so later steps, and every step on more cards (the slabs change
# bf16 GEMM shapes), are held at phase 6's bf16 limits
MESH_ONE_REL = 1e-5
RING_SHARDS = 4  # the cp degree of (b)'s ring-backward rank programs


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def mesh_axes(world: int) -> tuple[int, int, int, int]:
    """(dp, fsdp, cp, tp) for ``world`` cards, as __graft_entry__.py's _pick_axes factors them."""
    if world >= 8:
        return world // 8, 2, 2, 2
    return {4: (1, 2, 2, 1), 2: (1, 1, 2, 1)}.get(world, (1, 1, 1, 1))


def mesh_entry(world: int, device: str = "cuda") -> dict:
    """(a): on every rank of a NCCL group of ``world`` cards, the (dp,
    fsdp, cp, tp) mesh of :func:`mesh_axes`: the full-width 2B at
    MESH_DEPTH blocks, context-parallel over cp (when above 1) and sharded
    by parallel/mesh.py::parallelize, trains MESH_STEPS steps through the
    trainer on mock clips encoded on each rank (its rows of the global
    batch); rank 0 trains the same net unwrapped on the whole batch and
    holds losses, grad norms and the parameters' update against it. Then a
    DCP save, a third step, a fresh state loaded from the save and the same
    step resumed on it; then one step of the resumed state with
    cp_strategy="ring" (the cp group set even at cp 1) against the same
    step of the unbroken state. Launches counted per path, from 0 just
    before it."""
    import shutil

    import torch
    import torch.distributed as dist

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.data.mock import MockDataLoader
    from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import build_dit, set_context_parallel
    from cosmos_predict2_tpu_torch.parallel.launch import init_distributed, world_info
    from cosmos_predict2_tpu_torch.parallel.mesh import make_mesh, parallelize
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae
    from cosmos_predict2_tpu_torch.training.checkpointing import Checkpointer
    from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig, global_norm
    from cosmos_predict2_tpu_torch.training.train import latent_batches
    from cosmos_predict2_tpu_torch.training.trainer import Trainer, TrainerConfig, data_shard

    info = init_distributed(device=device)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    axes = mesh_axes(world)
    mesh = make_mesh(*axes, device_type=dev.type)
    rank, (index, count), c = info["process_index"], data_shard(mesh), axes[2]
    frames, h, w = MESH_CLIP
    cfg = make_config(DENSE_EXPERIMENT, [
        f"data_train.num_frames={frames}", f"data_train.height={h}", f"data_train.width={w}",
        "data_train.text_dim=100352", f"data_train.batch_size={count}", "model.state_t=8"])
    net_cfg = dataclasses.replace(cfg.model.net, num_blocks=MESH_DEPTH, remat="none")
    model_cfg = dataclasses.replace(cfg.model, net=net_cfg)
    # a constant rate of 1e-5 (the recipe's warm-up starts at 1e-6 of its rate): two steps move fp32 weights;
    # bf16 moments (AdamWBF16, the noise of each shard cut from the whole draw): a quarter less state to save
    opt = OptimizerConfig(lr=1e-5, warm_up_steps=(0,), f_start=(1.0,), f_max=(1.0,), f_min=(1.0,),
                          cycle_lengths=(1000,), moments_dtype="bfloat16")
    tc = TrainerConfig(max_iter=MESH_STEPS + 2, logging_iter=1000, save_iter=0, seed=0, ema_enabled=True,
                       optimizer=opt)
    vae = build_vae(cfg.tokenizer, dev, seed=1)
    ckpt_dir = OUT_DIR / "mesh_ckpt"
    if rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    dist.barrier()

    def trainer_for(seed, wrapped, strategy="ulysses", cp_group=c > 1):
        net = build_dit(dataclasses.replace(net_cfg, cp_strategy=strategy), dev, seed=seed, trainable=True)
        if wrapped and cp_group:
            set_context_parallel(net, mesh.get_group("cp"))
        if wrapped:
            parallelize(net, mesh)
        rec = MeshStepRecord()
        return Trainer(tc, Video2WorldModel(model_cfg, net), callbacks=[rec]), rec

    def update_norm(state, start):
        with torch.no_grad():
            return float(global_norm([p - p0 for p, p0 in zip(state.params.values(), start)]))

    out = {"world": world_info(), "axes": axes, "paths": {}}
    # the wrapped run: MESH_STEPS steps on clips encoded in the trainer's data section
    trainer, rec = trainer_for(0, wrapped=True)
    state = trainer.init_state()
    start = [p.detach().clone() for p in state.params.values()]
    batches = latent_batches(MockDataLoader(cfg.data_train), vae, dev, rows=(index, count))
    sync()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.train(state, (next(batches) for _ in range(MESH_STEPS)))
    sync()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    moved = update_norm(state, start)
    del start
    out["paths"]["mesh_train"] = {"counts": counts, "s": wall, "steps": rec.steps, "update_norm": moved}
    # rank 0: the same net and steps unwrapped, on the whole global batch
    if rank == 0:
        ref_trainer, ref_rec = trainer_for(0, wrapped=False)
        ref_state = ref_trainer.init_state()
        ref_start = [p.detach().clone() for p in ref_state.params.values()]
        ref_batches = latent_batches(MockDataLoader(cfg.data_train), vae, dev)
        ref_state = ref_trainer.train(ref_state, (next(ref_batches) for _ in range(MESH_STEPS)))
        ref_moved = update_norm(ref_state, ref_start)
        del ref_trainer, ref_state, ref_start, ref_batches
        rows, worst = [], 0.0
        for i, (a, b) in enumerate(zip(rec.steps, ref_rec.steps)):
            loss_rel, norm_rel = _rel(a["loss"], b["loss"]), _rel(a["grad_norm"], b["grad_norm"])
            rows.append((a["loss"], b["loss"], loss_rel, a["grad_norm"], b["grad_norm"], norm_rel))
            exact = world == 1 and i == 0
            worst = max(worst, loss_rel / TRAIN_LOSS_REL, norm_rel / (MESH_ONE_REL if exact else TRAIN_GRAD_REL_L2),
                        float("inf") if exact and loss_rel else 0.0)
        upd_rel = _rel(moved, ref_moved)
        worst = max(worst, upd_rel / TRAIN_GRAD_REL_L2)
        bit_equal = all(r[0] == r[1] and r[3] == r[4] for r in rows) and moved == ref_moved
        out["reference"] = {"steps": rows, "update_norm": (moved, ref_moved, upd_rel), "bit_equal": bit_equal}
        log(f"  (a) mesh {axes} (dp, fsdp, cp, tp) on {world} card(s), the full-width 2B at {MESH_DEPTH} blocks, "
            f"{frames} frames at {h}x{w}, a global batch of {count}: {MESH_STEPS} steps through parallelize and "
            f"the trainer in {wall:.2f} s, launches {counts}")
        for i, r in enumerate(rows):
            log(f"      step {i}: loss {r[0]:.9g} vs unwrapped {r[1]:.9g} (rel {r[2]:.3e}); grad_norm {r[3]:.9g} vs "
                f"{r[4]:.9g} (rel {r[5]:.3e})")
        log(f"      parameter update norm {moved:.9g} vs unwrapped {ref_moved:.9g} (rel {upd_rel:.3e}); "
            f"{'bit-equal' if bit_equal else 'not bit-equal'}; limits: "
            f"{'step 0 loss equal, its grad_norm ' + str(MESH_ONE_REL) + '; then ' if world == 1 else ''}"
            f"loss {TRAIN_LOSS_REL}, norms {TRAIN_GRAD_REL_L2}")
        fresh_memory()
        if not worst <= 1.0 or not moved > 0:
            raise AssertionError(f"(a) the wrapped steps disagree with the unwrapped ones: {rows}, update {upd_rel}")
    dist.barrier()
    for i, step in enumerate(rec.steps):  # a dense block: self- and cross-attention, each K1 / K7 / K8 once
        want = {"flash_attention_fwd": 2 * MESH_DEPTH, "flash_attention_bwd_dq": 2 * MESH_DEPTH,
                "flash_attention_bwd_dkv": 2 * MESH_DEPTH}
        if {k: step["counts"][k] for k in want} != want:
            raise AssertionError(f"(a) mesh step {i} launched {step['counts']}, want {want}")
    if counts["conv3d_causal"] == 0:  # the clips' encode, in the trainer's data section before each step
        raise AssertionError("(a) conv3d_causal never ran in the mesh run's VAE encode")

    # a DCP save, an unbroken third step, and the same step resumed on a fresh state loaded from the save
    batch = next(batches)
    t0 = time.perf_counter()
    Checkpointer(str(ckpt_dir)).save(state, state.step)
    save_s = time.perf_counter() - t0
    state = trainer.train(state, [batch], start_iteration=state.step)
    unbroken = rec.steps[-1]["loss"]
    fresh, fresh_rec = trainer_for(7, wrapped=True, strategy="ring", cp_group=True)
    t0 = time.perf_counter()
    resumed = Checkpointer(str(ckpt_dir)).load(fresh.init_state())
    load_s = time.perf_counter() - t0
    fresh.model.net.cfg = dataclasses.replace(fresh.model.net.cfg, cp_strategy="ulysses")
    resumed = fresh.train(resumed, [batch], start_iteration=resumed.step)
    again = fresh_rec.steps[-1]["loss"]
    with torch.no_grad():
        same = (float(global_norm(list(state.params.values()))), float(global_norm(list(resumed.params.values()))))
    # the ring: one step of the resumed state against the same step of the unbroken one
    fresh.model.net.cfg = dataclasses.replace(fresh.model.net.cfg, cp_strategy="ring")
    state = trainer.train(state, [batch], start_iteration=state.step)
    sync()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    resumed = fresh.train(resumed, [batch], start_iteration=resumed.step)
    sync()
    ring_s = time.perf_counter() - t0
    ring_counts = _build.launch_counts()
    ring_loss, dense_loss = fresh_rec.steps[-1]["loss"], rec.steps[-1]["loss"]
    out["paths"]["mesh_ring_train"] = {"counts": ring_counts, "s": ring_s, "loss": ring_loss, "unbroken": dense_loss}
    out["dcp"] = {"save_s": save_s, "load_s": load_s, "unbroken": unbroken, "resumed": again, "param_norms": same}
    want = {k: (c + 1) * MESH_DEPTH for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                                              "flash_attention_bwd_dkv")}
    ring_rel = _rel(ring_loss, dense_loss)
    if rank == 0:
        log(f"  (a) DCP save at step {MESH_STEPS} {save_s:.2f} s, load into a fresh state (other weights) "
            f"{load_s:.2f} s; step {MESH_STEPS} resumed: loss {again:.9g} vs unbroken {unbroken:.9g} "
            f"({'equal' if again == unbroken else f'rel {_rel(again, unbroken):.3e}'}); parameter norms "
            f"{same[0]:.9g} / {same[1]:.9g}")
        log(f"  (a) a step with cp_strategy='ring' (cp {c}): loss {ring_loss:.9g} vs {dense_loss:.9g} without "
            f"(rel {ring_rel:.3e}, limit {TRAIN_LOSS_REL}); {ring_s:.2f} s; launches "
            f"{ {k: ring_counts[k] for k in want} } (want {want})")
    if _rel(again, unbroken) > MESH_ONE_REL or _rel(*same) > MESH_ONE_REL:
        raise AssertionError(f"(a) the resumed step {again} differs from the unbroken {unbroken}")
    if {k: ring_counts[k] for k in want} != want or not ring_rel <= TRAIN_LOSS_REL:
        raise AssertionError(f"(a) the ring step launched {ring_counts}, want {want}; loss rel {ring_rel:.3e}")
    del trainer, fresh, state, resumed, vae
    fresh_memory()
    dist.barrier()
    if rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def _world_rank(rank: int, world: int, port: int, result_dir: str, entry: str, device: str = "cuda") -> None:
    """One spawned rank of a world-size entry (cp_entry, mesh_entry) on a machine with several cards."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cosmos_predict2_tpu_torch.parallel.launch import shutdown_distributed

    try:
        res = globals()[entry](world, device)
    finally:
        shutdown_distributed()
    (Path(result_dir) / f"rank{rank}.json").write_text(json.dumps(res))


def ring_backward_programs(smi: str) -> dict:
    """(b): the rank programs of the ring's backward at cp = RING_SHARDS, at
    phase 20's 84,480 tokens x 16 heads of 128 in bf16, on this card: rank
    r's queries against each source shard, K7 adding to its fp32 dq and K8
    to the source's fp32 dK / dV, with the whole sequence's lse and delta
    (the forward's), assembled and held against K7 / K8 on the whole
    sequence (FlashAttention's backward) at KERNEL_REL_L2; rank 0's program
    (its c K7 and c K8 calls) timed beside the whole call (CUDA events)."""
    import torch

    from cosmos_predict2_tpu_torch.ops.flash_attention import (
        attention_delta,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    T, Hl, Wl = CP_LATENT
    S, H, D, c = T * (Hl // 2) * (Wl // 2), 16, 128, RING_SHARDS
    sl = S // c
    q, k, v, do = (torch.randn((1, S, H, D), generator=gen, device=dev).to(torch.bfloat16) for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v)
    delta = attention_delta(out, do)
    del out
    whole = lambda: (flash_attention_bwd_dq(q, k, v, do, lse, delta), flash_attention_bwd_dkv(q, k, v, do, lse, delta))
    ref_dq, (ref_dk, ref_dv) = whole()
    whole_ms = cuda_ms(whole, 0, 1)
    part = lambda t, i: t[:, i * sl:(i + 1) * sl].contiguous()
    rows = lambda t, i: t[:, :, i * sl:(i + 1) * sl].contiguous()

    def program(r, dq, dkv):
        """Rank r's backward blocks; adds into dq (its rows) and dkv[src] (fp32)."""
        qr, dor, lr, dr = part(q, r), part(do, r), rows(lse, r), rows(delta, r)
        for step in range(c):
            src = (r - step) % c
            ks, vs = part(k, src), part(v, src)
            dq += flash_attention_bwd_dq(qr, ks, vs, dor, lr, dr).float()
            dk_b, dv_b = flash_attention_bwd_dkv(qr, ks, vs, dor, lr, dr)
            dkv[src][0] += dk_b.float()
            dkv[src][1] += dv_b.float()

    dkv = [[torch.zeros((1, sl, H, D), device=dev) for _ in range(2)] for _ in range(c)]
    dqs = [torch.zeros((1, sl, H, D), device=dev) for _ in range(c)]
    for r in range(c):
        program(r, dqs[r], dkv)
    got = {"dq": torch.cat(dqs, 1), "dk": torch.cat([d[0] for d in dkv], 1), "dv": torch.cat([d[1] for d in dkv], 1)}
    spare_dq, spare_dkv = dqs[0].clone(), [[t.clone() for t in d] for d in dkv]  # the timed call adds into copies
    rank_ms = cuda_ms(lambda: program(0, spare_dq, spare_dkv), 0, 1)
    result = {"rank_ms": rank_ms, "whole_ms": whole_ms, "tokens": S, "shards": c}
    for name, ref in (("dq", ref_dq), ("dk", ref_dk), ("dv", ref_dv)):
        max_abs, rel = errors(got[name].to(torch.bfloat16), ref)
        result[name] = {"max_abs": max_abs, "rel_l2": rel}
        if not (bool(torch.isfinite(got[name]).all()) and rel <= KERNEL_REL_L2):
            raise AssertionError(f"(b) ring backward {name}: rel_l2 {rel:.3e}")
    log(f"  (b) ring backward at cp={c}: {c} x {c} blocks of {sl} x {sl} x {H} heads, K7 + K8 per block with the "
        f"global lse, fp32 sums: dq rel_l2 {result['dq']['rel_l2']:.3e}, dk {result['dk']['rel_l2']:.3e}, dv "
        f"{result['dv']['rel_l2']:.3e} against K7 / K8 on the whole {S} tokens (limit {KERNEL_REL_L2}); one rank's "
        f"program ({c} K7 + {c} K8) {rank_ms:.3f} ms, the whole call {whole_ms:.3f} ms, on {smi}")
    del q, k, v, do, lse, delta, ref_dq, ref_dk, ref_dv, got, dkv, dqs, spare_dq, spare_dkv
    fresh_memory()
    return result


def training_mesh_slice(smi: str) -> dict:
    """Phase 21: (a) the training mesh at the machine's world size, (b) the
    ring backward's rank programs at cp = RING_SHARDS."""
    a = world_slice("mesh_entry")
    b = ring_backward_programs(smi)
    return {"world": a["world"], "axes": a["axes"], "paths": a["paths"], "dcp": a["dcp"],
            "reference": a.get("reference"), "ring_programs": b}


# ---------------- the last mesh gaps (phase 22) ----------------

VARIANT_MESH_DEPTH = 4  # blocks (Wan: layers) of each full-width net in phase 22 (a cut: depth)
LORA_MESH_CLIP = (29, 192, 320)  # (a)'s mock clips: 8 latent frames of 12 x 20 tokens, 1,920 tokens a sample
LORA_MESH_STEPS = 2
WAN_MESH_CLIP = (25, 480, 832)  # (b)'s clips: 7 latent frames of 30 x 52 tokens, 10,920 tokens a sample
WAN_MESH_STEPS = 2
MV_CP_FRAMES = 13  # (c): 4 latent frames a view, 7 views packed on T: 28 frames of 12 x 20 tokens, 6,720 tokens
MV_CP_HW = (192, 320)
MV_CP_STEPS = 1  # UniPC steps of (c)'s request
# a constant rate of 1e-5 (a recipe's warm-up starts at 1e-6 of its rate): the steps move fp32 weights
MESH_OPT = dict(lr=1e-5, warm_up_steps=(0,), f_start=(1.0,), f_max=(1.0,), f_min=(1.0,), cycle_lengths=(1000,))


def variant_axes(world: int) -> dict:
    """Phase 22's (dp, fsdp, cp, tp) meshes for ``world`` cards: (a)'s
    LoRA meshes (tp, then cp), (b)'s Wan mesh (tp) and (c)'s cp degree."""
    if world == 1:
        return {"lora": [(1, 1, 1, 1)], "wan": (1, 1, 1, 1), "cp": 1}
    half = world // 2
    return {"lora": [(1, half, 1, 2), (1, half, 2, 1)], "wan": (1, half, 1, 2), "cp": world}


class MeshStepRecord:
    """Trainer callback: each step's global loss, grad norm and launches."""

    def __init__(self):
        self.steps = []

    def on_train_start(self, trainer, state): ...

    def on_training_step_start(self, trainer, state, batch, iteration):
        from cosmos_predict2_tpu_torch import _build

        self.counts0 = _build.launch_counts()

    def on_training_step_end(self, trainer, state, metrics, iteration):
        from cosmos_predict2_tpu_torch import _build

        now = _build.launch_counts()
        self.steps.append({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                           "counts": {k: now[k] - self.counts0[k] for k in now}})

    def on_save_checkpoint(self, trainer, state, iteration): ...

    def on_train_end(self, trainer, state): ...


def hold_steps(name: str, world: int, steps: list, ref: list) -> dict:
    """Rank 0: a wrapped run's steps against the unwrapped run's, at phase
    21's bounds: at world size 1 step 0's loss bit-equal and its grad norm
    within MESH_ONE_REL; the rest, and every step on more cards, within
    TRAIN_LOSS_REL and TRAIN_GRAD_REL_L2."""
    rows, worst = [], 0.0
    for i, (a, b) in enumerate(zip(steps, ref)):
        loss_rel, norm_rel = _rel(a["loss"], b["loss"]), _rel(a["grad_norm"], b["grad_norm"])
        rows.append((a["loss"], b["loss"], loss_rel, a["grad_norm"], b["grad_norm"], norm_rel))
        exact = world == 1 and i == 0
        worst = max(worst, loss_rel / TRAIN_LOSS_REL, norm_rel / (MESH_ONE_REL if exact else TRAIN_GRAD_REL_L2),
                    float("inf") if exact and loss_rel else 0.0)
        log(f"      {name} step {i}: loss {a['loss']:.9g} vs unwrapped {b['loss']:.9g} (rel {loss_rel:.3e}); grad_norm "
            f"{a['grad_norm']:.9g} vs {b['grad_norm']:.9g} (rel {norm_rel:.3e})")
    bit_equal = all(r[0] == r[1] and r[3] == r[4] for r in rows)
    if len(rows) != len(ref) or not worst <= 1.0:
        raise AssertionError(f"{name}: the wrapped steps disagree with the unwrapped ones: {rows}")
    return {"steps": rows, "bit_equal": bit_equal}


def check_step_counts(name: str, steps: list, want: dict) -> None:
    for i, step in enumerate(steps):
        if {k: step["counts"][k] for k in want} != want:
            raise AssertionError(f"{name} step {i} launched {step['counts']}, want {want}")


def _mesh_lora_run(axes, dev, rank: int, world: int) -> dict:
    """(a) one mesh: the LoRA recipe (its rank, alpha and targets, block
    remat) on the full-width 2B at VARIANT_MESH_DEPTH blocks, LORA_MESH_STEPS
    steps through training/train.py::launch on mock clips (each rank
    encodes its rows); rank 0 then runs launch's one-device route by hand
    on the whole batch and holds the steps against it."""
    import torch
    import torch.distributed as dist

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel
    from cosmos_predict2_tpu_torch.networks.dit import build_dit
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae
    from cosmos_predict2_tpu_torch.training.lora import LoRAModelWrapper
    from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
    from cosmos_predict2_tpu_torch.training.train import latent_batches, launch, make_loader
    from cosmos_predict2_tpu_torch.training.trainer import Trainer

    dp, fsdp, cp, tp = axes
    frames, h, w = LORA_MESH_CLIP
    cfg = make_config(LORA_EXPERIMENT, [
        f"data_train.num_frames={frames}", f"data_train.height={h}", f"data_train.width={w}",
        "data_train.text_dim=100352", f"data_train.batch_size={dp * fsdp}", "model.state_t=8",
        f"fsdp_shard_size={fsdp}", f"cp_size={cp}", f"tp_size={tp}"])
    tc = dataclasses.replace(cfg.trainer, max_iter=LORA_MESH_STEPS, logging_iter=1000, save_iter=0,
                             optimizer=OptimizerConfig(**MESH_OPT))
    mc = dataclasses.replace(cfg.model, net=dataclasses.replace(cfg.model.net, num_blocks=VARIANT_MESH_DEPTH))
    cfg = dataclasses.replace(cfg, trainer=tc, model=mc)
    rec = MeshStepRecord()
    t0 = time.perf_counter()
    state = launch(cfg, device="cuda", callbacks=[rec])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    adapters = sorted(state.params)
    if not all(n.endswith((".lora_A", ".lora_B")) for n in adapters) or len(adapters) != 2 * 10 * VARIANT_MESH_DEPTH:
        raise AssertionError(f"(a) the trained state holds {len(adapters)} tensors, not the adapters alone")
    out = {"axes": axes, "s": wall, "steps": rec.steps, "rank": mc.lora_rank, "alpha": mc.lora_alpha, "counts": counts}
    del state
    if rank == 0:
        net = build_dit(mc.net, dev, seed=tc.seed, trainable=False)
        model = LoRAModelWrapper(Video2WorldModel(mc, net), rank=mc.lora_rank, alpha=mc.lora_alpha,
                                 targets=mc.lora_targets)
        model.init_lora(torch.Generator(dev).manual_seed(tc.seed + 2))
        ref = MeshStepRecord()
        trainer = Trainer(tc, model, callbacks=[ref])
        vae = build_vae(cfg.tokenizer, dev, seed=tc.seed + 1)
        trainer.train(trainer.init_state(), latent_batches(make_loader(cfg.data_train), vae, dev))
        log(f"  (a) LoRA rank {mc.lora_rank} alpha {mc.lora_alpha} on mesh {axes} (dp, fsdp, cp, tp), "
            f"{world} card(s), the full-width 2B at {VARIANT_MESH_DEPTH} blocks ({mc.net.remat} remat), "
            f"{frames} frames at {h}x{w}, a global batch of {dp * fsdp}: {LORA_MESH_STEPS} steps through launch "
            f"in {wall:.2f} s")
        out["reference"] = hold_steps("(a)", world, rec.steps, ref.steps)
        del net, model, trainer, vae
    dist.barrier()
    fresh_memory()
    # a block under block remat: self- and cross-attention forward, again in the recompute, and their backwards
    per = {"flash_attention_fwd": 4 * VARIANT_MESH_DEPTH, "flash_attention_bwd_dq": 2 * VARIANT_MESH_DEPTH,
           "flash_attention_bwd_dkv": 2 * VARIANT_MESH_DEPTH}
    check_step_counts("(a)", rec.steps, per)
    return out


def _wan_mesh_run(axes, dev, rank: int, world: int) -> dict:
    """(b): Wan2.1 1.3B i2v at full width (1,536 channels, 12 heads of 128)
    and VARIANT_MESH_DEPTH of its 30 layers, sharded by parallelize on
    ``axes`` (tp 2 on more than one card: 6 heads a rank, the whole-width
    q / k norms summing their squares over tp), WAN_MESH_STEPS trainer
    steps on WAN_MESH_CLIP clips through the Wan2.1 VAE (K2; each rank its
    rows of the global batch), seeded umT5 and CLIP tokens, frame 0
    conditional; rank 0 trains the same net unwrapped on the whole batch."""
    import torch
    import torch.distributed as dist

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.models.wan_video2world import WanModelConfig, WanVideo2WorldModel, make_i2v_condition
    from cosmos_predict2_tpu_torch.networks.wan_dit import WAN_PRESETS, WanModel, init_wan_weights
    from cosmos_predict2_tpu_torch.parallel.mesh import make_mesh, parallelize
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAEConfig, build_vae
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae_streaming import encode_streaming
    from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
    from cosmos_predict2_tpu_torch.training.trainer import Trainer, TrainerConfig

    dp, fsdp, cp, tp = axes
    count = dp * fsdp
    index = rank // (cp * tp)  # (dp, fsdp) major: this rank's row of the global batch
    cfg = dataclasses.replace(WAN_PRESETS["1.3B"], num_layers=VARIANT_MESH_DEPTH)
    frames, H, W = WAN_MESH_CLIP
    vae = build_vae(WanVAEConfig(), dev, seed=61)
    tc = TrainerConfig(max_iter=WAN_MESH_STEPS, logging_iter=1000, save_iter=0, seed=0, ema_enabled=True,
                       optimizer=OptimizerConfig(**MESH_OPT))

    def train(rows: slice, wrapped: bool) -> list:
        with torch.device("meta"):
            net = WanModel(cfg)
        net = init_wan_weights(net.to_empty(device=dev), torch.Generator(device=dev).manual_seed(60)).train()
        if wrapped:
            parallelize(net, make_mesh(*axes, device_type=dev.type))
        model = WanVideo2WorldModel(WanModelConfig(net=cfg), net)

        def batches():
            gen = torch.Generator(device=dev).manual_seed(62)
            for _ in range(WAN_MESH_STEPS):
                clip = torch.randint(0, 256, (count, frames, H, W, 3), generator=gen, device=dev, dtype=torch.uint8)
                text = torch.randn((count, 512, cfg.text_dim), generator=gen, device=dev)
                image = torch.randn((count, 257, cfg.clip_dim), generator=gen, device=dev)
                with torch.no_grad():
                    x0 = encode_streaming(vae, clip[rows], pixel_format="uint8").permute(0, 4, 1, 2, 3).float()
                yield x0, make_i2v_condition(text[rows], x0, image[rows])

        rec = MeshStepRecord()
        trainer = Trainer(tc, model, callbacks=[rec])
        trainer.train(trainer.init_state(), batches())
        del trainer, model, net
        return rec.steps

    t0 = time.perf_counter()
    steps = train(slice(index, index + 1), wrapped=True)
    torch.cuda.synchronize()
    out = {"axes": axes, "s": time.perf_counter() - t0, "steps": steps, "counts": _build.launch_counts()}
    if rank == 0:
        ref = train(slice(0, count), wrapped=False)
        tokens = (1 + (frames - 1) // 4) * (H // 16) * (W // 16)
        log(f"  (b) Wan2.1 1.3B i2v at {cfg.num_layers} of 30 layers on mesh {axes} (dp, fsdp, cp, tp), {world} "
            f"card(s), {cfg.num_heads // tp} of {cfg.num_heads} heads a rank, {frames} frames at {H}x{W} ({tokens:,} "
            f"tokens a sample), a global batch of {count}: {WAN_MESH_STEPS} steps in {out['s']:.2f} s")
        out["reference"] = hold_steps("(b)", world, steps, ref)
    dist.barrier()
    del vae
    fresh_memory()
    # a layer: self-, text cross- and CLIP cross-attention, no remat
    per = 3 * VARIANT_MESH_DEPTH
    check_step_counts("(b)", steps, {"flash_attention_fwd": per, "flash_attention_bwd_dq": per,
                                     "flash_attention_bwd_dkv": per})
    return out


def mv_view_segments(frames: int, views: int, cp: int, rank: int) -> int:
    """The view segments of a cp rank's slab of whole frames of the packed
    (V Tv) axis (networks/dit.py::Block._per_view_cross_attention): one
    K1 call for equal segments, one a segment else."""
    per_view, slab = frames // views, frames // cp
    lo, hi = rank * slab, (rank + 1) * slab
    lengths = [min(hi, (v + 1) * per_view) - max(lo, v * per_view) for v in range(views)]
    lengths = [n for n in lengths if n > 0]
    return 1 if len(set(lengths)) == 1 else len(lengths)


def _multiview_cp_run(cp: int, dev, rank: int, world: int) -> dict:
    """(c): the 7-view 2B at full width and VARIANT_MESH_DEPTH blocks, 7
    views x MV_CP_FRAMES frames at MV_CP_HW (28 latent frames), context
    parallel over cp (slabs of whole frames crossing views at cp 4; the cp
    group set even at cp 1): the serving forward (batch 2, as batched CFG)
    under Ulysses and ring, and a cross-view variant (each view attending
    its two rig neighbours), each against the same net unsharded; one
    MultiviewInference request of MV_CP_STEPS step (the VAE view by view,
    K2), rank 0 writing the grid video; one trainer step of each net
    wrapped (set_context_parallel and parallelize over (1, 1, cp, 1)),
    Ulysses then ring, held on rank 0 against the same step unwrapped."""
    import torch
    import torch.distributed as dist

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.conditioning.conditioner import make_condition
    from cosmos_predict2_tpu_torch.configs.defaults import make_config
    from cosmos_predict2_tpu_torch.inference.multiview import MultiviewInference, MultiviewInferenceArguments
    from cosmos_predict2_tpu_torch.models.multiview import MultiviewVid2VidModel
    from cosmos_predict2_tpu_torch.networks.dit import build_dit, build_serving_dit, set_context_parallel
    from cosmos_predict2_tpu_torch.parallel.mesh import make_mesh, parallelize
    from cosmos_predict2_tpu_torch.tokenizers.wan_vae import build_vae
    from cosmos_predict2_tpu_torch.training.optim import OptimizerConfig
    from cosmos_predict2_tpu_torch.training.trainer import Trainer, TrainerConfig

    base = make_config(MULTIVIEW_EXPERIMENT)
    V = base.model.net.n_views
    tv = 1 + (MV_CP_FRAMES - 1) // 4
    H, W = MV_CP_HW
    T = V * tv
    net_cfg = dataclasses.replace(base.model.net, num_blocks=VARIANT_MESH_DEPTH, remat="none")
    rig = tuple(((v - 1) % V, (v + 1) % V) for v in range(V))
    nets = {"views": net_cfg, "cross-view": dataclasses.replace(net_cfg, enable_cross_view_attn=True,
                                                                cross_view_attn_map=rig)}
    model_cfg = dataclasses.replace(base.model, state_t=T)
    mesh = make_mesh(1, 1, cp, 1, device_type=dev.type)
    group = mesh.get_group("cp")
    gen = torch.Generator(device=dev).manual_seed(71)
    text_dim = net_cfg.crossattn_proj_in_channels
    emb = (torch.randn((1, 512, text_dim), generator=gen, device=dev) * 0.05)
    x = torch.randn((2, 16, T, H // 8, W // 8), generator=gen, device=dev)
    ts = torch.tensor([700.0, 700.0], device=dev)
    ctx = emb.repeat(2, V, 1).to(torch.bfloat16)
    out = {"cp": cp, "tokens": T * (H // 16) * (W // 16), "forward": {}, "train": {}}
    segments = mv_view_segments(T, V, cp, rank % cp)
    serve_counts = {k: 0 for k in _build.launch_counts()}
    fresh_memory()

    def forward(net, name, strategy, want):
        set_context_parallel(net, None)
        with torch.no_grad():
            ref = net(x, ts, ctx)
        net.cfg = dataclasses.replace(net.cfg, cp_strategy=strategy)
        set_context_parallel(net, group)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            got = net(x, ts, ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _build.launch_counts()
        for k, v in counts.items():
            serve_counts[k] += v
        max_abs, rel = errors(got, ref)
        out["forward"][name] = {"max_abs": max_abs, "rel_l2": rel, "s": wall, "bit_equal": bool(torch.equal(got, ref)),
                                "counts": counts}
        if rank == 0:
            log(f"  (c) serving forward, {name} ({strategy}), cp={cp} vs unsharded: max_abs {max_abs:.3e} rel_l2 "
                f"{rel:.3e} (limit {KERNEL_REL_L2}){', bit-equal' if torch.equal(got, ref) else ''}; {wall:.3f} s; "
                f"launches {counts['flash_attention_fwd']} K1 (want {want})")
        if not (bool(torch.isfinite(got).all()) and rel <= KERNEL_REL_L2 and counts["flash_attention_fwd"] == want):
            raise AssertionError(f"(c) {name} {strategy}: rel_l2 {rel:.3e}, K1 {counts['flash_attention_fwd']} "
                                 f"(want {want})")

    # a block: self-attention (Ulysses: one K1; ring: one per ring step), the per-view cross-attention (one K1
    # for equal view segments of the slab, else one a segment) and, with it, cross-view attention (one a view)
    serving = build_serving_dit(nets["views"], dev, seed=0)
    forward(serving, "ulysses", "ulysses", (1 + segments) * VARIANT_MESH_DEPTH)
    forward(serving, "ring", "ring", (cp + segments) * VARIANT_MESH_DEPTH)
    cross = build_serving_dit(nets["cross-view"], dev, seed=0)
    forward(cross, "cross-view", "ulysses", (1 + segments + V) * VARIANT_MESH_DEPTH)
    del cross

    # one request through MultiviewInference with the cp group set (Ulysses); rank 0 writes the grid video
    serving.cfg = dataclasses.replace(serving.cfg, cp_strategy="ulysses")
    set_context_parallel(serving, group)
    vae = build_vae(base.tokenizer, dev, seed=1)
    pipe = MultiviewInference(MultiviewVid2VidModel(dataclasses.replace(model_cfg, net=serving.cfg), serving), vae,
                              text_encoder=lambda prompts: emb, height=H, width=W)
    videos = np.random.default_rng(72).integers(0, 256, (V, 5, H, W, 3), dtype=np.uint8)
    args = MultiviewInferenceArguments(prompt="a drive", inference_type="video2world", n_views=V,
                                       num_steps=MV_CP_STEPS, guidance=GUIDANCE)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    frames, grid = pipe.generate(args, videos)
    request_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    t0 = time.perf_counter()
    written = pipe.write(grid, str(OUT_DIR / "multiview_cp.gif"), fps=args.fps)
    write_s = time.perf_counter() - t0
    for k, v in counts.items():
        serve_counts[k] += v
    want = MV_CP_STEPS * (1 + segments) * VARIANT_MESH_DEPTH
    if (frames.shape != (V, MV_CP_FRAMES, H, W, 3) or frames.dtype != np.uint8 or frames[:, -1].std() == 0
            or counts["flash_attention_fwd"] != want or counts["conv3d_causal"] == 0
            or (written is not None) != (rank == 0) or (written is not None and not os.path.isfile(written))):
        raise AssertionError(f"(c) the request: frames {frames.shape} {frames.dtype}, launches {counts} (K1 want "
                             f"{want}), written {written}")
    out["request"] = {"s": request_s, "write_s": write_s, "counts": counts, "grid": list(grid.shape)}
    if rank == 0:
        log(f"  (c) MultiviewInference request at cp={cp} (Ulysses): {V} views x {MV_CP_FRAMES} frames at {H}x{W}, "
            f"{MV_CP_STEPS} step, {request_s:.2f} s (denoise {pipe.last_timings['denoise_s']:.3f} s); rank 0 wrote "
            f"{written} ({write_s:.2f} s); launches K1 {counts['flash_attention_fwd']} (want {want}), K2 "
            f"{counts['conv3d_causal']}")
    del pipe, vae, serving, frames, grid
    fresh_memory()

    # training: one step of each net wrapped (Ulysses, then for the views net ring), rank 0 the same unwrapped
    tc = TrainerConfig(max_iter=2, logging_iter=1000, save_iter=0, seed=0, ema_enabled=True,
                       optimizer=OptimizerConfig(**MESH_OPT))
    x0 = torch.randn((1, 16, T, H // 8, W // 8), generator=gen, device=dev)

    def train(cfg, wrapped: bool, strategies: list) -> list:
        net = build_dit(cfg, dev, seed=0, trainable=True)
        if wrapped:
            set_context_parallel(net, group)
            parallelize(net, mesh)
        model = MultiviewVid2VidModel(dataclasses.replace(model_cfg, net=cfg), net)
        cond = model.set_multiview_condition(make_condition(emb.repeat(1, V, 1)), x0, 1)
        rec = MeshStepRecord()
        trainer = Trainer(dataclasses.replace(tc, max_iter=len(strategies)), model, callbacks=[rec])
        state = trainer.init_state()
        for i, strategy in enumerate(strategies):
            net.cfg = dataclasses.replace(net.cfg, cp_strategy=strategy)
            state = trainer.train(state, [(x0, cond)], start_iteration=i)
        del trainer, state, model, net
        fresh_memory()
        return rec.steps

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    steps = {"views": train(nets["views"], True, ["ulysses", "ring"]), "cross-view": train(nets["cross-view"], True,
                                                                                           ["ulysses"])}
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["train_counts"] = _build.launch_counts()
    out["serve_counts"] = serve_counts
    if rank == 0:
        log(f"  (c) training at cp={cp} (parallelize over (1, 1, {cp}, 1)), {out['tokens']:,} tokens: the views net "
            f"a Ulysses and a ring step, the cross-view net a Ulysses step, {out['train_s']:.2f} s")
        for name, strategies in (("views", ["ulysses", "ring"]), ("cross-view", ["ulysses"])):
            out["train"][name] = hold_steps(f"(c) {name}", world, steps[name], train(nets[name], False, strategies))
    dist.barrier()
    per = {"ulysses": 1 + segments, "ring": cp + segments}
    for name, step, strategy in (("views", 0, "ulysses"), ("views", 1, "ring"), ("cross-view", 0, "ulysses")):
        n = (per[strategy] + (V if name == "cross-view" else 0)) * VARIANT_MESH_DEPTH
        check_step_counts(f"(c) {name} {strategy}", steps[name][step:step + 1],
                          {"flash_attention_fwd": n, "flash_attention_bwd_dq": n, "flash_attention_bwd_dkv": n})
    return out


def mesh_variants_entry(world: int, device: str = "cuda") -> dict:
    """Phase 22 on every rank of a NCCL group of ``world`` cards (a world
    size entry, as phases 20(a) and 21(a)): (a) LoRA on the meshes of
    :func:`variant_axes`, (b) the Wan DiT under tp, (c) the multiview net
    under cp; launches per path from the wrapped runs, each counted from 0
    just before it."""
    import torch

    from cosmos_predict2_tpu_torch import _build
    from cosmos_predict2_tpu_torch.parallel.launch import init_distributed, world_info

    info = init_distributed(device=device)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    rank, axes = info["process_index"], variant_axes(world)
    out = {"world": world_info(), "axes": axes, "paths": {}}
    runs, lora_counts, t0 = [], None, time.perf_counter()
    for mesh_axes_ in axes["lora"]:
        _build.reset_launch_counts()
        runs.append(_mesh_lora_run(mesh_axes_, dev, rank, world))
        counts = runs[-1].pop("counts")
        lora_counts = counts if lora_counts is None else {k: lora_counts[k] + v for k, v in counts.items()}
    out["paths"]["mesh_lora"] = {"counts": lora_counts, "s": time.perf_counter() - t0, "runs": runs}
    _build.reset_launch_counts()
    wan = _wan_mesh_run(axes["wan"], dev, rank, world)
    out["paths"]["wan_tp"] = {"counts": wan.pop("counts"), **wan}
    mv = _multiview_cp_run(axes["cp"], dev, rank, world)
    out["paths"]["multiview_cp"] = {"counts": mv.pop("serve_counts"), "s": mv["request"]["s"],
                                    "forward": mv["forward"], "request": mv["request"], "cp": mv["cp"]}
    out["paths"]["multiview_cp_train"] = {"counts": mv.pop("train_counts"), "s": mv["train_s"], "train": mv["train"],
                                          "cp": mv["cp"]}
    return out


def mesh_variants_slice() -> dict:
    """Phase 22: the last mesh gaps at the machine's world size."""
    return world_slice("mesh_variants_entry")


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)  # --help; no options
    t_start = time.perf_counter()

    with Phase("environment"):
        smi = environment()
    import torch

    # the plain references compute in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cosmos_predict2_tpu_torch import _build

    with Phase("build"):
        t = time.perf_counter()
        _build.library()
        log(f"  kernels built and loaded in {time.perf_counter() - t:.2f} s: {_build.library_path()}")
        kernel_resources()
    results: dict = {}
    with Phase("kernels vs plain versions"):
        check_kernels(results)
    with Phase("forward mode: flash_attention_fwdmode under torch.func.jvp and forward_ad (K1 + K9)"):
        fm = fwdmode_slice()
    with Phase("forward mode: scripts/fa_jvp.py at B1 S8320 H16"):
        fj = fa_jvp_slice()
    with Phase("small reference: card bf16 vs cpu fp32, dense and sparse, and the dmd2 sampler"):
        small_reference(sparse=False)
        small_reference(sparse=True)
        small_reference(sparse=False, sampler="dmd2")
    with Phase("serving slice: text2world, image2world, video2world"):
        sl = serve_slice(DENSE_EXPERIMENT, ("text2world", "image2world", "video2world"))
    log(f"  served 3 requests in {sl['serve_s']:.2f} s; peak device memory {sl['peak_gb']:.2f} GiB")
    with Phase("sparse serving slice: video2world on the sparse 2B DiT"):
        ssl = serve_slice(SPARSE_EXPERIMENT, ("video2world",))
    log(f"  served 1 request in {ssl['serve_s']:.2f} s; peak device memory {ssl['peak_gb']:.2f} GiB")
    with Phase("dmd2 serving slice: one 4-step request through Inference on the 2B student"):
        dsl = dmd2_serve_slice()
    log(f"  served 1 dmd2 request in {dsl['request_s']:.2f} s; peak device memory {dsl['peak_gb']:.2f} GiB")
    with Phase("small training reference: card bf16 vs cpu fp32, dense and sparse, and a DMD2 student and critic step"):
        small_train_reference(sparse=False)
        small_train_reference(sparse=True)
        small_distill_reference()
    with Phase("training slice: 2B DiT through training/train.py launch"):
        tr = train_slice(DENSE_EXPERIMENT, TRAIN_TIMED_STEPS)
    with Phase("sparse training slice: sparse 2B DiT through training/train.py launch"):
        stl = train_slice(SPARSE_EXPERIMENT, SPARSE_TRAIN_TIMED_STEPS)
    with Phase("distillation slice: DMD2 on the 2B student, teacher and fake-score nets"):
        dtl = distill_slice()
    with Phase("small interactive reference: card bf16 vs cpu fp32, K5 and K6"):
        small_stream_reference()
    with Phase("interactive slice: causal 2B DiT streaming at 352x640, dense cache (K5)"):
        it = interactive_slice(-1, run_measure=True)
    with Phase(f"interactive slice: causal 2B DiT streaming at 352x640, {INTERACTIVE_WINDOW}-row window (K6)"):
        itw = interactive_slice(INTERACTIVE_WINDOW, run_measure=False)
    with Phase("released weights: a synthetic 2B checkpoint by DB name, the loader and the verifier"):
        rel = released_slice()
    log(f"  write {rel['write_s']:.1f} s, load {rel['load_s']:.2f} s (peak {rel['load_peak_gb']:.2f} GiB), verifier "
        f"twice {rel['verify_s']:.1f} s, PSNR {rel['psnr_db']} dB")
    fresh_memory()
    pipe, cfg = _serving_pipe()
    with Phase(f"autoregressive: {AR_FRAMES} frames in chunks of {AR_CHUNK} through Inference"):
        ar = autoregressive_slice(pipe, cfg)
    with Phase("text2image: one 1280x720 image through Inference"):
        t2i = text2image_slice(pipe, cfg)
    with Phase("one-shot VAE: against the streaming route, then text2world on the one-shot route"):
        osl = oneshot_slice(pipe, cfg)
    with Phase("serving front end with guardrails: ModelServer over HTTP, Qwen3Guard-0.6B, SigLIP so400m + safety "
               "head, RetinaFace-ResNet50"):
        sgd = guardrails_serving_slice(pipe, cfg, smi)
    del pipe
    with Phase("14B: text2world on predict2_video2world_14b_rectified_flow"):
        big = fourteen_b_slice()
    with Phase("post-training: LoRA at 704x1280, full fine-tune rows at 192x320, small references"):
        post = posttrain_slice()
    log(f"  beside phase 7 (block remat, fp32 moments, mock data): step {tr['step_s']:.3f} s, peak "
        f"{tr['peak_gb']:.2f} GiB")
    with Phase("15b, post-training from remote shards: the full fine-tune on tar shards from a fake S3 store through "
               "the spool, profiled and timed; WanVAEInterface; golden activation dumps"):
        rsh = remote_shards_slice()
    with Phase("post-trained variants: 7-view multiview at 704x1280, camera-conditioned, action-conditioned"):
        var = variants_slice()
    with Phase("A13 and A12.2: the gr00t action stream, Wan 1.3B i2v, the Wan2.2 VAE, EDM, the 14B sparse pair"):
        a13 = a13_slice()
    with Phase("A15, the prompt encoders: Reason1 7B through the CLI and a request, umT5 + CLIP into Wan i2v, "
               "T5-11B, Qwen vision, SigLIP, XLM-R"):
        a15 = prompt_encoders_slice()
    with Phase("self-forcing DMD2 of the causal 2B, Wan 1.3B and EDM 2B training, narrow steps card vs CPU"):
        p19 = training_variants_slice()
    with Phase("20, context parallelism: the 2B at 720p through Ulysses and ring, the sparse NA block and the 720p "
               "stream on NCCL ranks; the cp=4 rank programs"):
        p20 = context_parallel_slice(smi)
    with Phase("21, the training mesh: the 2B through parallelize and the trainer at the machine's world size, a DCP "
               "save and resume, a ring step; the ring backward's cp=4 rank programs"):
        p21 = training_mesh_slice(smi)
    with Phase("22, the last mesh gaps: LoRA through launch on a mesh, the Wan DiT under tensor parallelism, the "
               "7-view net under context parallelism (serving forward, a request, training steps)"):
        p22 = mesh_variants_slice()
    log(f"  phases 1-22 took {time.perf_counter() - t_start:.1f} s")
    paths = {"serve": sl, "train": tr, "sparse_serve": ssl, "sparse_train": stl, "interactive": it,
             "interactive_window": itw, "fwdmode": fm, "fa_jvp": fj, "dmd2_serve": dsl, "distill": dtl,
             "released": rel, "autoregressive": ar, "text2image": t2i, "oneshot": osl, "serving_guardrails": sgd,
             "14b": big,
             "posttrain_lora": post["lora"], "posttrain_full": post["rows"], "remote_shards": rsh,
             "multiview": var["multiview"],
             "camera": var["camera"], "action": var["action"], "gr00t": a13["gr00t"], "wan": a13["wan"],
             "wan22_vae": a13["wan22_vae"], "edm": a13["edm"],
             **{name: a13["sparse_14b"][name] for name in SPARSE_14B_EXPERIMENTS},
             "reason1": a15["reason1"], "wan_encoders": a15["wan_encoders"],
             "self_forcing": p19["self_forcing"], "wan_train": p19["wan_train"], "edm_train": p19["edm_train"],
             **p20["paths"], **p21["paths"], **p22["paths"]}
    path_kernels = {
        "serve": ("flash_attention_fwd", "conv3d_causal"),
        "train": ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "conv3d_causal"),
        "sparse_serve": ("flash_attention_fwd", "na_fwd", "conv3d_causal"),
        "sparse_train": ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "na_fwd",
                         "na_bwd_dq", "na_bwd_dkv", "conv3d_causal"),
        "interactive": ("flash_attention_fwd", "flash_attention_kv_cache"),
        "interactive_window": ("flash_attention_fwd", "flash_attention_kv_cache_window"),
        "fwdmode": ("flash_attention_fwd", "flash_attention_jvp"),
        "fa_jvp": ("flash_attention_fwd", "flash_attention_jvp"),
        "dmd2_serve": ("flash_attention_fwd", "conv3d_causal"),
        "distill": ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "conv3d_causal"),
        **{path: ("flash_attention_fwd", "conv3d_causal")
           for path in ("released", "autoregressive", "text2image", "oneshot", "serving_guardrails", "14b", "multiview",
                        "camera", "action", "wan", "edm", "reason1", "wan_encoders")},
        "gr00t": ("flash_attention_fwd", "flash_attention_kv_cache"),
        "self_forcing": ("flash_attention_fwd", "flash_attention_kv_cache", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"),
        **{path: ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "conv3d_causal")
           for path in ("wan_train", "edm_train")},
        "wan22_vae": ("conv3d_causal",),
        **{name: ("flash_attention_fwd", "na_fwd") for name in SPARSE_14B_EXPERIMENTS},
        "cp_ulysses": ("flash_attention_fwd",), "cp_ring": ("flash_attention_fwd",),
        "cp_sparse": ("flash_attention_fwd", "na_fwd"), "cp_stream": ("flash_attention_fwd", "flash_attention_kv_cache"),
        "cp_stream_window": ("flash_attention_fwd", "flash_attention_kv_cache_window"),
        "mesh_train": ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "conv3d_causal"),
        "mesh_ring_train": ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
        **{path: ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "conv3d_causal")
           for path in ("posttrain_lora", "posttrain_full", "remote_shards", "mesh_lora", "wan_tp")},
        "multiview_cp": ("flash_attention_fwd", "conv3d_causal"),
        "multiview_cp_train": ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
    }
    for path, names in path_kernels.items():
        idle = [n for n in names if paths[path]["counts"][n] == 0]
        if idle:
            raise AssertionError(f"the {path} path never launched {idle}")
    reference = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "cosmos_predict2_tpu"))
    if reference:
        raise AssertionError(f"the port's paths imported JAX or the JAX package: {reference}")

    # the main-shape cases whose times go into the JSON line; launches are
    # the sparse training slice's (it runs the seven earlier kernels) and,
    # for K5 and K6, the interactive slices', with each path's counts beside them
    na_smoke = next(c["case"] for c in results["na_fwd"]["cases"] if c["case"].startswith("smoke"))
    main_case = {
        "flash_attention_fwd": "self  B2 S5760 H16 (smoke geometry)",
        "flash_attention_bwd_dq": "self  B1 S5760 H16 (smoke geometry)",
        "flash_attention_bwd_dkv": "self  B1 S5760 H16 (smoke geometry)",
        "conv3d_causal": "dec T8 192x320 96->96 (smoke)",
        "na_fwd": na_smoke,
        "na_bwd_dq": na_smoke,
        "na_bwd_dkv": na_smoke,
        "flash_attention_kv_cache": next(c["case"] for c in results["flash_attention_kv_cache"]["cases"]
                                         if c["case"].startswith("352x640 steady")),
        "flash_attention_kv_cache_window": next(c["case"] for c in results["flash_attention_kv_cache_window"]["cases"]
                                                if c["case"].startswith("352x640 steady")),
        "flash_attention_jvp": "B1 S8320 H16 (fa_jvp shape)",
    }
    source = {
        "flash_attention_fwd": ("cosmos_predict2_tpu_torch/csrc/flash_attention_fwd.cu",
                                "cosmos_predict2_tpu/ops/flash_attention.py:91"),
        "flash_attention_bwd_dq": ("cosmos_predict2_tpu_torch/csrc/flash_attention_bwd.cu",
                                   "cosmos_predict2_tpu/ops/flash_attention.py:586"),
        "flash_attention_bwd_dkv": ("cosmos_predict2_tpu_torch/csrc/flash_attention_bwd.cu",
                                    "cosmos_predict2_tpu/ops/flash_attention.py:632"),
        "conv3d_causal": ("cosmos_predict2_tpu_torch/csrc/conv3d_causal.cu", "cosmos_predict2_tpu/ops/conv3d.py:284"),
        "na_fwd": ("cosmos_predict2_tpu_torch/csrc/neighborhood_attention.cu",
                   "cosmos_predict2_tpu/ops/neighborhood_attention.py:377"),
        "na_bwd_dq": ("cosmos_predict2_tpu_torch/csrc/neighborhood_attention.cu",
                      "cosmos_predict2_tpu/ops/neighborhood_attention.py:425"),
        "na_bwd_dkv": ("cosmos_predict2_tpu_torch/csrc/neighborhood_attention.cu",
                       "cosmos_predict2_tpu/ops/neighborhood_attention.py:461"),
        "flash_attention_kv_cache": ("cosmos_predict2_tpu_torch/csrc/flash_attention_fwd.cu",
                                     "cosmos_predict2_tpu/ops/flash_attention.py:211"),
        "flash_attention_kv_cache_window": ("cosmos_predict2_tpu_torch/csrc/flash_attention_fwd.cu",
                                            "cosmos_predict2_tpu/ops/flash_attention.py:375"),
        "flash_attention_jvp": ("cosmos_predict2_tpu_torch/csrc/flash_attention_jvp.cu",
                                "cosmos_predict2_tpu/ops/flash_attention_jvp.py:45"),
    }
    launch_path = {"flash_attention_kv_cache": it, "flash_attention_kv_cache_window": itw, "flash_attention_jvp": fj}
    kernels = []
    for name, (src, replaces) in source.items():
        case = next(c for c in results[name]["cases"] if c["case"] == main_case[name])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launch_path.get(name, stl)["counts"][name],
            "launches_by_path": {path: out["counts"][name] for path, out in paths.items()},
            "max_abs_err": results[name]["max_abs_err"], "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            # a yardstick that could not run gives null and its reason
            "library_ms": case["library_ms"] if isinstance(case["library_ms"], float) else None,
            **({} if isinstance(case["library_ms"], float) else {"library_note": case["library_ms"]}),
            **({"library_backend": case["library_backend"]} if "library_backend" in case else {}),
        })
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
