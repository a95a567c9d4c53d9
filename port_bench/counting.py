"""What the work is, counted from shapes: operations, bytes and the chip's peaks.

Every count is of the work these inputs need, whatever implements it: a
multiply-add is 2 operations, a byte of an input is read once and a byte of
an output written once, and a masked attention counts the (query, key)
pairs that its mask lets through, not the pairs a kernel happens to compute.

Notation: B batch, S = T' H' W' patch tokens a sample, D channels, h heads
of d = D / h, M caption tokens of D' channels from Din text channels,
F = mlp_ratio D, L the AdaLN-LoRA width, P = C pt ps^2 patch inputs, O =
ps^2 pt C_out patch outputs.

One DiT block (per sample):

* self-attention projections q, k, v, o: 4 x 2 S D^2;
* cross-attention q and o over the tokens, 2 x 2 S D^2, and k and v over
  the caption, 2 x 2 M D' D;
* MLP: 2 x 2 S D F;
* self-attention: q k^T and p v, 2 x 2 d per pair and head, so 4 D x pairs
  (pairs = S^2 dense; for a neighbourhood block S x the window's keys a
  query, the window clamped inside each axis so every query has the same
  count);
* cross-attention: 4 D S M;
* AdaLN: three modulations of T' frames, 2 T' (D L + L 3D) each.

Around the blocks: the patch embedding 2 S P D, the caption projection
2 M Din D' (100,352 -> 1,024 over 512 tokens: 1.05e11), the timestep
embedding 2 (D^2 + 3 D^2) a frame row, the final layer 2 S D O plus its
AdaLN 2 T' (D L + 2 L D).

At 720p (S = 84,480, D = 2,048, F = 8,192, M = 512) the 28 dense blocks are
1.9249e15 operations a sample; a batched-CFG step is twice one sample.

Attention kernels, per call (B, h, Sq, Skv, d; bf16 tensors of 2 bytes, the
log-sum-exp fp32):

* forward (K1, and K10 with pairs for Sq Skv): 4 B h d pairs operations;
  reads q, k, v, writes o and the log-sum-exp;
* backward (K7 + K8): the four products dV = P^T dO, dP = dO V^T,
  dQ = dS K, dK = dS^T Q and one recompute of the logits q k^T, 10 B h d
  pairs operations; reads q, k, v, o, dO and the log-sum-exp, writes dq,
  dk, dv.
"""

from __future__ import annotations

import math

# one NVIDIA H100 SXM at its 700 W limit (the data sheet: dense bf16, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def na_keys_per_query(grid: tuple[int, int, int], window: tuple[int, int, int]) -> int:
    return math.prod(min(w, n) if w > 0 else n for w, n in zip(window, grid))


def self_attention_pairs(cfg: dict, grid: tuple[int, int, int], block: int) -> int:
    """(query, key) pairs one sample's self-attention of ``block`` needs."""
    from port_bench.reference import dense_blocks, na_window

    S = math.prod(grid)
    if block in dense_blocks(cfg):
        return S * S
    return S * na_keys_per_query(grid, na_window(cfg, grid)[0])


def dit_block_flops(cfg: dict, grid: tuple[int, int, int], block: int) -> float:
    """One block, one sample."""
    S, D = math.prod(grid), cfg["model_channels"]
    M, Dc, L = cfg["text_tokens"], cfg["crossattn_emb_channels"], cfg["adaln_lora_dim"]
    F = int(D * cfg["mlp_ratio"])
    linear = 8 * S * D * D + 4 * S * D * D + 4 * M * Dc * D + 4 * S * D * F
    attention = 4 * D * self_attention_pairs(cfg, grid, block) + 4 * D * S * M
    adaln = 3 * 2 * grid[0] * (D * L + L * 3 * D)
    return float(linear + attention + adaln)


def dit_forward_flops(cfg: dict, batch: int, grid: tuple[int, int, int]) -> float:
    """One DiT forward of ``batch`` samples, everything counted."""
    from port_bench.weights import in_channels

    S, D = math.prod(grid), cfg["model_channels"]
    L, T = cfg["adaln_lora_dim"], grid[0]
    P = in_channels(cfg) * cfg["patch_temporal"] * cfg["patch_spatial"] ** 2
    O = cfg["patch_spatial"] ** 2 * cfg["patch_temporal"] * cfg["out_channels"]
    blocks = sum(dit_block_flops(cfg, grid, i) for i in range(cfg["num_blocks"]))
    caption = 2 * cfg["text_tokens"] * cfg["crossattn_proj_in_channels"] * cfg["crossattn_emb_channels"]
    around = 2 * S * P * D + caption + 2 * (D * D + 3 * D * D) + 2 * S * D * O + 2 * T * (D * L + 2 * L * D)
    return batch * (blocks + around)


def dit_attention_calls(cfg: dict, batch: int, grid: tuple[int, int, int]) -> list[dict]:
    """The attention kernel calls of one DiT forward of ``batch`` samples:
    ``kernel`` ("k1" dense, "k10" neighbourhood), shapes, visible pairs a
    (sample, head) and ``count`` calls."""
    from port_bench.reference import dense_blocks

    S, h, d = math.prod(grid), cfg["num_heads"], cfg["head_dim"]
    n_dense = len(dense_blocks(cfg))
    n_sparse = cfg["num_blocks"] - n_dense
    shape = dict(B=batch, H=h, D=d, Sq=S)
    calls = [dict(shape, kernel="k1", Skv=S, pairs=S * S, count=n_dense),
             dict(shape, kernel="k1", Skv=cfg["text_tokens"], pairs=S * cfg["text_tokens"], count=cfg["num_blocks"])]
    if n_sparse:
        first_sparse = next(i for i in range(cfg["num_blocks"]) if i not in dense_blocks(cfg))
        calls.append(dict(shape, kernel="k10", Skv=S, pairs=self_attention_pairs(cfg, grid, first_sparse),
                          count=n_sparse))
    return [c for c in calls if c["count"]]


def attention_forward_cost(B: int, H: int, Sq: int, Skv: int, D: int, pairs: int) -> tuple[float, float]:
    """(operations, bytes) of one forward call."""
    flops = 4.0 * B * H * D * pairs
    nbytes = 2.0 * B * H * D * (2 * Sq + 2 * Skv) + 4.0 * B * H * Sq
    return flops, nbytes


def attention_backward_cost(B: int, H: int, Sq: int, Skv: int, D: int, pairs: int) -> tuple[float, float]:
    """(operations, bytes) of one backward call (K7 + K8 together)."""
    flops = 10.0 * B * H * D * pairs
    nbytes = 2.0 * B * H * D * (4 * Sq + 4 * Skv) + 4.0 * B * H * Sq
    return flops, nbytes


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def calls_bound_seconds(calls: list[dict], kernel: str, backward: bool = False) -> float:
    """The summed bound of the listed calls of ``kernel``."""
    cost = attention_backward_cost if backward else attention_forward_cost
    return sum(c["count"] * bound_seconds(*cost(c["B"], c["H"], c["Sq"], c["Skv"], c["D"], c["pairs"]))
               for c in calls if c["kernel"] == kernel)
