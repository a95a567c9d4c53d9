"""The operation and byte counts against figures worked by hand."""

from __future__ import annotations

import json
import math

import pytest

from conftest import REPO
from port_bench import counting as C

GRID = (24, 44, 80)  # 93 x 704 x 1280: 24 latent frames of 88 x 160, 2 x 2 patches


def config(name: str) -> dict:
    return json.loads((REPO / "port_bench" / "configs" / f"{name}.json").read_text())


def test_dense_720p_forward():
    cfg = config("cosmos-predict2.5-2b")
    S, D = 84_480, 2048
    assert math.prod(GRID) == S
    blocks = sum(C.dit_block_flops(cfg, GRID, i) for i in range(28))
    assert blocks == pytest.approx(1.9249e15, rel=1e-4)
    # by hand: 28 S D^2 of products, 4 S^2 D of self-attention, 4 S M D of cross-attention a block
    assert blocks == pytest.approx(28 * (28 * S * D * D + 4 * S * S * D + 4 * S * 512 * D), rel=1e-3)
    caption = 2 * 512 * 100_352 * 1024
    assert caption == pytest.approx(1.05e11, rel=3e-3)
    one = C.dit_forward_flops(cfg, 1, GRID)
    assert one - blocks > caption  # the patch embed, AdaLN and final layer come on top
    assert one - blocks - caption < 1e-3 * blocks
    assert C.dit_forward_flops(cfg, 2, GRID) == pytest.approx(3.85e15, rel=1e-3)  # a batched-CFG step


def test_sparse_720p_pairs():
    cfg = config("cosmos-predict2.5-2b-sparse")
    from port_bench.reference import dense_blocks, na_window

    assert dense_blocks(cfg) == {0, 4, 9, 13, 18, 22, 27}
    assert na_window(cfg, GRID) == ((24, 12, 24), (1, 4, 8))
    sparse = [i for i in range(28) if i not in dense_blocks(cfg)]
    assert C.self_attention_pairs(cfg, GRID, sparse[0]) == 583_925_760  # visible; the kernel computes 1,012,137,984
    assert C.self_attention_pairs(cfg, GRID, 0) == 84_480**2
    calls = C.dit_attention_calls(cfg, 2, GRID)
    assert {(c["kernel"], c["Skv"], c["count"]) for c in calls} == {("k1", 84_480, 7), ("k1", 512, 28),
                                                                     ("k10", 84_480, 21)}
    assert C.dit_forward_flops(cfg, 2, GRID) == pytest.approx(1.59e15, rel=2e-2)


def test_attention_costs():
    flops, nbytes = C.attention_forward_cost(2, 16, 84_480, 84_480, 128, 84_480**2)
    assert flops == 4 * 2 * 16 * 84_480**2 * 128
    assert nbytes == 4 * 2 * 84_480 * 2048 * 2 + 2 * 16 * 84_480 * 4  # q, k, v, o in bf16, lse in fp32
    assert C.bound_seconds(flops, nbytes) == pytest.approx(flops / 989e12)  # compute-bound: 118.2 ms
    assert C.bound_seconds(flops, nbytes) * 1e3 == pytest.approx(118.2, rel=1e-3)
    bflops, bbytes = C.attention_backward_cost(1, 16, 31_104, 31_104, 128, 31_104**2)
    assert bflops == 10 * 16 * 31_104**2 * 128  # four products and one recompute of the logits
    assert bbytes == 8 * 31_104 * 2048 * 2 + 16 * 31_104 * 4
