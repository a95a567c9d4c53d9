"""The DiT's remat policies in the port: gradients and attention launches.

"none", "block", "selective", "mixed:1" and "mixed" give the same
gradients (atol/rtol 1e-5, as the JAX package's tests/test_remat.py), and
"selective" gives JAX's selective gradients on the same weights. The
attention forwards one step makes follow the launch table of the remat
(per block two attention calls; "block" computes each again in the
backward, "selective" keeps its result, "mixed:K" keeps it on the first K
blocks): counted here on the plain versions the CPU takes in the kernels'
place, forward and backward, dense and with a sparse block.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.networks.dit import PRESETS
from cosmos_predict2_tpu.networks.dit import MiniTrainDIT as JDiT
from cosmos_predict2_tpu.utils.checkpoint_convert import convert_dit_state_dict
from cosmos_predict2_tpu_torch.networks.dit import DiTConfig, MiniTrainDIT, build_dit
from cosmos_predict2_tpu_torch.ops import flash_attention as fa
from cosmos_predict2_tpu_torch.ops import neighborhood_attention as na
from cosmos_predict2_tpu_torch.utils.convert import jax_dit_params_to_torch

MODES = ("none", "block", "selective", "mixed:1", "mixed")
NUM_BLOCKS = 4
SPARSE = dict(n_dense_blocks=1, natten_window=(-1, 3, 3), natten_stride=(1, 1, 1))


def configs(**over):
    jcfg = dataclasses.replace(PRESETS["test"], dtype=jnp.float32, model_channels=64, num_heads=2,
                               num_blocks=NUM_BLOCKS, adaln_lora_dim=8, **over)
    names = {f.name for f in dataclasses.fields(DiTConfig)} - {"dtype"}
    return jcfg, DiTConfig(dtype=torch.float32, **{n: getattr(jcfg, n) for n in names})


def inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 16, 2, 8, 8)).astype(np.float32)
    ts = np.full((1,), 500.0, np.float32)
    ctx = (0.05 * rng.standard_normal((1, 8, 1024))).astype(np.float32)
    return x, ts, ctx


@pytest.fixture(scope="module")
def weights():
    """The port's seeded random weights (every Linear drawn, AdaLN included,
    so every path counts) as a state dict and as the JAX tree."""
    _, tcfg = configs()
    sd = build_dit(tcfg, "cpu", seed=2).state_dict()
    return sd, convert_dit_state_dict({k: v.numpy() for k, v in sd.items()}, tcfg.num_blocks)


class Calls:
    """Counts the calls of module-level functions while the test runs."""

    def __init__(self, monkeypatch, module, names):
        self.counts = dict.fromkeys(names, 0)
        for name in names:
            fn = getattr(module, name)

            def counted(*args, _fn=fn, _name=name, **kwargs):
                self.counts[_name] += 1
                return _fn(*args, **kwargs)

            monkeypatch.setattr(module, name, counted)


def port_grads(tcfg, sd, remat: str):
    net = MiniTrainDIT(dataclasses.replace(tcfg, remat=remat))
    net.load_state_dict(sd, strict=True)
    x, ts, ctx = map(torch.from_numpy, inputs())
    net(x, ts, ctx).square().mean().backward()
    return {n: p.grad for n, p in net.named_parameters()}


def test_remat_policies_give_equal_gradients_and_jax_selective(weights):
    jcfg, tcfg = configs()
    sd, params = weights
    grads = {mode: port_grads(tcfg, sd, mode) for mode in MODES}
    for mode in MODES[1:]:
        for n, g in grads["none"].items():
            torch.testing.assert_close(grads[mode][n], g, atol=1e-5, rtol=1e-5, msg=f"{mode} {n}")

    net = JDiT(dataclasses.replace(jcfg, remat="selective"))
    x, ts, ctx = inputs()
    jgrads = jax.jit(jax.grad(lambda p: jnp.mean(jnp.square(net.apply(p, x, ts, ctx)))))(params)
    want = jax_dit_params_to_torch(jax.tree.map(np.asarray, jgrads), tcfg)
    for n, w in want.items():
        np.testing.assert_allclose(grads["selective"][n].numpy(), w.numpy(), atol=1e-5, rtol=1e-5, err_msg=n)


@pytest.mark.parametrize("mode,selective", [("none", None), ("block", 0), ("selective", NUM_BLOCKS), ("mixed:1", 1),
                                            ("mixed:3", 3), ("mixed", NUM_BLOCKS // 2)])
def test_attention_forwards_per_step_follow_the_launch_table(mode, selective, monkeypatch):
    """Dense: 2 n forwards with "none" or "selective", 4 n - 2 K with
    "mixed:K" (K = n // 2 for "mixed", 0 for "block"); 2 n backwards."""
    _, tcfg = configs(remat=mode)
    calls = Calls(monkeypatch, fa, ("flash_attention_plain", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"))
    assert tcfg.selective_blocks == (selective or 0)
    net = MiniTrainDIT(tcfg)
    x, ts, ctx = map(torch.from_numpy, inputs())
    net(x, ts, ctx).square().mean().backward()
    n = NUM_BLOCKS
    fwd = 2 * n if mode == "none" else 4 * n - 2 * selective
    assert calls.counts == {"flash_attention_plain": fwd, "flash_attention_bwd_dq": 2 * n,
                            "flash_attention_bwd_dkv": 2 * n}
    calls.counts = dict.fromkeys(calls.counts, 0)
    with torch.no_grad():
        net(x, ts, ctx)  # no gradient recorded: no checkpoint, one forward per call
    assert calls.counts["flash_attention_plain"] == 2 * n


@pytest.mark.parametrize("mode", ["block", "selective"])
def test_selective_keeps_the_neighborhood_attention_forward(mode, monkeypatch):
    """With a sparse block (3 of 4 blocks neighborhood attention), selective
    remat keeps the K10 results as it keeps K1's."""
    _, tcfg = configs(remat=mode, **SPARSE)
    dense = Calls(monkeypatch, fa, ("flash_attention_plain",))
    sparse = Calls(monkeypatch, na, ("na_fwd", "na_bwd_dq", "na_bwd_dkv"))
    net = MiniTrainDIT(tcfg)
    x, ts, ctx = map(torch.from_numpy, inputs())
    net(x, ts, ctx).square().mean().backward()
    twice = 2 if mode == "block" else 1
    assert dense.counts["flash_attention_plain"] == twice * (NUM_BLOCKS + 1)  # 4 cross + 1 dense self
    assert sparse.counts == {"na_fwd": twice * 3, "na_bwd_dq": 3, "na_bwd_dkv": 3}


def test_unknown_remat_raises():
    for bad in ("selective:2", "mixed:x", "full"):
        with pytest.raises(ValueError, match="remat"):
            DiTConfig(remat=bad)


def test_selective_block_refuses_a_second_backward():
    """The kept results are handed back once: a second backward through a
    selective block raises, as PyTorch's own selective checkpointing does,
    instead of replaying a result twice."""
    _, tcfg = configs(remat="selective")
    net = MiniTrainDIT(tcfg)
    x, ts, ctx = map(torch.from_numpy, inputs())
    loss = net(x, ts, ctx).square().mean()
    loss.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="backpropagated through once"):
        loss.backward()


def test_saved_attention_replays_in_order_and_checks_each_result():
    """The recompute gets the forward's results in order without computing;
    one unlike the call's query, or one past what was kept, raises."""
    store = fa.SavedAttention()
    forward, recompute = store.contexts()
    q_a, q_b = torch.zeros(1, 4, 2, 8), torch.zeros(1, 6, 2, 8)
    results = [(torch.randn(1, 4, 2, 8), torch.randn(1, 2, 4)), (torch.randn(1, 6, 2, 8), torch.randn(1, 2, 6))]
    with forward:
        for q, r in zip((q_a, q_b), results):
            assert fa.saved_or_computed(lambda r=r: r, like=q) is r
    never = lambda: pytest.fail("the recompute computed attention")
    with recompute:
        got = fa.saved_or_computed(never, like=q_a)
        with pytest.raises(RuntimeError, match="order"):
            fa.saved_or_computed(never, like=q_a)  # the kept result is q_b's
        with pytest.raises(RuntimeError, match="once"):
            fa.saved_or_computed(never, like=q_b)
    assert all(torch.equal(g, w) for g, w in zip(got, results[0]))
    assert fa.saved_or_computed(lambda: results[0], like=q_a) is results[0]  # no block active: computed
