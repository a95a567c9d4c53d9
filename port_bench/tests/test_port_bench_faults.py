"""Each fault a serving cell can have, planted under the timed path of a tiny
run on the CPU, makes ``correct`` false (and so does self-attention over the
wrong keys, K1's and K10's work); and the control (the reference in
float8 in the program's place) fails the cells' limits, as it does at the
cells' own size on the chip (port_bench/control.py)."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import CELLS, TRAIN_CELLS
from port_bench import run
from port_bench.serve import Serve

SEED = 2**32 + 99


def broken_sampler(velocity_fn, x_init, coeffs):
    """A step that returns its state unchanged."""
    x = x_init.float().clone()
    for i in range(coeffs.num_steps):
        velocity_fn(x, float(coeffs.timesteps[i]))
    return x


def half_batch_forward(original):
    """The DiT forward over the first half of its batch, that half standing
    in for the rest (the mean over the samples computed)."""

    def forward(self, x, timesteps, crossattn_emb, *args, **kwargs):
        half = x.shape[0] // 2
        out = original(self, x[:half], timesteps[:half], crossattn_emb[:half], *args, **kwargs)
        return torch.cat([out, out])

    return forward


def altered_block(original):
    """The output of the block marked ``altered`` changed where it is produced."""

    def forward(self, x, *args, **kwargs):
        out = original(self, x, *args, **kwargs)
        if getattr(self, "altered", False):
            out = out + 0.05 * out.std() * torch.ones_like(out)
        return out

    return forward


def shifted_keys(original):
    """Self-attention pairing each key with the wrong value (v rolled by one token)."""

    def attention(q, k, v, *args, **kwargs):
        if q.shape[1] == k.shape[1]:
            v = v.roll(1, dims=1).contiguous()
        return original(q, k, v, *args, **kwargs)

    return attention


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered_output", "wrong_keys"])
def test_fault_makes_correct_false(tiny_root, monkeypatch, workload, fault):
    from cosmos_predict2_tpu_torch.networks import dit
    from cosmos_predict2_tpu_torch.schedulers import unipc

    if fault == "state_unchanged":
        monkeypatch.setattr(unipc, "sample", broken_sampler)
    elif fault == "half_batch":
        monkeypatch.setattr(dit.MiniTrainDIT, "forward", half_batch_forward(dit.MiniTrainDIT.forward))
    elif fault == "wrong_keys":
        monkeypatch.setattr(dit, "dot_product_attention", shifted_keys(dit.dot_product_attention))
        monkeypatch.setattr(dit, "neighborhood_attention", shifted_keys(dit.neighborhood_attention))
    else:
        monkeypatch.setattr(dit.Block, "forward", altered_block(dit.Block.forward))
        original_init = Serve.__init__

        def init(self, *args, **kwargs):
            original_init(self, *args, **kwargs)
            self.net.blocks[1].altered = True

        monkeypatch.setattr(Serve, "__init__", init)
    result = run.run(tiny_root, workload, SEED, 0.3, False, device="cpu")
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", sorted(CELLS) + sorted(TRAIN_CELLS))
def test_control_fails_the_limits(tiny_root, workload):
    spec = run.load_cell(tiny_root, workload)
    limits = json.loads((tiny_root / "port_bench" / "limits" / f"{workload}.json").read_text())
    runner = run.kind_class(spec["traffic"]["kind"])(spec["config"], spec["traffic"], torch.device("cpu"), SEED)
    runner.warm_up()
    runner.window(0.3)
    runner.free_program()
    numbers = runner.check(control=True)
    assert all(readings[0] <= limits[name] for name, readings in numbers.items()), numbers
    assert any(readings[1] > limits[name] for name, readings in numbers.items()), numbers


@pytest.mark.parametrize("fault", ["state_unchanged", "altered_loss"])
def test_training_fault_makes_correct_false(tiny_root, monkeypatch, fault):
    """The post-training cell's faults: a step that leaves the parameters as
    they were (the optimizer's update dropped), and the loss altered where it
    is produced. Half a batch of one sample and an exchange between chips do
    not exist there."""
    from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel

    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    else:
        original = Video2WorldModel.training_step

        def training_step(self, *args, **kwargs):
            loss, metrics = original(self, *args, **kwargs)
            return loss * 1.05, dict(metrics, loss=metrics["loss"] * 1.05)

        monkeypatch.setattr(Video2WorldModel, "training_step", training_step)
    result = run.run(tiny_root, next(iter(TRAIN_CELLS)), SEED, 0.3, False, device="cpu")
    assert result["correct"] is False, result["checks"]
