"""bf16 Adam moments in the port, held against the JAX package (CPU).

``scale_by_adam_bf16`` on the same uniform rounding bits as JAX's (its key
splits reproduced here): the new bf16 moments are bit-equal and the fp32
updates agree to 1.2e-7 absolute on updates of magnitude ~1 (one fp32 ulp:
the bias corrections and the division in another order; checked at rtol
1e-6, atol 1e-6). The stochastic rounding is unbiased over many draws and lands on bf16
values; the optimizer keeps its moments in bf16, applies JAX's chain
(clip -> adam -> decoupled decay -> -lr * schedule) and resumes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.training import optim as joptim
from cosmos_predict2_tpu_torch.training import optim as toptim


def jax_bits(key, leaves):
    """The rounding noise JAX's scale_by_adam_bf16 draws at one update from
    its state key: (new key, mu noise, nu noise), int32 in [0, 2^16)."""
    key, sub = jax.random.split(key)
    keys = jax.random.split(sub, 2 * len(leaves))
    bits = [np.asarray(jax.random.bits(k, np.shape(l), jnp.uint32) & 0xFFFF).astype(np.int32)
            for k, l in zip(keys, list(leaves) * 2)]
    return key, bits[: len(leaves)], bits[len(leaves):]


def test_scale_by_adam_bf16_matches_jax_on_the_same_bits():
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 33), "b": (17,), "c": (3, 4, 5)}
    tx = joptim.scale_by_adam_bf16(b1=0.9, b2=0.99, eps=1e-8, seed=3)
    state = tx.init({k: jnp.zeros(s) for k, s in shapes.items()})
    names = sorted(shapes)  # the order jax.tree flattens a dict in
    mu = [torch.zeros(shapes[k], dtype=torch.bfloat16) for k in names]
    nu = [torch.zeros(shapes[k], dtype=torch.bfloat16) for k in names]
    for count in range(1, 5):
        g = {k: (3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
        _, bits_mu, bits_nu = jax_bits(state.key, [g[k] for k in names])
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state)
        got = toptim.scale_by_adam_bf16([torch.from_numpy(g[k]) for k in names], mu, nu, count, (0.9, 0.99), 1e-8,
                                        [torch.from_numpy(b) for b in bits_mu], [torch.from_numpy(b) for b in bits_nu])
        for i, k in enumerate(names):
            np.testing.assert_array_equal(mu[i].float().numpy(), np.asarray(state.mu[k], np.float32), err_msg=k)
            np.testing.assert_array_equal(nu[i].float().numpy(), np.asarray(state.nu[k], np.float32), err_msg=k)
            np.testing.assert_allclose(got[i].numpy(), np.asarray(updates[k]), rtol=1e-6, atol=1e-6, err_msg=k)


def test_stochastic_rounding_is_unbiased_and_lands_on_bf16():
    """Every draw is one of x's two bf16 neighbours (truncation, with noise
    0, and the next value away from zero, with noise 2^16 - 1; x itself when
    it is a bf16 value), and the mean of n draws is within 4 standard errors
    of x."""
    sr = toptim.stochastic_round_to_bf16
    gen = torch.Generator().manual_seed(0)
    x = torch.tensor([1.0 + 2.0**-9, -3.3e-3, 7.77e5, 1e-30, -1.0, 0.0], dtype=torch.float32)
    lo = sr(x, torch.zeros(x.shape, dtype=torch.int32)).float()
    hi = sr(x, torch.full(x.shape, 65535, dtype=torch.int32)).float()
    n = 20_000
    draws = torch.stack([sr(x, toptim.rounding_noise(x.shape, gen, "cpu")) for _ in range(n)]).float()
    assert bool(((draws == lo) | (draws == hi)).all())
    assert torch.equal(lo[4:], x[4:]) and torch.equal(hi[4:], x[4:])  # bf16 values stay
    assert bool((hi != lo)[:4].all())
    err = (draws.mean(0) - x).abs()
    assert bool((err <= 4 * (hi - lo).abs() / (2 * n**0.5)).all()), err
    with pytest.raises(TypeError):
        sr(x.double(), torch.zeros(6, dtype=torch.int32))


def _grads(rng, p0, steps):
    return [{k: (3 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in p0.items()} for _ in range(steps)]


def test_bf16_optimizer_follows_the_jax_chain_and_keeps_bf16_moments():
    """AdamWBF16 through make_optimizer with clipping and the schedule: its
    moments are bf16 in the state, and each step equals the JAX chain's
    update computed on the noise the optimizer drew (same generator seed,
    same order: per chunk the mu noise, then the nu noise)."""
    cfg = dict(lr=0.01, weight_decay=0.1, warm_up_steps=(2,), f_start=(0.1,), f_max=(1.0,), f_min=(0.5,),
               cycle_lengths=(10,), grad_clip_norm=1.0, moments_dtype="bfloat16", moments_seed=5)
    rng = np.random.default_rng(1)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt, sched = toptim.make_optimizer(toptim.OptimizerConfig(**cfg), params.values())
    assert isinstance(opt, toptim.AdamWBF16)
    replay = torch.Generator().manual_seed(5)
    ref = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    mu = [torch.zeros_like(p, dtype=torch.bfloat16) for p in ref.values()]
    nu = [torch.zeros_like(p, dtype=torch.bfloat16) for p in ref.values()]
    schedule = joptim.lambda_linear_schedule(cfg["warm_up_steps"], cfg["f_start"], cfg["f_max"], cfg["f_min"],
                                             cfg["cycle_lengths"])
    for count, g in enumerate(_grads(rng, p0, 4), start=1):
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        norm = toptim.global_norm([p.grad for p in params.values()])
        toptim.clip_by_global_norm_([p.grad for p in params.values()], norm, 1.0)
        opt.step()
        sched.step()
        # the reference: optax's clip, the port's scale_by_adam_bf16 on the replayed noise, optax's decay and -lr
        clipped, _ = optax.clip_by_global_norm(1.0).update(jax.tree.map(jnp.asarray, g), None)
        noise_mu = [toptim.rounding_noise(p.shape, replay, "cpu") for p in ref.values()]
        noise_nu = [toptim.rounding_noise(p.shape, replay, "cpu") for p in ref.values()]
        upd = toptim.scale_by_adam_bf16([torch.from_numpy(np.array(clipped[k])) for k in ref], mu, nu, count,
                                        (0.9, 0.99), 1e-8, noise_mu, noise_nu)
        lr = cfg["lr"] * float(schedule(count - 1))
        for (k, r), u in zip(ref.items(), upd):
            r.add_(-lr * (u + 0.1 * r))
            torch.testing.assert_close(params[k].detach(), r, rtol=1e-6, atol=1e-7)
        for p, m, v in zip(params.values(), mu, nu):
            assert opt.state[p]["exp_avg"].dtype == opt.state[p]["exp_avg_sq"].dtype == torch.bfloat16
            assert torch.equal(opt.state[p]["exp_avg"], m) and torch.equal(opt.state[p]["exp_avg_sq"], v)


def test_bf16_optimizer_resumes_exactly_and_chunks_like_one_pass():
    """A state dict (moments and the generator) resumed into a fresh
    optimizer continues bit for bit; chunking the parameters changes the
    order the noise is drawn in, not the update."""
    rng = np.random.default_rng(2)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in (("a", (6, 7)), ("b", (9,)), ("c", (4, 4)))}
    grads = _grads(rng, p0, 4)

    def run(chunk, steps, resume_from=None):
        params = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in p0.values()]
        opt = toptim.AdamWBF16(params, lr=0.01, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.1, seed=1)
        opt.CHUNK_ELEMENTS = chunk
        if resume_from is not None:
            sd, values = resume_from
            with torch.no_grad():
                for p, v in zip(params, values):
                    p.copy_(v)
            opt.load_state_dict(sd)
        for g in steps:
            for p, k in zip(params, p0):
                p.grad = torch.from_numpy(g[k])
            opt.step()
        return opt, [p.detach().clone() for p in params]

    full, want = run(1 << 27, grads)
    half, mid = run(1 << 27, grads[:2])
    resumed, got = run(1 << 27, grads[2:], resume_from=(half.state_dict(), mid))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(st["exp_avg"].dtype == torch.bfloat16 for st in resumed.state.values())
    # one tensor per chunk draws the noise in another order, so the stored moments differ; the
    # update reads the fp32 moments before they are rounded, so the first step's parameters do not
    one_opt, one_each = run(1, grads[:1])
    all_opt, together = run(1 << 27, grads[:1])
    assert all(torch.equal(a, b) for a, b in zip(one_each, together))
    assert any(not torch.equal(a["exp_avg"], b["exp_avg"]) for a, b in zip(one_opt.state.values(),
                                                                           all_opt.state.values()))


def test_moments_dtype_takes_two_values():
    assert isinstance(toptim.make_optimizer(toptim.OptimizerConfig(), [torch.nn.Parameter(torch.ones(2))])[0],
                      torch.optim.AdamW)
    with pytest.raises(ValueError, match="moments_dtype"):
        toptim.OptimizerConfig(moments_dtype="float16")
