"""The post-training kind: the released full post-training recipe, timed by
whole iterations.

Set-up builds the recipe's trainable DiT (fp32 masters) and its Wan2.1 VAE
with the seed's weights (port_bench/weights.py), a pool of uint8 clips and
text embeddings drawn from the seed, the port's ``Trainer`` with its
optimizer, EMA and remat as the recipe sets them, and feeds it through the
port's data path (training/train.py::latent_batches: the transfer, the
normalisation and the streaming VAE encode). The step draws (dropout,
conditional frames, noise, train time) come from the benchmark
(port_bench/reference_train.py::draws) through the trainer's ``draw_fn``.
Set-up drives that trainer through its first two iterations, on two
different clips, and keeps what the check needs: each step's loss and
latents, each leaf's gradient norm as the optimizer got it (AdamW's first
moment after step 1 over 1 - beta1) and each leaf's change of the
parameters and of the EMA after step 2. Two and not three: the fp32
reference's steps at 31,104 tokens take some 45 s each, and every run of
every later check pays for them. The same trainer then runs the
window: whole iterations (the data section, forward and backward, the
optimizer and the EMA) until ``--seconds`` have passed at an iteration's end.

The check, once the window has closed and the program is freed:

* ``latents``: the reference's encode of each set-up step's clip against
  the program's latents (the loss below is worked out from the latter);
* ``loss``: each of the two steps' loss, from the program's latents (the
  encode is checked apart) with the same draws;
* ``grad``: step 1's gradient, the worst leaf's gap of norms;
* ``update`` and ``ema``: the parameters' and the EMA's change after two
  steps, the worst leaf's gap of norms, over the leaves whose reference
  gradient is at least a thousandth of the median leaf's.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from port_bench import counting
from port_bench import reference as R
from port_bench import reference_train as RT
from port_bench import weights as W
from port_bench.serve import StopWindow, port_config

SETUP_STEPS = 2  # the iterations set-up drives and the reference follows


class Train:
    """One post-training cell's program, inputs and window."""

    kind = "train"
    max_chips = 1

    def __init__(self, cfg: dict, traffic: dict, device: torch.device, seed: int):
        from cosmos_predict2_tpu_torch.models.video2world import TrainDraws, Video2WorldModel
        from cosmos_predict2_tpu_torch.networks.dit import MiniTrainDIT
        from cosmos_predict2_tpu_torch.tokenizers.wan_vae import WanVAE
        from cosmos_predict2_tpu_torch.training.train import latent_batches
        from cosmos_predict2_tpu_torch.training.trainer import Callback, Trainer

        self.cfg, self.traffic, self.device, self.seed = cfg, traffic, torch.device(device), seed
        port = port_config(cfg, traffic["recipe"], traffic.get("overrides"))
        check_recipe(port, traffic)
        tr = traffic
        if tr["batch"] != 1:
            raise ValueError(f"the post-training runner feeds one clip an iteration; the traffic asks batch {tr['batch']}")
        self.latent = (cfg["state_ch"], 1 + (tr["frames"] - 1) // 4, tr["height"] // 8, tr["width"] // 8)
        self.grid = R.token_grid(cfg, self.latent[1:])
        with torch.device("meta"):
            net = MiniTrainDIT(port.model.net)
            vae = WanVAE(port.tokenizer)
        self.net = net.to_empty(device=self.device)
        W.fill(W.dit_spec(cfg), self.net.state_dict(), seed)
        self.net.train().requires_grad_(True)
        self.vae = vae.to_empty(device=self.device)
        W.fill(RT.vae_encoder_spec(tr["vae"]), self.vae.state_dict(), W.stream_seed(seed, 30))
        self.vae.eval().requires_grad_(False)

        # the pool: uint8 clips and text embeddings, drawn on the device, kept on the host as a loader's are
        n, shape = tr["pool_clips"], (3, tr["frames"], tr["height"], tr["width"])
        gen = torch.Generator(device=self.device).manual_seed(W.stream_seed(seed, 31))
        self.clips = [torch.randint(0, 256, shape, generator=gen, device=self.device, dtype=torch.uint8).cpu()
                      for _ in range(n)]
        self.texts = [W.normal((cfg["text_tokens"], cfg["crossattn_proj_in_channels"]), seed, 32 + i, self.device).cpu()
                      for i in range(n)]
        model = Video2WorldModel(port.model, self.net)
        run = self

        def draw_fn(iteration: int, x0: torch.Tensor):
            d = RT.draws(cfg, tuple(x0.shape[1:]), seed, iteration, self.device)
            t = lambda v, dtype: torch.tensor([v], dtype=dtype, device=self.device)
            return TrainDraws(text_keep=t(d["text_keep"], torch.bool),
                              use_video=torch.tensor(d["use_video"], device=self.device),
                              num_conditional_frames=t(d["num_conditional_frames"], torch.int64),
                              eps=d["eps"][None], u=t(d["u"], torch.float32),
                              high_sigma=t(d["high_sigma"], torch.bool),
                              high_sigma_index=t(d["high_sigma_index"], torch.int64))

        class Clock(Callback):
            def on_training_step_start(self, trainer, state, batch, iteration):
                if iteration < SETUP_STEPS:
                    run.setup_latents.append(batch[0].detach().clone())

            def on_training_step_end(self, trainer, state, metrics, iteration):
                run._step_end(state, metrics, iteration)

        trainer_cfg = dataclasses.replace(port.trainer, max_iter=1 << 40, logging_iter=1 << 40, save_iter=0)
        self.trainer = Trainer(trainer_cfg, model, callbacks=[Clock()], draw_fn=draw_fn)
        self.state = self.trainer.init_state()
        self.batches = latent_batches(self._loader(), self.vae, self.device)
        self.setup_latents: list[torch.Tensor] = []
        self.losses: list[float] = []
        self.program: dict[str, dict[str, float]] = {}
        self.mode = "setup"

    def check_bytes(self) -> int:
        """Device bytes the check holds through the window."""
        return sum(t.numel() * t.element_size() for t in self.setup_latents)

    def _loader(self):
        i = 0
        while True:
            j = i % len(self.clips)
            yield {"video": self.clips[j][None].numpy(), "t5_text_embeddings": self.texts[j][None].numpy(),
                   "fps": np.array([self.traffic["fps"]], dtype=np.float32)}
            i += 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def _step_end(self, state, metrics, iteration: int) -> None:
        if self.mode == "setup":
            self.losses.append(float(metrics["loss"]))
            if iteration == 1:  # AdamW's first moment after one step is (1 - beta1) g
                b1 = state.optimizer.param_groups[0]["betas"][0]
                moment = lambda p: state.optimizer.state.get(p, {}).get("exp_avg", torch.zeros(()))
                self.program["grad"] = {n: float(moment(p).double().norm()) / (1 - b1) for n, p in state.params.items()}
            if iteration == SETUP_STEPS:
                start = {name: torch.empty(shape, device=self.device) for name, shape, _ in W.dit_spec(self.cfg)}
                W.fill(W.dit_spec(self.cfg), start, self.seed)
                self.program["update"] = {n: float((p.detach() - start[n]).double().norm())
                                          for n, p in state.params.items()}
                self.program["ema"] = {n: float((e - start[n]).double().norm()) for n, e in state.ema_params.items()}
                del start
                raise StopWindow
            return
        now = time.perf_counter()
        self.done, self.t_last = self.done + 1, now
        self.data_s += self.trainer.last_timings["data_s"]
        self.failed += not np.isfinite(float(metrics["loss"]))
        if now - self.t0 >= self.seconds:
            raise StopWindow

    def warm_up(self) -> None:
        """The first iterations, which the check follows."""
        try:
            self.trainer.train(self.state, self.batches)
        except StopWindow:
            pass
        self._sync()

    def window(self, seconds: float, profiler=None) -> dict:
        self.mode, self.seconds, self.done, self.data_s = "window", seconds, 0, 0.0
        self.failed = sum(not np.isfinite(x) for x in self.losses)
        self._sync()
        if profiler is not None:
            profiler.start()
        self.t0 = self.t_last = time.perf_counter()
        try:
            self.trainer.train(self.state, self.batches, start_iteration=SETUP_STEPS)
        except StopWindow:
            pass
        if profiler is not None:
            profiler.stop()
        self.mode = "idle"
        return {"window_s": self.t_last - self.t0, "units": self.done, "failed": int(self.failed),
                "metric": "train_iter_s", "data_s": self.data_s / max(self.done, 1)}

    def counted(self, units: int) -> dict:
        """Per iteration: forward and backward (3 forwards; remat's recompute
        not counted); the attention calls forward (twice: block remat) and
        backward (K7 + K8, kernel "k7k8")."""
        calls = [c for c in counting.dit_attention_calls(self.cfg, 1, self.grid) if c["kernel"] == "k1"]
        return {"flops": units * 3 * counting.dit_forward_flops(self.cfg, 1, self.grid),
                "attention": [dict(c, count=2 * c["count"] * units) for c in calls]
                + [dict(c, kernel="k7k8", count=c["count"] * units) for c in calls]}

    def free_program(self) -> None:
        self.net = self.vae = self.trainer = self.state = self.batches = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """The numbers compared; with ``control`` ``{name: (program, control,
        altered)}``: the control the reference with float8 operands in the
        program's place, ``altered`` the reference with each loss altered by
        5% where it is produced (a planted fault)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        want = self._reference(None)
        found = {name: compare(name, self.program_readings(), want) for name in NUMBERS}
        if not control:
            return found
        low = self._reference(R.Precision(fp8=True))
        bad = self._reference(None, altered=1.05)
        return {name: (found[name], compare(name, low, want), compare(name, bad, want)) for name in NUMBERS}

    def program_readings(self) -> dict:
        return dict(self.program, losses=self.losses, latents=[x[0] for x in self.setup_latents])

    def _reference(self, precision, altered: float = 1.0) -> dict:
        """The reference's (or the control's) readings: each set-up step's
        clip encoded, the set-up's training steps from the seed's weights."""
        tr, dev = self.traffic, self.device
        enc = RT.VAEEncoder(tr["vae"], R.DiT.make_params_from(RT.vae_encoder_spec(tr["vae"]),
                                                              W.stream_seed(self.seed, 30), dev), precision)
        latents = [enc.encode(self.clips[step % len(self.clips)].to(dev)) for step in range(SETUP_STEPS)]
        del enc
        out = {"latents": latents, "losses": []}
        trainer = RT.Trainer(self.cfg, tr, R.DiT.make_params(self.cfg, self.seed, dev), precision, altered)
        for step in range(SETUP_STEPS):
            d = RT.draws(self.cfg, self.latent, self.seed, step, dev)
            loss, grad_norms = trainer.step(self.setup_latents[step][0], self.texts[step % len(self.texts)].to(dev), d)
            out["losses"].append(loss)
            if step == 0:
                out["grad"] = grad_norms
        out.update(trainer.changes(self.seed))
        del trainer
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out


NUMBERS = ("latents", "loss", "grad", "update", "ema")


def compare(name: str, got: dict, want: dict) -> float:
    if name == "latents":
        return max(R.rel(g, w) for g, w in zip(got["latents"], want["latents"], strict=True))
    if name == "loss":
        return max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"]))
    keep = None
    if name != "grad":  # leaves whose reference gradient is no more than round-off move by round-off alone
        median = float(np.median(list(want["grad"].values())))
        keep = {n for n, g in want["grad"].items() if g >= 1e-3 * median}
    return RT.leaf_gap(got[name], want[name], keep)


def check_recipe(port, traffic: dict) -> None:
    """The traffic file's optimizer, EMA and VAE numbers against the recipe's."""
    opt, o = traffic["optimizer"], port.trainer.optimizer
    mine = {"lr": o.lr, "weight_decay": o.weight_decay, "betas": list(o.betas), "eps": o.eps,
            "grad_clip_norm": o.grad_clip_norm, "warm_up_steps": o.warm_up_steps[0], "f_start": o.f_start[0],
            "f_max": o.f_max[0], "f_min": o.f_min[0], "cycle_length": o.cycle_lengths[0],
            "ema_rate": port.trainer.ema_rate, "ema_enabled": port.trainer.ema_enabled,
            "moments_dtype": o.moments_dtype, "remat": port.model.net.remat}
    v = port.tokenizer
    vae = {"dim": v.dim, "z_dim": v.z_dim, "dim_mult": list(v.dim_mult), "num_res_blocks": v.num_res_blocks,
           "temporal_downsample": list(v.temporal_downsample), "dtype": str(v.dtype).removeprefix("torch.")}
    data = {"frames": port.data_train.num_frames, "height": port.data_train.height, "width": port.data_train.width,
            "batch": port.data_train.batch_size}
    wrong = [f"{k}: recipe {mine[k]!r}, file {opt[k]!r}" for k in mine if mine[k] != opt[k]]
    wrong += [f"vae.{k}: recipe {vae[k]!r}, file {traffic['vae'][k]!r}" for k in vae if vae[k] != traffic["vae"][k]]
    wrong += [f"{k}: recipe {data[k]!r}, file {traffic[k]!r}" for k in data if data[k] != traffic[k]]
    if len(port.trainer.optimizer.warm_up_steps) != 1 or port.trainer.grad_accum_iter != 1:
        wrong.append("the recipe's schedule has more than one cycle, or accumulates gradients")
    if wrong:
        raise ValueError(f"{traffic['recipe']}: the traffic file disagrees with the recipe: {wrong}")


RUNNER = Train
