"""The serving kind: Video2World requests with batched classifier-free
guidance, timed by whole denoising steps.

Set-up builds the port's net for the configuration's registry name (every
number of the configuration file is checked against it), fills its weights
from the seed (port_bench/weights.py), draws the prompt and its conditioning
latents, and warms up with one step. The window then drives
``Video2WorldModel.generate`` (UniPC over ``velocity_fn_from_condition``, as
``Video2WorldInference._run`` calls it) request after request. A step is one
batched-CFG DiT forward plus the UniPC update; each ends at the next
velocity call, where the device is synchronized and the clock read. When
``--seconds`` have passed at such a boundary the window closes: every step it
started is whole.

The check (:meth:`Serve.check`) holds what the window produced against
port_bench/reference.py, once the window has closed and the program's net is
freed:

* ``sampler``: every request's states, worked out again from its noise and
  the program's velocities (all steps of the window);
* ``embed``: the patch embedding of one step's input against the program's
  first block input;
* ``attention``: each block's self-attention output (K1 or K10, after the
  output projection) at ``check_rows`` rows of each CFG half drawn from the
  seed, from the program's own input to that block;
* ``blocks``: each block's update at those rows (self-attention,
  cross-attention, MLP), from the same input (the fp32 chain at 84,480
  tokens would take longer than a minute a step);
* ``chain``: two consecutive blocks i and i + 1 (i drawn from the seed)
  chained in the reference: block i at every row from the program's input
  to it, block i + 1 at its sampled rows from the reference's own output;
  the two blocks' update against the program's. What a teacher-forced block
  check cannot see, an error that grows as it passes from block to block,
  shows here over one step of the chain;
* ``velocity``: the final layer, FRAME_REPLACE and guidance from the
  program's last block output, against the velocity the sampler got.

The step whose activations are kept is drawn from the seed, uniformly over
the window's steps (reservoir sampling: step k is kept with probability 1/k).
Those activations are the harness's, not the program's: ``check_bytes``
tells the run what to leave out of the program's peak.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import time

import numpy as np
import torch

from port_bench import counting
from port_bench import reference as R
from port_bench import weights as W

# configuration key -> attribute path in the port's experiment config
_PORT_KEYS = {
    "state_ch": "model.state_ch", "state_t": "model.state_t", "sampling_num_steps": "model.sampling_num_steps",
    "sampling_shift": "model.sampling_shift", "use_karras_sigma_at_inference": "model.use_karras_sigma_at_inference",
    "cfg_mode": "model.cfg_mode", "denoise_replace_gt_frames": "model.denoise_replace_gt_frames",
    "conditional_frame_timestep": "model.conditional_frame_timestep", "loss_scale": "model.loss_scale",
    "conditional_frames_probs": "model.conditional_frames_probs",
    "use_high_sigma_strategy": "model.use_high_sigma_strategy", "high_sigma_ratio": "model.high_sigma_ratio",
    "rectified_flow_shift": "model.rectified_flow.shift", "head_dim": "model.net.head_dim",
    "text_dropout_rate": "model.text_dropout_rate", "video_cond_dropout_rate": "model.video_cond_dropout_rate",
    "high_sigma_timesteps_min": "model.high_sigma_timesteps_min",
    "high_sigma_timesteps_max": "model.high_sigma_timesteps_max",
    "train_time_distribution": "model.rectified_flow.train_time_distribution",
    "train_time_weight": "model.rectified_flow.train_time_weight",
}
_NET_KEYS = ("model_channels", "num_blocks", "num_heads", "mlp_ratio", "use_adaln_lora", "adaln_lora_dim",
             "in_channels", "out_channels", "patch_spatial", "patch_temporal", "concat_padding_mask",
             "concat_condition_mask", "use_crossattn_projection", "crossattn_proj_in_channels",
             "crossattn_emb_channels", "rope_h_extrapolation_ratio", "rope_w_extrapolation_ratio",
             "rope_t_extrapolation_ratio", "rope_enable_fps_modulation", "n_dense_blocks", "natten_window",
             "natten_stride", "natten_dilation", "natten_base_size")


class StopWindow(Exception):
    """Raised at a step boundary once the window's time is up."""


def port_config(cfg: dict, experiment: str | None = None, overrides: list | None = None):
    """The port's experiment config (the configuration's registry name, or a
    recipe over it), checked against every number the configuration file
    states."""
    from cosmos_predict2_tpu_torch.configs.defaults import make_config

    port = make_config(experiment or cfg["registry_name"], list(cfg.get("overrides", [])) + list(overrides or []))
    keys = dict(_PORT_KEYS, **{k: f"model.net.{k}" for k in _NET_KEYS})
    wrong = []
    for key, path in keys.items():
        value = port
        for part in path.split("."):
            value = getattr(value, part)
        want = cfg[key]
        value = json.loads(json.dumps(value)) if isinstance(value, tuple) else value
        if value != want:
            wrong.append(f"{key}: registry {value!r}, file {want!r}")
    if str(port.model.net.dtype).removeprefix("torch.") != cfg["dtype"]:
        wrong.append(f"dtype: registry {port.model.net.dtype}, file {cfg['dtype']}")
    if wrong:
        raise ValueError(f"{cfg['registry_name']}: the configuration file disagrees with the registry: {wrong}")
    return port


@dataclasses.dataclass
class Request:
    noise: torch.Tensor  # (1, C, T, H, W) fp32: x_0
    states: list = dataclasses.field(default_factory=list)  # x entering each step (and the last output)
    velocities: list = dataclasses.field(default_factory=list)


class Serve:
    """One serving cell's program, inputs and window."""

    kind = "serve"
    max_chips = 1

    def __init__(self, cfg: dict, traffic: dict, device: torch.device, seed: int):
        from cosmos_predict2_tpu_torch.models.video2world import Video2WorldModel
        from cosmos_predict2_tpu_torch.networks.dit import build_serving_dit

        self.cfg, self.traffic, self.device, self.seed = cfg, traffic, torch.device(device), seed
        port = port_config(cfg)
        self.latent = (cfg["state_ch"], 1 + (traffic["frames"] - 1) // 4, traffic["height"] // 8, traffic["width"] // 8)
        if self.latent[1] != cfg["state_t"]:
            raise ValueError(f"{traffic['frames']} frames make {self.latent[1]} latent frames, the model takes "
                             f"{cfg['state_t']}")
        self.grid = R.token_grid(cfg, self.latent[1:])
        self.net = build_serving_dit(port.model.net, self.device, seed=None)
        W.fill(W.dit_spec(cfg), self.net.state_dict(), seed)
        serve = self

        class TimedModel(Video2WorldModel):
            def velocity_fn_from_condition(self, *args, **kwargs):
                inner = super().velocity_fn_from_condition(*args, **kwargs)

                def velocity_fn(x, t):
                    serve._boundary(x)
                    v = inner(x, t)
                    serve.requests[-1].velocities.append(v)
                    return v

                return velocity_fn

        self.model = TimedModel(port.model, self.net)
        b = traffic["batch"]
        self.text = W.normal((b, cfg["text_tokens"], cfg["crossattn_proj_in_channels"]), seed, 2, self.device)
        self.gt = W.normal((b, *self.latent), seed, 3, self.device)
        # the kept step's activations: each block's input and the final layer's,
        # and each self-attention's output at the rows the check samples
        n, d = cfg["num_blocks"], cfg["model_channels"]
        S = int(np.prod(self.grid))
        rng = np.random.default_rng(W.stream_seed(seed, 5))
        self.rows = torch.from_numpy(np.stack([np.stack([np.sort(rng.choice(S, size=min(traffic["check_rows"], S),
                                                                            replace=False)) for _ in range(2 * b)])
                                               for _ in range(n)])).to(self.device)
        self.kept = torch.empty((n + 1, 2 * b, *self.grid, d), dtype=torch.bfloat16, device=self.device)
        self.kept_attn = torch.empty((n, 2 * b, self.rows.shape[-1], d), dtype=torch.bfloat16, device=self.device)
        self._capture = False
        for i, block in enumerate(self.net.blocks):
            block.register_forward_pre_hook(self._keeper(i))
            block.self_attn.register_forward_hook(self._attention_keeper(i))
        self.net.final_layer.register_forward_pre_hook(self._keeper(n))
        self.requests: list[Request] = []
        self.kept_at = None  # (request, step)
        self.mode, self.seconds = "idle", 0.0
        self._rng = np.random.default_rng(W.stream_seed(seed, 4))
        self.chain_at = int(np.random.default_rng(W.stream_seed(seed, 6)).integers(0, n - 1)) if n > 1 else None

    def check_bytes(self) -> int:
        """Device bytes the check holds through the window."""
        return sum(t.numel() * t.element_size() for t in (self.kept, self.kept_attn, self.rows))

    def _keeper(self, i: int):
        def hook(module, args):
            if self._capture:
                self.kept[i].copy_(args[0])
        return hook

    def _attention_keeper(self, i: int):
        def hook(module, args, out):
            if self._capture:
                batch = torch.arange(out.shape[0], device=out.device)[:, None]
                self.kept_attn[i].copy_(out[batch, self.rows[i]])
        return hook

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _boundary(self, x: torch.Tensor) -> None:
        self._sync()
        now = time.perf_counter()
        req = self.requests[-1]
        req.states.append(x)  # the sampler makes a new tensor each step: no copy
        if self.mode == "warmup":
            if self.started:
                raise StopWindow
        else:
            if self.started:
                self.done, self.t_last = self.started, now
            if self.started and now - self.t0 >= self.seconds:
                raise StopWindow
        self.started += 1
        # reservoir sampling of the kept step over the steps started; the
        # warm-up step keeps its activations too, so the window loads no new kernel
        self._capture = self.mode == "warmup" or self._rng.random() < 1.0 / self.started
        if self._capture and self.mode == "window":
            self.kept_at = (len(self.requests) - 1, len(req.states) - 1)

    def _requests(self, tag0: int) -> None:
        """Requests until a boundary raises StopWindow."""
        from cosmos_predict2_tpu_torch.conditioning.conditioner import DataType, make_condition

        tr = self.traffic
        while True:
            noise = W.normal((tr["batch"], *self.latent), self.seed, tag0 + len(self.requests), self.device)
            self.requests.append(Request(noise))
            cond = make_condition(self.text, data_type=DataType.VIDEO).replace(gt_frames=self.gt)
            out = self.model.generate(noise, cond, guidance=tr["guidance"], num_steps=tr["num_steps"],
                                      num_conditional_frames=tr["conditional_latent_frames"])
            self.requests[-1].states.append(out)

    @torch.no_grad()
    def warm_up(self) -> None:
        """One step of a request that is then dropped: every shape and plan of
        the window is built."""
        self.mode, self.started = "warmup", 0
        try:
            self._requests(tag0=1000)
        except StopWindow:
            pass
        self._sync()
        self.requests.clear()

    @torch.no_grad()
    def window(self, seconds: float, profiler=None) -> dict:
        """Steps until ``seconds`` have passed at a step boundary."""
        self.mode, self.seconds, self.started, self.done = "window", seconds, 0, 0
        self._sync()
        if profiler is not None:
            profiler.start()
        self.t0 = self.t_last = time.perf_counter()
        try:
            self._requests(tag0=2000)
        except StopWindow:
            pass
        if profiler is not None:
            profiler.stop()
        self._capture = False
        self.mode = "idle"
        failed = sum(not bool(torch.isfinite(v).all()) for r in self.requests for v in r.velocities)
        return {"window_s": self.t_last - self.t0, "units": self.done, "failed": int(failed),
                "metric": "denoise_step_s"}

    def counted(self, units: int) -> dict:
        """What the window's steps compute, for the per-layer readers."""
        calls = counting.dit_attention_calls(self.cfg, 2 * self.traffic["batch"], self.grid)
        return {"flops": units * counting.dit_forward_flops(self.cfg, 2 * self.traffic["batch"], self.grid),
                "attention": [dict(c, count=c["count"] * units) for c in calls]}

    def free_program(self) -> None:
        self.net = self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self, control: bool = False) -> dict:
        """The numbers compared, against the fp32 reference; with ``control``
        also the fp8 control's, as ``{name: (program, control)}``."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg, tr = self.cfg, self.traffic
        params = R.DiT.make_params(cfg, self.seed, self.device)
        ref = R.DiT(cfg, params)
        low = R.DiT(cfg, params, R.Precision(fp8=True)) if control else None
        k, g = tr["conditional_latent_frames"], tr["guidance"]
        sched = R.unipc_schedule(tr["num_steps"], cfg["sampling_shift"])
        found: dict[str, list] = {}

        def note(name, prog, ctrl=None):
            cur = found.setdefault(name, [0.0, 0.0])
            cur[0] = max(cur[0], prog)
            if ctrl is not None:
                cur[1] = max(cur[1], ctrl)

        fp8 = R.Precision(fp8=True).round
        for req in self.requests:
            n = len(req.velocities)
            want = R.unipc_states(sched, req.noise, req.velocities)
            lows = R.unipc_states(sched, req.noise, req.velocities, round_fn=fp8) if control else None
            for i in range(min(n, len(req.states) - 1)):
                note("sampler", R.rel(req.states[i + 1], want[i]), R.rel(lows[i], want[i]) if control else None)

        # the DiT's batch: the b conditional samples, then the b unconditional
        r_i, s_i = self.kept_at
        req = self.requests[r_i]
        b = tr["batch"]
        x_in = R.denoise_input(torch.cat([req.states[s_i]] * 2), torch.cat([self.gt] * 2), k, cfg["concat_padding_mask"])
        embed = ref.patch_embed(x_in)
        note("embed", R.rel(self.kept[0].float(), embed), R.rel(low.patch_embed(x_in), embed) if control else None)

        t = torch.full((1, 1), float(sched["timesteps"][s_i]), device=self.device)
        emb, lora = (a[0, 0].expand(self.grid[0], -1) for a in ref.time_embed(t))
        text = torch.cat([self.text, torch.zeros_like(self.text)])
        ctx = ref.caption(text)
        ctx_low = low.caption(text) if control else None
        S = int(np.prod(self.grid))
        for i in range(cfg["num_blocks"]):
            for j in range(2 * b):
                xj = self.kept[i, j].float().reshape(S, -1)
                rows = self.rows[i, j]
                out, attn = ref.block_rows(i, xj, rows, emb, lora, ctx[j], self.grid)
                got = self.kept[i + 1, j].float().reshape(S, -1)[rows] - xj[rows]
                ctrl = (None, None)
                if control:
                    low_out, low_attn = low.block_rows(i, xj, rows, emb, lora, ctx_low[j], self.grid)
                    ctrl = (R.rel(low_attn, attn), R.rel(low_out - xj[rows], out - xj[rows]))
                note("attention", R.rel(self.kept_attn[i, j].float(), attn), ctrl[0])
                note("blocks", R.rel(got, out - xj[rows]), ctrl[1])

        if self.chain_at is not None:
            i = self.chain_at
            for j in range(2 * b):
                xj = self.kept[i, j].float().reshape(S, -1)
                rows = self.rows[i + 1, j]
                got = self.kept[i + 2, j].float().reshape(S, -1)[rows] - xj[rows]
                mid = ref.block_all(i, xj, emb, lora, ctx[j], self.grid)
                want = ref.block_rows(i + 1, mid, rows, emb, lora, ctx[j], self.grid)[0] - xj[rows]
                del mid
                ctrl = None
                if control:
                    mid = low.block_all(i, xj, emb, lora, ctx_low[j], self.grid)
                    ctrl = R.rel(low.block_rows(i + 1, mid, rows, emb, lora, ctx_low[j], self.grid)[0] - xj[rows],
                                 want)
                    del mid
                note("chain", R.rel(got, want), ctrl)

        last = self.kept[-1].float().reshape(2 * b, S, -1)
        e2, l2 = emb[None].expand(2 * b, -1, -1), lora[None].expand(2 * b, -1, -1)
        v_ref = ref.final(last, e2, l2, self.grid)
        want = R.guided_velocity(v_ref[:b], v_ref[b:], req.noise, self.gt, k, g)
        ctrl = None
        if control:
            v_low = low.final(last, e2, l2, self.grid)
            ctrl = R.rel(R.guided_velocity(v_low[:b], v_low[b:], req.noise, self.gt, k, g), want)
        note("velocity", R.rel(req.velocities[s_i], want), ctrl)
        return {name: tuple(v) if control else v[0] for name, v in found.items()}


RUNNER = Serve
