"""The DDPM process: forward noising (and the training batch's noising), one
reverse step, and three samplers with classifier-free guidance: ancestral
DDPM, DDIM and DPM-Solver++(2M) (port of ldm_tpu/diffusion/ddpm.py).

Images are NHWC, as in the JAX package.  CFG runs the conditional and
unconditional passes as ONE forward on a 2B batch.

Each sampler is a loop over a table of timesteps (and, for DPM-Solver++, of
coefficients) that lies on the device; one step reads its row of the table
and the running x_t from device tensors alone, so the same step function
runs eagerly (a Python loop, the only loop on the CPU) and as a CUDA graph
captured once and replayed once a step, which is what the JAX package's
``lax.scan`` is to its samplers.  On a CUDA device the replayed graph is the
default; ``graph=False`` asks for the eager loop, and a caller who injects
the per-step noise gets the eager loop unless ``graph=True``.  A capture that
fails raises.

Randomness is an input: ``x_init`` (x_T) and ``noise`` (the per-step
draws), and ``t`` and ``eps`` of a training batch, can be given, so a test
can feed the JAX key stream; what is not given is drawn from the
``torch.Generator`` the caller passes.  A step's noise is drawn eagerly into
a fixed buffer just before the step (a generator made per request cannot be
captured); DDIM with ``eta == 0`` and DPM-Solver++ draw nothing after x_T.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ldm_tpu_torch.diffusion.schedule import DiffusionSchedule
from ldm_tpu_torch.utils.graphs import StepGraph, use_graphs

# eps model: (x_noisy, t, y) -> eps_theta.  `y` is int (B,); the unconditional
# pass uses the model's null label (UNet.null_label), which embeds to zero.
EpsModelFn = Callable[..., torch.Tensor]
# per-step noise: t -> the (B, H, W, C) N(0, I) draw for the step from t
NoiseFn = Callable[[int], torch.Tensor]


def gather(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-sample schedule value broadcastable over NHWC images."""
    return a[t].reshape(-1, 1, 1, 1)


def _row(table: torch.Tensor, i: Union[int, torch.Tensor]) -> torch.Tensor:
    """Entry ``i`` of a 1-d table as a 0-d tensor; ``i`` a Python int (the
    eager loop) or a 0-d int64 tensor on the table's device (a captured
    step: indexing by it directly would read it on the host)."""
    if isinstance(i, int):
        return table[i]
    return table.index_select(0, i.reshape(1)).squeeze(0)


@dataclasses.dataclass(frozen=True)
class _Method:
    """One sampler as the loop runs it: its name, the timesteps on the host
    (descending), the per-step tables on the device (the first is the
    timesteps), how many tensors its carry has, whether a step takes a noise
    draw, what tells two loops of the method apart (the graph cache's key),
    and DDIM's eta."""

    name: str
    ts: np.ndarray
    tables: Tuple[torch.Tensor, ...]
    n_carry: int
    draws: bool
    key: tuple
    eta: float = 0.0


# how many captured sampler steps a GaussianDiffusion keeps (each holds the
# activations of one UNet forward at its batch size)
MAX_SAMPLER_GRAPHS = 4


class GaussianDiffusion:
    """DDPM process with a linear (or sqrt-linear) beta schedule."""

    def __init__(self, n_steps: int, n_samples: int = 1, schedule: str = "linear",
                 beta_start: float = 1e-4, beta_end: float = 0.02, device=None):
        self.n_steps = int(n_steps)
        self.n_samples = int(n_samples)
        self.schedule = DiffusionSchedule.make(
            schedule, n_steps, beta_start, beta_end, device
        )
        self._graphs: dict = {}  # captured sampler steps, by _SamplerGraph.key
        # the samplers' methods by (name, arguments), their tables uploaded
        # once: a copy from pageable host memory waits for the stream, so a
        # caller that samples again and again (a service's batcher) would
        # wait for the device at every call
        self._methods: dict = {}
        # host seconds the last sample* call spent on warm-up and capture
        self.last_capture_seconds = 0.0

    # ------------------------------------------------------------ forward (q)
    def q_xt_x0(self, x0: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and variance of q(x_t | x_0)."""
        ab = gather(self.schedule.alpha_bars, t)
        return torch.sqrt(ab) * x0, 1.0 - ab

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """Sample x_t ~ q(x_t | x_0)."""
        mean, var = self.q_xt_x0(x0, t)
        return mean + torch.sqrt(var) * eps.to(mean.dtype)

    def noise_batch(self, x0: torch.Tensor, t: Optional[torch.Tensor] = None,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-sample t ~ U[0, T) and eps ~ N(0, I); returns (eps, x_t, t).

        The training-time noising of the diffusion trainer's step.  ``t``
        (int, (B,)) and ``eps`` (x0's shape) can be given, so a test can feed
        the JAX draws; what is not given is drawn from ``generator`` on x0's
        device, t first.
        """
        t, eps = self.draw_t_eps(x0, t, eps, generator)
        return eps, self.q_sample(x0, t, eps), t

    def draw_t_eps(self, x0: torch.Tensor, t: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The draws of :meth:`noise_batch` alone: (t, eps) on x0's device,
        what is not given drawn from ``generator``, t first."""
        if (t is None or eps is None) and generator is None:
            raise ValueError("pass a generator, or both t and eps")
        if t is None:
            t = torch.randint(0, self.n_steps, (x0.shape[0],), generator=generator,
                              device=x0.device)
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator, device=x0.device,
                              dtype=x0.dtype)
        return t.to(x0.device, torch.int64), eps.to(x0.device, x0.dtype)

    # ------------------------------------------------------------ reverse (p)
    def p_sample(self, xt: torch.Tensor, t: torch.Tensor, eps_theta: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """One ancestral step x_t -> x_{t-1}; ``noise`` is masked out where
        ``t == 0``."""
        s = self.schedule
        alpha_bar = gather(s.alpha_bars, t)
        alpha = gather(s.alphas, t)
        eps_coef = (1.0 - alpha) * torch.rsqrt(1.0 - alpha_bar)
        mean = torch.rsqrt(alpha) * (xt - eps_coef * eps_theta.to(xt.dtype))
        sigma = torch.sqrt(gather(s.sigma2, t))
        sigma = torch.where(t.reshape(-1, 1, 1, 1) > 0, sigma, 0.0)
        return mean + sigma * noise

    def ddim_step(self, xt: torch.Tensor, t: torch.Tensor, t_prev: torch.Tensor,
                  eps_theta: torch.Tensor, noise: Optional[torch.Tensor],
                  eta: float = 0.0) -> torch.Tensor:
        """One DDIM update x_t -> x_{t_prev} (Song et al. 2021, eq. 12).
        ``t`` and ``t_prev`` are int (B,); ``t_prev < 0`` means "to x_0"
        (alpha_bar_prev == 1, where the noise scale vanishes).  ``eta`` is
        static; with ``eta == 0`` the update is deterministic and ``noise``
        may be None."""
        s = self.schedule
        ab_t = gather(s.alpha_bars, t)
        ab_prev = torch.where(t_prev.reshape(-1, 1, 1, 1) >= 0,
                              gather(s.alpha_bars, t_prev.clamp_min(0)), 1.0)
        eps = eps_theta.to(torch.float32)
        x0_pred = (xt - torch.sqrt(1.0 - ab_t) * eps) * torch.rsqrt(ab_t)
        sigma = eta * torch.sqrt(
            ((1.0 - ab_prev) / (1.0 - ab_t)).clamp_min(0.0)
            * (1.0 - ab_t / ab_prev).clamp_min(0.0)
        )
        dir_xt = torch.sqrt((1.0 - ab_prev - sigma**2).clamp_min(0.0)) * eps
        out = torch.sqrt(ab_prev) * x0_pred + dir_xt
        return out if noise is None else out + sigma * noise

    # --------------------------------------------------------------- sampling
    def _cfg_eps(self, eps_model: EpsModelFn, xt: torch.Tensor, t_vec: torch.Tensor,
                 y_in: torch.Tensor, cfg_scale: float, use_cfg: bool) -> torch.Tensor:
        """One noise prediction, with CFG fused as a single 2B-batch forward."""
        if use_cfg:
            x_in = torch.cat([xt, xt], dim=0)
            t_in = torch.cat([t_vec, t_vec], dim=0)
            eps_cond, eps_uncond = eps_model(x_in, t_in, y_in).chunk(2, dim=0)
            return eps_uncond + cfg_scale * (
                eps_cond.to(torch.float32) - eps_uncond.to(torch.float32)
            )
        return eps_model(xt, t_vec, y_in)

    def _step(self, eps_model: EpsModelFn, method: _Method, tables: Sequence[torch.Tensor],
              carry: Sequence[torch.Tensor], i: Union[int, torch.Tensor],
              z: Optional[torch.Tensor], y_in: torch.Tensor, cfg_scale: float,
              use_cfg: bool) -> Tuple[torch.Tensor, ...]:
        """Step ``i`` of a sampler: its row of ``tables``, one (CFG) noise
        prediction, the method's update of the carry.  Everything it reads
        is a device tensor, but ``i`` in the eager loop."""
        xt = carry[0]
        b = xt.shape[0]
        rows = [_row(tab, i) for tab in tables]
        t_vec = rows[0].expand(b)
        eps = self._cfg_eps(eps_model, xt, t_vec, y_in, cfg_scale, use_cfg)
        if method.name == "ddpm":
            return (self.p_sample(xt, t_vec, eps, z),)
        if method.name == "ddim":
            return (self.ddim_step(xt, t_vec, rows[1].expand(b), eps, z, method.eta),)
        # DPM-Solver++(2M): the data prediction, extrapolated by the previous one
        _, c_x, c_d, c2 = rows
        ab_t = self.schedule.alpha_bars.index_select(0, rows[0].reshape(1))
        x0 = (xt - torch.sqrt(1.0 - ab_t) * eps.to(torch.float32)) * torch.rsqrt(ab_t)
        d = x0 + c2 * (x0 - carry[1])
        return (c_x * xt + c_d * d, x0)

    def _loop(self, eps_model: EpsModelFn, method: _Method, classes: torch.Tensor,
              image_shape: Tuple[int, int, int], cfg_scale: float,
              null_label: Optional[int], x_init: Optional[torch.Tensor],
              noise: Optional[NoiseFn], generator: Optional[torch.Generator],
              graph: Optional[bool]) -> torch.Tensor:
        """x_T, the CFG labels, then ``method``'s steps: eagerly or as a
        replayed graph."""
        b = classes.shape[0]
        device = classes.device
        shape = (b,) + tuple(image_shape)
        needs_noise = method.draws and noise is None
        if (x_init is None or needs_noise) and generator is None:
            raise ValueError("pass a generator, or both x_init and noise")
        xt = (torch.randn(shape, generator=generator, device=device) if x_init is None
              else x_init.to(device, torch.float32))

        use_cfg = cfg_scale is not None and cfg_scale > 0
        if use_cfg:
            if null_label is None:
                raise ValueError("null_label is required when cfg_scale > 0")
            y_in = torch.cat([classes, torch.full_like(classes, null_label)])
        else:
            y_in = classes

        self.last_capture_seconds = 0.0
        if graph is None and noise is not None:
            graph = False  # injected per-step noise: the eager loop unless asked by name
        if use_graphs(device, graph):
            return self._graph_for(eps_model, method, xt, y_in, cfg_scale, use_cfg).run(
                xt, y_in, noise, generator)

        carry = (xt,) + tuple(torch.zeros_like(xt) for _ in range(method.n_carry - 1))
        for i, t in enumerate(method.ts.tolist()):
            z = None
            if method.draws:
                z = (torch.randn(shape, generator=generator, device=device) if noise is None
                     else noise(t).to(device))
            carry = self._step(eps_model, method, method.tables, carry, i, z, y_in,
                               cfg_scale, use_cfg)
        return carry[0]

    def _graph_for(self, eps_model, method: _Method, xt, y_in, cfg_scale, use_cfg
                   ) -> "_SamplerGraph":
        """The captured step for this model, method, batch shape and guidance:
        kept from an earlier call unless the model's kernel weights have
        changed since, else captured now."""
        key = (id(eps_model), method.key, tuple(xt.shape), float(cfg_scale or 0.0), use_cfg)
        g = self._graphs.get(key)
        if g is None or g.stale():
            g = _SamplerGraph(self, eps_model, method, xt, y_in, cfg_scale, use_cfg)
            self._graphs.pop(key, None)
            self._graphs[key] = g
            while len(self._graphs) > MAX_SAMPLER_GRAPHS:
                self._graphs.pop(next(iter(self._graphs)))
            self.last_capture_seconds = g.graph.capture_seconds
        return g

    def sampler_graphs(self) -> list:
        """The captured sampler steps this process keeps, oldest first."""
        return list(self._graphs.values())

    def _table(self, values, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype,
                               device=self.schedule.betas.device)

    def _method(self, key: tuple, make: Callable[[], _Method]) -> _Method:
        """The method for ``key`` (a sampler's name and arguments), made by
        ``make`` at the first call and kept."""
        method = self._methods.get(key)
        if method is None:
            method = self._methods[key] = make()
        return method

    @torch.inference_mode()
    def sample(
        self,
        eps_model: EpsModelFn,
        classes: torch.Tensor,
        image_shape: Tuple[int, int, int],
        cfg_scale: float = 3.0,
        null_label: Optional[int] = None,
        x_init: Optional[torch.Tensor] = None,
        noise: Optional[NoiseFn] = None,
        generator: Optional[torch.Generator] = None,
        graph: Optional[bool] = None,
    ) -> torch.Tensor:
        """The full ancestral sampling loop (the north-star hot path).

        Args:
          eps_model: ``(x, t, y) -> eps``, e.g. the UNet.
          classes: int (B,) class labels on the sampling device.
          image_shape: (H, W, C) — NHWC without the batch dim.
          cfg_scale: classifier-free guidance scale; <= 0 disables the uncond
            pass (conditional sampling without guidance).
          null_label: label id that embeds to zero; required if cfg_scale > 0.
          x_init: x_T, (B, H, W, C) float32; drawn from ``generator`` if None.
          noise: t -> that step's N(0, I) draw; drawn from ``generator`` if None.
          generator: the source of whatever of x_T and noise is not given.
          graph: None: the replayed CUDA graph on a CUDA device unless
            ``noise`` is given, the eager loop otherwise; True / False ask
            for one by name.

        Returns:
          x_0 of shape (B, H, W, C), float32.
        """
        def make():
            ts = np.arange(self.n_steps - 1, -1, -1, dtype=np.int64)
            return _Method("ddpm", ts, (self._table(ts, torch.int64),), 1, True, ("ddpm",))

        return self._loop(eps_model, self._method(("ddpm",), make), classes, image_shape,
                          cfg_scale, null_label, x_init, noise, generator, graph)

    def ddim_timesteps(self, n_sample_steps: int) -> Tuple[np.ndarray, np.ndarray]:
        """DDIM's (t, t_prev) by step: an evenly spaced subsequence of the
        training timesteps, endpoints included, descending; the last
        ``t_prev`` is -1, "to x_0"."""
        n_sub = min(int(n_sample_steps), self.n_steps)
        sub = np.unique(np.linspace(0, self.n_steps - 1, n_sub).round().astype(np.int32))[::-1]
        return sub.astype(np.int64), np.append(sub[1:], -1).astype(np.int64)

    @torch.inference_mode()
    def sample_ddim(
        self,
        eps_model: EpsModelFn,
        classes: torch.Tensor,
        image_shape: Tuple[int, int, int],
        n_sample_steps: int = 50,
        eta: float = 0.0,
        cfg_scale: float = 3.0,
        null_label: Optional[int] = None,
        x_init: Optional[torch.Tensor] = None,
        noise: Optional[NoiseFn] = None,
        generator: Optional[torch.Generator] = None,
        graph: Optional[bool] = None,
    ) -> torch.Tensor:
        """Few-step DDIM sampling over :meth:`ddim_timesteps`, the same fused
        2B-CFG loop as :meth:`sample` at ``n_sample_steps / n_steps`` of its
        cost.  ``eta == 0`` (default) is the deterministic DDIM and draws
        nothing after x_T; ``eta == 1`` over the full subsequence has the
        ancestral sampler's stochasticity with the beta-tilde variance.  The
        other arguments are :meth:`sample`'s."""
        eta = float(eta)

        def make():
            ts, t_prevs = self.ddim_timesteps(n_sample_steps)
            tables = (self._table(ts, torch.int64), self._table(t_prevs, torch.int64))
            return _Method("ddim", ts, tables, 1, eta != 0.0, ("ddim", len(ts), eta), eta)

        method = self._method(("ddim", int(n_sample_steps), eta), make)
        return self._loop(eps_model, method, classes, image_shape, cfg_scale, null_label,
                          x_init, noise, generator, graph)

    # ----------------------------------------------------- DPM-Solver++ (2M)
    def _dpmpp_coeffs(self, n_sample_steps: int, order: int = 2):
        """Host-precomputed per-step scalars for the 2M multistep update.

        The timestep subsequence is uniform in ``lambda = log(alpha/sigma)``
        (the solver's natural variable, the DPM-Solver paper's recommended
        grid), snapped to the trained discrete timesteps.  All coefficients
        are finite even for the final "to x_0" step (``sigma_target == 0``):
        computed in float64 directly from the alpha/sigma ratios instead of
        through lambda, which would be +inf there.
        """
        ab = self.schedule.alpha_bars.cpu().numpy().astype(np.float64)
        n_sub = min(int(n_sample_steps), self.n_steps)
        lam_all = 0.5 * (np.log(ab) - np.log1p(-ab))
        targets = np.linspace(lam_all[-1], lam_all[0], n_sub)
        idx = np.abs(lam_all[:, None] - targets[None, :]).argmin(axis=0)
        sub = np.unique(idx.astype(np.int64))[::-1]  # descending: T-1 ... 0
        n = len(sub)

        alpha = np.sqrt(ab[sub])
        sigma = np.sqrt(1.0 - ab[sub])
        lam = np.log(alpha / sigma)
        # targets: sub[1:], then the analytic projection to x_0 (alpha = 1,
        # sigma = 0: lambda = +inf, handled by the ratio form below)
        a_t = np.append(alpha[1:], 1.0)
        s_t = np.append(sigma[1:], 0.0)
        c_x = s_t / sigma                       # sigma_t / sigma_s
        exp_mh = (s_t / sigma) * (alpha / a_t)  # e^{-h}; exactly 0 at the end
        c_d = a_t * (1.0 - exp_mh)              # -alpha_t * expm1(-h)
        # second-order extrapolation weight 1/(2 r_i), r_i = h_{i-1}/h_i: zero
        # on the first step (no previous model eval) and on the final "to x_0"
        # step (h = +inf; first order there IS the exact projection)
        c2 = np.zeros(n)
        if n >= 2 and order >= 2:
            h = np.append(lam[1:] - lam[:-1], np.inf)  # h_i for step i
            with np.errstate(divide="ignore"):
                r = h[:-1] / h[1:]
                c2[1:] = np.where(np.isfinite(r) & (r > 0), 0.5 / np.maximum(r, 1e-12), 0.0)
            c2[-1] = 0.0
        return sub.astype(np.int32), c_x, c_d, c2

    @torch.inference_mode()
    def sample_dpmpp(
        self,
        eps_model: EpsModelFn,
        classes: torch.Tensor,
        image_shape: Tuple[int, int, int],
        n_sample_steps: int = 15,
        cfg_scale: float = 3.0,
        null_label: Optional[int] = None,
        x_init: Optional[torch.Tensor] = None,
        order: int = 2,
        generator: Optional[torch.Generator] = None,
        graph: Optional[bool] = None,
    ) -> torch.Tensor:
        """DPM-Solver++(2M): second-order multistep few-step sampling (Lu et
        al. 2022, the data-prediction multistep variant), the same fused
        2B-CFG loop as :meth:`sample`.  Exponential-integrator form in the
        half-log-SNR variable ``lambda = log(alpha/sigma)``:

            x_t = (sigma_t/sigma_s) x_s - alpha_t (e^{-h} - 1) D,
            D   = x0_i + (1/(2 r_i)) (x0_i - x0_{i-1}),   r_i = h_{i-1}/h_i

        with D = x0_i on the first step and on the final projection to x_0.
        The carry is (x_t, the previous x0 prediction), the latter starting
        from zeros.  Deterministic: ``generator`` draws x_T only."""
        def make():
            sub, c_x, c_d, c2 = self._dpmpp_coeffs(n_sample_steps, order)
            tables = (self._table(sub, torch.int64),) + tuple(
                self._table(c, torch.float32) for c in (c_x, c_d, c2))
            return _Method("dpmpp", sub.astype(np.int64), tables, 2, False,
                           ("dpmpp", len(sub), int(order)))

        method = self._method(("dpmpp", int(n_sample_steps), int(order)), make)
        return self._loop(eps_model, method, classes, image_shape, cfg_scale, null_label,
                          x_init, None, generator, graph)


class _SamplerGraph:
    """One sampler step as a CUDA graph, with the buffers it reads and
    writes: x_t (and DPM-Solver++'s previous x0), the step's noise, the CFG
    labels, the method's tables and the step counter that picks their row.
    Captured for one (model, method, batch shape, cfg_scale, use_cfg): the
    guidance is baked in, as it is a static argument of the JAX package's
    jitted sampler."""

    def __init__(self, diffusion: GaussianDiffusion, eps_model, method: _Method,
                 xt: torch.Tensor, y_in: torch.Tensor, cfg_scale, use_cfg: bool):
        self.method = method
        self.eps_model = eps_model  # kept alive: the cache's key is its id
        self.carry = [torch.zeros_like(xt) for _ in range(method.n_carry)]
        self.z = torch.zeros_like(xt) if method.draws else None
        self.y = y_in.clone()
        self.i = torch.zeros((), dtype=torch.int64, device=xt.device)
        self.tables = [t.clone() for t in method.tables]

        def step():
            new = diffusion._step(eps_model, method, self.tables, self.carry, self.i, self.z,
                                  self.y, cfg_scale, use_cfg)
            for buf, val in zip(self.carry, new):
                buf.copy_(val)
            self.i += 1

        self.graph = StepGraph(step, xt.device, reset=self.i.zero_)
        # the model's kernel-layout weight copies that the capture read: held
        # here so their memory is not reused, and compared before a reuse
        state = getattr(eps_model, "kernel_weights_state", None)
        self._weights_state = state
        self._weights_key, self._held = state() if state is not None else (None, None)

    def stale(self) -> bool:
        """The model's attention weights changed since the capture: the
        copies the graph reads are old."""
        return self._weights_state is not None and self._weights_state()[0] != self._weights_key

    @torch.inference_mode()  # the buffers were made under it, by the sampler
    def device_ms(self, replays: int = 10) -> float:
        """The device's time for one replayed step, in ms, on the buffers as
        the last run left them (the step counter set back before each)."""
        return self.graph.device_ms(replays, before=self.i.zero_)

    def run(self, xt: torch.Tensor, y_in: torch.Tensor, noise: Optional[NoiseFn],
            generator: Optional[torch.Generator]) -> torch.Tensor:
        self.carry[0].copy_(xt)
        for extra in self.carry[1:]:
            extra.zero_()
        self.y.copy_(y_in)
        self.i.zero_()
        for t in self.method.ts.tolist():
            if self.z is not None:  # this step's draw, eagerly, into the fixed buffer
                if noise is None:
                    self.z.normal_(generator=generator)
                else:
                    self.z.copy_(noise(t))
            self.graph.replay()
        return self.carry[0].clone()
