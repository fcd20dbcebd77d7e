"""Training step for the IMAGDressing objective (port of
`imagdressing_tpu/train/step.py`: `split_params`, `make_optimizer`,
`init_train_state`, `make_loss_fn`, `make_train_step`).

Semantics of the reference implementation's `train.py`, as in the JAX
package:
  * trainable: the garment ("reference") UNet, its 16 RefS adapters
    (to_k_ref / to_v_ref) and the cloth Resampler; frozen, forward only: the
    main UNet, the VAE and both CLIP towers;
  * loss: MSE(eps_pred, eps) with optional min-SNR-gamma weighting, noise
    offset (per example and channel), uniform timesteps, the DDIM training
    schedule with zero-SNR rescale and trailing spacing;
  * AdamW (bf16 first moment) with global-norm clipping, constant-with-
    warmup learning rate, a non-finite-gradient skip, and gradient
    accumulation when asked.

Kernels on this path: the flash forward with residuals (K5) and both flash
backward kernels (K6a, K6b) at every UNet self-attention; the GN+SiLU+conv3x3
(K2) and GroupNorm (K3) kernels in the forwards, whose backwards recompute
their chains in PyTorch ops (as the JAX package's custom VJPs do); K1 at the
VAE encoder's mid attention, which runs without a gradient.

Differences from the JAX package, by design:
  * PyTorch runs eagerly: `make_train_step` returns a Python function that
    updates the trainable modules in place (JAX returns new arrays).
  * The random draws (VAE sampling eps x2, noise, noise offset, timesteps)
    come from one `torch.Generator` per example, seeded from (seed, step,
    global example index), so a batch's draws do not depend on how it is
    laid out; the bits differ from `jax.random`'s. `loss_from_draws` takes
    the draws as data, so tests feed both packages the same numbers.
  * The optimizer is a PyTorch reimplementation of the optax chain
    `apply_if_finite(chain(clip_by_global_norm, adamw), 100)` (wrapped in
    `MultiSteps` for accumulation), state as lists of tensors.
  * The multi-chip steps (`shard_train_step`, `tp_train_step`) are not
    ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from imagdressing_tpu_torch.core.config import SchedulerConfig, TrainConfig
from imagdressing_tpu_torch.models.conditioning import Conditioning
from imagdressing_tpu_torch.pipelines.dressing import (
    MODEL_NAMES,
    TRAINABLE_KEYS,
    DressingModels,
)
from imagdressing_tpu_torch.samplers import ddim

Modules = Dict[str, nn.Module]
Batch = Dict[str, torch.Tensor]


def split_params(models: DressingModels) -> Tuple[Modules, Modules]:
    """-> (trainable, frozen) {name: module}, the reference's requires_grad
    split (train.py:371-378), set on the modules."""
    mods = models.modules()
    trainable = {k: mods[k].requires_grad_(True) for k in TRAINABLE_KEYS}
    frozen = {k: mods[k].requires_grad_(False) for k in MODEL_NAMES
              if k not in TRAINABLE_KEYS}
    return trainable, frozen


def trainable_parameters(params: Modules) -> List[torch.Tensor]:
    """The trainable tensors in a fixed order: `TRAINABLE_KEYS`, then each
    module's `parameters()` order."""
    return [p for k in TRAINABLE_KEYS for p in params[k].parameters()]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32 (optax.global_norm;
    the per-tensor norms come from one multi-tensor launch)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One fp32 vector of every element, each tensor in its logical order."""
    return torch.cat([t.float().reshape(-1) for t in tensors])


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OptState:
    """State of `Optimizer`: the AdamW moments (flat over every trainable
    element, in `trainable_parameters` order) and step count, the non-finite
    guard's counters, and the accumulation buffer."""

    count: int                 # inner (clip + AdamW) updates applied
    mu: torch.Tensor           # first moment, flat, in `mu_dtype`
    nu: torch.Tensor           # second moment, flat, fp32
    notfinite_count: int = 0
    last_finite: bool = True
    total_notfinite: int = 0
    mini_step: int = 0         # accumulation
    gradient_step: int = 0
    acc_grads: Optional[torch.Tensor] = None


class Optimizer:
    """The JAX package's `make_optimizer` chain in PyTorch, with optax's
    arithmetic:

      apply_if_finite(chain(clip_by_global_norm(max_grad_norm),
                            adamw(lr(count), b1, b2, eps, weight_decay,
                                  mu_dtype=bf16)),
                      max_consecutive_errors=100)
      [MultiSteps(..., gradient_accumulation_steps) when that is > 1]

    with lr(count) linear from 0 over `warmup_steps`, then constant (so the
    first update is a no-op). A non-finite gradient leaves the moments and
    the count as they were and yields zero updates, unless more than
    `max_consecutive_errors` came in a row. One deliberate difference: with
    accumulation, the buffer restarts from zeros after every emitted update
    (optax.MultiSteps multiplies it by 0, which keeps a NaN, so after one
    non-finite micro-batch the optax chain skips every later update).

    The state is flat: every update is a handful of launches per chunk of
    one vector, not a handful per parameter tensor (about a thousand tensors
    at full width), which would leave the card waiting on the host. The
    moments are updated in place, a chunk at a time, so that the update's
    temporaries stay a few chunks large."""

    mu_dtype = torch.bfloat16  # halves the first moment's memory
    max_consecutive_errors = 100
    chunk = 1 << 26  # elements per step of the AdamW arithmetic

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg

    def learning_rate(self, count: int) -> float:
        """optax join_schedules([linear_schedule(0, lr, warmup),
        constant_schedule(lr)], [warmup]) at `count`, in fp32."""
        lr, warm = np.float32(self.cfg.learning_rate), self.cfg.warmup_steps
        if warm <= 0 or count >= warm:
            return float(lr)
        frac = np.float32(1.0) - np.float32(count) / np.float32(warm)
        return float((np.float32(0.0) - lr) * frac + lr)

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        n = sum(p.numel() for p in params)
        dev = params[0].device
        acc = None
        if self.cfg.gradient_accumulation_steps > 1:
            acc = torch.zeros(n, device=dev)
        return OptState(count=0,
                        mu=torch.zeros(n, dtype=self.mu_dtype, device=dev),
                        nu=torch.zeros(n, device=dev), acc_grads=acc)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]
               ) -> Tuple[List[torch.Tensor], OptState]:
        """-> (updates to add to the params, each shaped like its param;
        new state)."""
        g = _flat(grads)
        k = self.cfg.gradient_accumulation_steps
        if k <= 1:
            u, state = self._if_finite(g, state, params)
        else:
            n = state.mini_step
            acc = state.acc_grads + (g - state.acc_grads) / (n + 1)
            if n != k - 1:
                u = torch.zeros_like(g)
                state = dataclasses.replace(state, mini_step=n + 1,
                                            acc_grads=acc)
            else:
                u, new = self._if_finite(acc, state, params)
                state = dataclasses.replace(
                    new, mini_step=0, gradient_step=state.gradient_step + 1,
                    acc_grads=torch.zeros_like(acc))
        parts = u.split([p.numel() for p in params])
        return [x.view(p.shape) for x, p in zip(parts, params)], state

    def _if_finite(self, g: torch.Tensor, state: OptState, params):
        finite = bool(torch.isfinite(g).all())
        notfinite = 0 if finite else state.notfinite_count + 1
        if finite or notfinite > self.max_consecutive_errors:
            u, state = self._clip_adamw(g, state, _flat(params))
        else:
            u = torch.zeros_like(g)
        return u, dataclasses.replace(
            state, notfinite_count=notfinite, last_finite=finite,
            total_notfinite=state.total_notfinite + (not finite))

    def _clip_adamw(self, g: torch.Tensor, state: OptState, p: torch.Tensor):
        cfg = self.cfg
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        g_norm = torch.linalg.vector_norm(g)
        if not bool(g_norm < cfg.max_grad_norm):
            g.div_(g_norm).mul_(cfg.max_grad_norm)
        count = state.count + 1
        # as optax under XLA: decay**count in fp32; the stored (mu_dtype)
        # moment is multiplied by the decay rounded to that dtype (0.9 ->
        # 0.8984375 in bf16), the product kept in fp32
        bc1 = float(np.float32(1.0) - np.power(np.float32(b1), count,
                                               dtype=np.float32))
        bc2 = float(np.float32(1.0) - np.power(np.float32(b2), count,
                                               dtype=np.float32))
        b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
        neg_lr = -self.learning_rate(state.count)
        u = torch.empty_like(g)
        for a in range(0, g.numel(), self.chunk):
            part = slice(a, a + self.chunk)
            gc = g[part]
            mu = (1 - b1) * gc + b1_mu * state.mu[part].float()
            nu = (1 - b2) * (gc * gc) + b2 * state.nu[part]
            uc = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_eps)
            uc = uc + cfg.weight_decay * p[part]
            u[part] = neg_lr * uc
            state.mu[part] = mu.to(self.mu_dtype)
            state.nu[part] = nu
        return u, dataclasses.replace(state, count=count)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """AdamW + global-norm clip + constant-with-warmup LR + non-finite skip
    (run.sh lr 5e-5, warmup 2000; zero_stage2_config grad_clip 1.0)."""
    return Optimizer(cfg)


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> None:
    """params += updates, in place."""
    torch._foreach_add_(list(params), list(updates))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Draws:
    """The random numbers of one step, per example (leading dim B):
    standard-normal eps of the person and the garment latents' VAE sampling
    (B, h, w, 4), the noise (B, h, w, 4) and its offset (B, 1, 1, 4), all
    fp32, and integer timesteps t (B,)."""

    eps_latents: torch.Tensor
    eps_cloth: torch.Tensor
    noise: torch.Tensor
    noise_offset: torch.Tensor
    timesteps: torch.Tensor


def _example_seed(seed: int, step: int, index: int) -> int:
    state = np.random.SeedSequence([seed, step, index]).generate_state(
        1, np.uint64)[0]
    return int(state) & 0x7FFF_FFFF_FFFF_FFFF


def make_draws(seed: int, step: int, ids: Sequence[int],
               latent_shape: Tuple[int, int, int], num_train_timesteps: int,
               device) -> Draws:
    """Draws of the examples with global indices `ids` at `step`: one
    `torch.Generator(device)` per example, seeded from (seed, step, index),
    so an example's numbers do not depend on the batch it sits in."""
    h, w, c = latent_shape
    fields = {f.name: [] for f in dataclasses.fields(Draws)}
    for i in ids:
        gen = torch.Generator(device=device).manual_seed(
            _example_seed(seed, step, int(i)))

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=device)

        fields["eps_latents"].append(normal(h, w, c))
        fields["eps_cloth"].append(normal(h, w, c))
        fields["noise"].append(normal(h, w, c))
        fields["noise_offset"].append(normal(1, 1, c))
        fields["timesteps"].append(torch.randint(
            0, num_train_timesteps, (), generator=gen, device=device))
    return Draws(**{k: torch.stack(v) for k, v in fields.items()})


def _cast_call(module: nn.Module, dtype: torch.dtype, *args, **kwargs):
    """module(*args) with its parameters cast to `dtype`: a differentiable
    working copy, so the gradients land on the fp32 masters."""
    params = dict(module.named_parameters())
    if all(p.dtype == dtype for p in params.values()):
        return module(*args, **kwargs)
    work = {n: p.to(dtype) for n, p in params.items()}
    return torch.func.functional_call(module, work, args, kwargs)


def make_loss_fn(models: DressingModels, cfg: TrainConfig,
                 sched_cfg: Optional[SchedulerConfig] = None) -> Callable:
    """loss_from_draws(trainable, frozen, batch, draws) -> scalar loss.

    batch (leading dim = local batch B), tensors on the models' device:
      person_image (B, H, W, 3) in [-1, 1]
      cloth_image  (B, H, W, 3) in [-1, 1]
      cloth_clip   (B, 224, 224, 3) CLIP-normalized
      text_ids     (B, 77) integer ids
    The computation dtype is the frozen main UNet's; the trainable modules
    (fp32 masters) are cast to it inside. The frozen encoders run without a
    gradient. The main UNet recomputes its blocks in the backward unless
    `cfg.remat_policy` is "none"; it is frozen, so its recompute reads its own
    parameters, never the cast copies."""
    schedule = ddim.make_schedule(sched_cfg or ddim.TRAIN_SCHEDULER)
    sf = models.vae_cfg.scaling_factor

    def loss_from_draws(trainable: Modules, frozen: Modules, batch: Batch,
                        draws: Draws) -> torch.Tensor:
        cd = frozen["unet"].conv_in.weight.dtype
        with torch.no_grad():
            vae = frozen["vae"]
            latents = vae.encode_sample(batch["person_image"].to(cd),
                                        draws.eps_latents) * sf
            cloth_latents = vae.encode_sample(batch["cloth_image"].to(cd),
                                              draws.eps_cloth) * sf
            text_embeds = frozen["text"](batch["text_ids"])
            clip_hidden = frozen["vision"](batch["cloth_clip"].to(cd),
                                           penultimate=True)

        noise = draws.noise.float()
        if cfg.noise_offset > 0:
            noise = noise + cfg.noise_offset * draws.noise_offset.float()
        t = draws.timesteps
        noisy = ddim.add_noise(schedule, latents.float(), noise, t)
        b = noisy.shape[0]

        cloth_tokens = _cast_call(trainable["resampler"], cd, clip_hidden)
        _, captured = _cast_call(
            trainable["ref_unet"], cd, cloth_latents,
            torch.zeros((b,), dtype=torch.long, device=noisy.device),
            cloth_tokens, capture=True)
        ref_kv = _cast_call(trainable["ref_adapters"], cd, captured)
        eps_pred = frozen["unet"](
            noisy.to(cd), t, text_embeds.to(cd),
            Conditioning(ref_kv=ref_kv, ref_scale=1.0),
            remat=cfg.remat_policy != "none",
            remat_policy=cfg.remat_policy).float()

        se = ((eps_pred - noise) ** 2).mean(dim=(1, 2, 3))
        if cfg.snr_gamma is not None:
            snr = ddim.compute_snr(schedule, t)
            se = se * (torch.clamp(snr, max=cfg.snr_gamma)
                       / torch.clamp(snr, min=1e-8))
        return se.mean()

    return loss_from_draws


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    step: int
    params: Modules  # trainable: {ref_unet, ref_adapters, resampler}
    opt_state: OptState


def init_train_state(models: DressingModels, cfg: TrainConfig
                     ) -> Tuple[TrainState, Modules, Optimizer]:
    """-> (state, frozen modules, optimizer). Call
    `models.cast_for_training(dtype)` first for mixed precision."""
    trainable, frozen = split_params(models)
    tx = make_optimizer(cfg)
    state = TrainState(step=0, params=trainable,
                       opt_state=tx.init(trainable_parameters(trainable)))
    return state, frozen, tx


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy that is complete when this returns (a copy from the card
    waits for it)."""
    return t.detach().to("cpu", copy=True)


def state_to_host(state: TrainState) -> Dict[str, Any]:
    """The state as CPU tensors and Python numbers, copied (the trainer
    updates its modules in place): {"step", "params": {name: state dict of
    the fp32 masters}, "opt_state": {OptState field: value}}. The form
    `train.checkpoint` writes."""
    params = {k: {n: _host_copy(t)
                  for n, t in state.params[k].state_dict().items()}
              for k in TRAINABLE_KEYS}
    opt = {f.name: getattr(state.opt_state, f.name)
           for f in dataclasses.fields(OptState)}
    opt = {k: _host_copy(v) if torch.is_tensor(v) else v
           for k, v in opt.items()}
    return {"step": int(state.step), "params": params, "opt_state": opt}


@torch.no_grad()
def state_from_host(template: TrainState, host: Dict[str, Any]
                    ) -> TrainState:
    """`state_to_host`'s form loaded into the template's modules (in place,
    exact) and onto its optimizer state's device; the template's tensors
    fix each shape and dtype."""
    for k in TRAINABLE_KEYS:
        template.params[k].load_state_dict(host["params"][k], strict=True)
    opt = {}
    for f in dataclasses.fields(OptState):
        want, got = getattr(template.opt_state, f.name), \
            host["opt_state"][f.name]
        if torch.is_tensor(want) or torch.is_tensor(got):
            if not (torch.is_tensor(want) and torch.is_tensor(got)) \
                    or want.shape != got.shape or want.dtype != got.dtype:
                raise ValueError(
                    f"checkpoint opt_state.{f.name}: "
                    f"{getattr(got, 'shape', got)} "
                    f"{getattr(got, 'dtype', '')}, the trainer has "
                    f"{getattr(want, 'shape', want)} "
                    f"{getattr(want, 'dtype', '')}")
            got = got.to(want.device, copy=True)
        opt[f.name] = got
    return TrainState(step=int(host["step"]), params=template.params,
                      opt_state=OptState(**opt))


def make_train_step(models: DressingModels, cfg: TrainConfig, tx: Optimizer,
                    sched_cfg: Optional[SchedulerConfig] = None) -> Callable:
    """train_step(state, frozen, batch, seed, draws=None) -> (state,
    {"loss", "grad_norm"}), single device. The draws are made from
    (seed, state.step, example index) unless given. The trainable modules
    are updated in place; `grad_norm` is that of the raw gradients."""
    loss_from_draws = make_loss_fn(models, cfg, sched_cfg)
    f = 2 ** (len(models.vae_cfg.block_out_channels) - 1)
    num_t = (sched_cfg or ddim.TRAIN_SCHEDULER).num_train_timesteps

    def train_step(state: TrainState, frozen: Modules, batch: Batch,
                   seed: int, draws: Optional[Draws] = None):
        b, h, w, _ = batch["person_image"].shape
        if draws is None:
            draws = make_draws(seed, state.step, range(b),
                               (h // f, w // f,
                                models.vae_cfg.latent_channels),
                               num_t, batch["person_image"].device)
        params = trainable_parameters(state.params)
        loss = loss_from_draws(state.params, frozen, batch, draws)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # leaves the loss does not reach (the garment UNet's output head)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        gnorm = global_norm(grads)
        updates, opt_state = tx.update(grads, state.opt_state, params)
        apply_updates(params, updates)
        return (TrainState(step=state.step + 1, params=state.params,
                           opt_state=opt_state),
                {"loss": loss.detach(), "grad_norm": gnorm})

    return train_step
