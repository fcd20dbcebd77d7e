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
  * The multi-device steps run one process per rank over
    `torch.distributed` (`core/mesh.py`): `shard_train_step` (ZeRO-2 over
    the data group) and `tp_train_step` (tensor parallelism over the model
    group, `core/tp.py`, with data parallelism beside it).

ZeRO-2 splits the port's flat optimizer state: rank r of the data group
owns the r-th contiguous 1/N of the flat vector (padded to a multiple of N)
of the moments, the accumulation buffer and the fp32 masters' update. The
JAX package splits each leaf along its largest divisible dimension
(`core/mesh.py:zero2_axis`) instead. AdamW works element by element, so both
layouts compute the same update; only the order of the global norm's sum
differs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from imagdressing_tpu_torch.core import mesh as mesh_lib
from imagdressing_tpu_torch.core import tp as tp_lib
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
        u, state = self.update_flat(_flat(grads), state,
                                    lambda: _flat(params))
        parts = u.split([p.numel() for p in params])
        return [x.view(p.shape) for x, p in zip(parts, params)], state

    @torch.no_grad()
    def update_flat(self, g: torch.Tensor, state: OptState, params, *,
                    clip: bool = True,
                    norm: Optional[Callable[[torch.Tensor], torch.Tensor]]
                    = None) -> Tuple[torch.Tensor, OptState]:
        """`update` on flat vectors: g the gradient, params the fp32
        masters (or a function that returns them, called only when an
        update is applied) -> (flat update, new state). `clip=False` when
        the caller clipped g already. `norm(x)`, where given, is the global
        norm of a vector laid out as g (over every rank's part); it then
        decides the clip and, by its finiteness, the non-finite skip, so
        that every rank decides alike."""
        k = self.cfg.gradient_accumulation_steps
        if k <= 1:
            return self._if_finite(g, state, params, clip, norm)
        n = state.mini_step
        acc = state.acc_grads + (g - state.acc_grads) / (n + 1)
        if n != k - 1:
            return torch.zeros_like(g), dataclasses.replace(
                state, mini_step=n + 1, acc_grads=acc)
        u, new = self._if_finite(acc, state, params, clip, norm)
        return u, dataclasses.replace(
            new, mini_step=0, gradient_step=state.gradient_step + 1,
            acc_grads=torch.zeros_like(acc))

    def _if_finite(self, g: torch.Tensor, state: OptState, params, clip,
                   norm):
        g_norm = None if norm is None else norm(g)
        finite = bool(torch.isfinite(g).all() if g_norm is None
                      else torch.isfinite(g_norm))
        notfinite = 0 if finite else state.notfinite_count + 1
        if finite or notfinite > self.max_consecutive_errors:
            if clip:
                g_norm = torch.linalg.vector_norm(g) if g_norm is None \
                    else g_norm
                if not bool(g_norm < self.cfg.max_grad_norm):
                    g.div_(g_norm).mul_(self.cfg.max_grad_norm)
            u, state = self._adamw(g, state,
                                   params() if callable(params) else params)
        else:
            u = torch.zeros_like(g)
        return u, dataclasses.replace(
            state, notfinite_count=notfinite, last_finite=finite,
            total_notfinite=state.total_notfinite + (not finite))

    def _adamw(self, g: torch.Tensor, state: OptState, p: torch.Tensor):
        cfg = self.cfg
        b1, b2 = cfg.adam_b1, cfg.adam_b2
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
    # how params and opt_state are split over ranks (`ZeroLayout`,
    # `TPLayout`); None: whole, on one device
    layout: Optional[Any] = None


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


OPT_TENSORS = ("mu", "nu", "acc_grads")


def _map_opt(opt: OptState, fn: Callable[[torch.Tensor], torch.Tensor]
             ) -> OptState:
    """The state with fn applied to its flat vectors."""
    return dataclasses.replace(opt, **{
        f: fn(getattr(opt, f)) for f in OPT_TENSORS
        if getattr(opt, f) is not None})


def state_to_host(state: TrainState) -> Dict[str, Any]:
    """The state as CPU tensors and Python numbers, copied (the trainer
    updates its modules in place): {"step", "params": {name: state dict of
    the fp32 masters}, "opt_state": {OptState field: value}}. The form
    `train.checkpoint` writes. The same whatever the layout: a split state
    is gathered first (a collective: every rank calls it)."""
    lay = state.layout
    if lay is None:
        params = {k: state.params[k].state_dict() for k in TRAINABLE_KEYS}
        opt = state.opt_state
    else:
        params = lay.host_params(state.params)
        opt = _map_opt(state.opt_state, lay.host_flat)
    params = {k: {n: _host_copy(t) for n, t in sd.items()}
              for k, sd in params.items()}
    opt = {f.name: getattr(opt, f.name) for f in dataclasses.fields(OptState)}
    opt = {k: _host_copy(v) if torch.is_tensor(v) else v
           for k, v in opt.items()}
    return {"step": int(state.step), "params": params, "opt_state": opt}


@torch.no_grad()
def state_from_host(template: TrainState, host: Dict[str, Any]
                    ) -> TrainState:
    """`state_to_host`'s form loaded into the template's modules (in place,
    exact) and onto its optimizer state's device; the template's tensors
    fix each shape and dtype. A split template takes its rank's part (no
    collective: each rank reads the whole form)."""
    lay = template.layout
    for k in TRAINABLE_KEYS:
        sd = host["params"][k]
        if lay is not None:
            sd = lay.local_state_dict(k, sd)
        template.params[k].load_state_dict(sd, strict=True)
    opt = {}
    for f in dataclasses.fields(OptState):
        want, got = getattr(template.opt_state, f.name), \
            host["opt_state"][f.name]
        if lay is not None and torch.is_tensor(got) \
                and f.name in OPT_TENSORS:
            got = lay.local_flat(got)
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
                      opt_state=OptState(**opt), layout=lay)


def _draws_fn(models: DressingModels, sched_cfg: Optional[SchedulerConfig]
              ) -> Callable:
    """draws(seed, step, ids, batch): `make_draws` at the batch's latent
    size, on its device."""
    f = 2 ** (len(models.vae_cfg.block_out_channels) - 1)
    num_t = (sched_cfg or ddim.TRAIN_SCHEDULER).num_train_timesteps

    def draws(seed: int, step: int, ids: Sequence[int], batch: Batch):
        _, h, w, _ = batch["person_image"].shape
        return make_draws(seed, step, ids,
                          (h // f, w // f, models.vae_cfg.latent_channels),
                          num_t, batch["person_image"].device)

    return draws


def _grads(loss: torch.Tensor, params: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    grads = torch.autograd.grad(loss, list(params), allow_unused=True)
    # leaves the loss does not reach (the garment UNet's output head)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


def make_train_step(models: DressingModels, cfg: TrainConfig, tx: Optimizer,
                    sched_cfg: Optional[SchedulerConfig] = None) -> Callable:
    """train_step(state, frozen, batch, seed, draws=None) -> (state,
    {"loss", "grad_norm"}), single device. The draws are made from
    (seed, state.step, example index) unless given. The trainable modules
    are updated in place; `grad_norm` is that of the raw gradients."""
    loss_from_draws = make_loss_fn(models, cfg, sched_cfg)
    draws_fn = _draws_fn(models, sched_cfg)

    def train_step(state: TrainState, frozen: Modules, batch: Batch,
                   seed: int, draws: Optional[Draws] = None):
        if draws is None:
            draws = draws_fn(seed, state.step,
                             range(batch["person_image"].shape[0]), batch)
        params = trainable_parameters(state.params)
        loss = loss_from_draws(state.params, frozen, batch, draws)
        grads = _grads(loss, params)
        gnorm = global_norm(grads)
        updates, opt_state = tx.update(grads, state.opt_state, params)
        apply_updates(params, updates)
        return (TrainState(step=state.step + 1, params=state.params,
                           opt_state=opt_state),
                {"loss": loss.detach(), "grad_norm": gnorm})

    return train_step


# ---------------------------------------------------------------------------
# Multi-device steps
# ---------------------------------------------------------------------------


class ZeroLayout:
    """ZeRO-2 over the data group: the trainables replicated; of each flat
    optimizer vector (n elements, padded with zeros to N * shard) rank r
    holds elements [r * shard, (r + 1) * shard)."""

    def __init__(self, n: int, mesh: mesh_lib.Mesh):
        self.n, self.world, self.rank = n, mesh.data, mesh.data_rank
        self.group = mesh.data_group
        self.shard = -(-n // self.world)
        self.lo = min(self.rank * self.shard, n)
        self.hi = min(self.lo + self.shard, n)

    def pad(self, flat: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(flat,
                                       (0, self.world * self.shard - self.n))

    def local_flat(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole flat vector (a copy)."""
        if full.numel() != self.n:
            raise ValueError(f"a flat vector of {full.numel()} elements, "
                             f"the trainables have {self.n}")
        part = full.reshape(-1)[self.lo:self.hi]
        out = part.new_zeros(self.shard)
        out[:part.numel()] = part
        return out

    def local_slice(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """Elements [lo, hi) of the tensors' flat fp32 concatenation,
        padded to `shard`, without building the whole vector."""
        out, at = [], 0
        for t in tensors:
            a, b = max(self.lo - at, 0), min(self.hi - at, t.numel())
            if a < b:
                out.append(t.detach().reshape(-1)[a:b].float())
            at += t.numel()
        flat = torch.cat(out) if out else tensors[0].new_zeros(0).float()
        return torch.nn.functional.pad(flat, (0, self.shard - flat.numel()))

    def host_flat(self, local: torch.Tensor) -> torch.Tensor:
        return mesh_lib.all_gather(local, self.group)[:self.n]

    def host_params(self, params: Modules) -> Dict[str, Dict[str, Any]]:
        return {k: params[k].state_dict() for k in TRAINABLE_KEYS}

    def local_state_dict(self, model: str, sd: Dict[str, torch.Tensor]):
        return sd


class TPLayout:
    """Tensor parallelism over the model group (`core/tp.py`): the split
    projections hold this rank's slice, and so do their moments. The local
    flat vectors hold the replicated parameters first, then this rank's
    slices, each in `trainable_parameters` order; whole vectors (the host
    form) are in `trainable_parameters` order of the whole parameters."""

    def __init__(self, params: Modules, mesh: mesh_lib.Mesh):
        """`params`: the trainables before the split."""
        self.rank, self.size = mesh.model_rank, mesh.model
        self.group = mesh.model_group
        # (model, name, whole shape, split kind), `trainable_parameters`
        # order
        self.entries = [
            (k, name, tuple(p.shape),
             tp_lib.tp_kind(name) if k in tp_lib.TP_MODELS else None)
            for k in TRAINABLE_KEYS
            for name, p in params[k].named_parameters()]
        self.order = ([i for i, e in enumerate(self.entries) if e[3] is None]
                      + [i for i, e in enumerate(self.entries)
                         if e[3] is not None])
        self.n = sum(int(np.prod(e[2])) for e in self.entries)
        self.n_replicated = sum(int(np.prod(e[2])) for e in self.entries
                                if e[3] is None)
        self.n_replicated_params = sum(e[3] is None for e in self.entries)

    def _local_numel(self, entry) -> int:
        n = int(np.prod(entry[2]))
        return n if entry[3] is None else n // self.size

    def local_params(self, params: Modules) -> List[torch.Tensor]:
        named = {(k, n): p for k in TRAINABLE_KEYS
                 for n, p in params[k].named_parameters()}
        return [named[self.entries[i][:2]] for i in self.order]

    def host_params(self, params: Modules) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for k in TRAINABLE_KEYS:
            out[k] = {}
            for name, t in params[k].state_dict().items():
                kind = tp_lib.tp_kind(name) if k in tp_lib.TP_MODELS \
                    else None
                out[k][name] = tp_lib.gather_tensor(kind, t, self.group)
        return out

    def local_state_dict(self, model: str, sd: Dict[str, torch.Tensor]):
        if model not in tp_lib.TP_MODELS:
            return sd
        return {n: tp_lib.shard_tensor(tp_lib.tp_kind(n), t, self.rank,
                                       self.size).contiguous()
                for n, t in sd.items()}

    def host_flat(self, local: torch.Tensor) -> torch.Tensor:
        parts = local.split([self._local_numel(self.entries[i])
                             for i in self.order])
        whole: List[Optional[torch.Tensor]] = [None] * len(self.entries)
        for i, part in zip(self.order, parts):
            _, _, shape, kind = self.entries[i]
            local_shape = tp_lib.shard_tensor(
                kind, torch.empty(shape, device="meta"), self.rank,
                self.size).shape
            whole[i] = tp_lib.gather_tensor(
                kind, part.view(local_shape), self.group).reshape(-1)
        return torch.cat(whole)

    def local_flat(self, full: torch.Tensor) -> torch.Tensor:
        if full.numel() != self.n:
            raise ValueError(f"a flat vector of {full.numel()} elements, "
                             f"the trainables have {self.n}")
        parts = full.reshape(-1).split([int(np.prod(e[2]))
                                        for e in self.entries])
        return torch.cat([
            tp_lib.shard_tensor(self.entries[i][3],
                                parts[i].view(self.entries[i][2]),
                                self.rank, self.size).reshape(-1)
            for i in self.order])


def shard_train_step(models: DressingModels, cfg: TrainConfig,
                     tx: Optimizer, mesh: mesh_lib.Mesh, state: TrainState,
                     frozen: Modules,
                     sched_cfg: Optional[SchedulerConfig] = None):
    """ZeRO-2 over the mesh's data group (the reference's DeepSpeed
    zero_stage2_config.json:12-20), with its communication made explicit
    as in the JAX package's `shard_train_step`:

      1. each rank computes the gradients of its rows (trainables
         replicated); an example's draws come from its global index
         (data rank * local batch + i), so the global batch draws what one
         device would;
      2. the flat gradient is reduce-scattered as a mean: each rank keeps
         its 1/N;
      3. the global norm is sqrt of the sum over ranks of each shard's sum
         of squares, the loss is averaged over the group;
      4. a non-finite norm skips the step on every rank: the trainables and
         the optimizer state stay as they were (the step count advances);
      5. otherwise the shard is clipped by the global norm and AdamW updates
         this rank's shard of the fp32 masters, mu and nu (the optimizer's
         own clip is off: it would see one shard only);
      6. the updated masters are all-gathered into every rank's modules.

    `state` is the whole state of `init_train_state` (or one restored);
    returns (step, sharded_state, frozen): step(state, frozen, batch, seed,
    draws=None) takes this rank's rows of the global batch (and their
    draws) and returns (state, {"loss", "grad_norm"}), both global. Every
    rank of the group must call it, in the same order."""
    if mesh.model != 1:
        raise ValueError("shard_train_step splits the data only; "
                         "tp_train_step splits the model")
    layout = ZeroLayout(
        sum(p.numel() for p in trainable_parameters(state.params)), mesh)
    sharded = TrainState(step=state.step, params=state.params,
                         opt_state=_map_opt(state.opt_state,
                                            layout.local_flat),
                         layout=layout)
    loss_from_draws = make_loss_fn(models, cfg, sched_cfg)
    draws_fn = _draws_fn(models, sched_cfg)
    group = mesh.data_group

    def step(state: TrainState, frozen: Modules, batch: Batch, seed: int,
             draws: Optional[Draws] = None):
        b = batch["person_image"].shape[0]
        if draws is None:
            lo = mesh.data_rank * b
            draws = draws_fn(seed, state.step, range(lo, lo + b), batch)
        params = trainable_parameters(state.params)
        loss = loss_from_draws(state.params, frozen, batch, draws)
        grads = _grads(loss, params)
        with torch.no_grad():
            g = mesh_lib.reduce_scatter(layout.pad(_flat(grads)), group)
            del grads
            g.div_(mesh.data)
            gnorm = torch.sqrt(mesh_lib.psum(torch.sum(g * g), group))
            metrics = {"loss": mesh_lib.pmean(loss.detach(), group),
                       "grad_norm": gnorm}
            after = dataclasses.replace(state, step=state.step + 1)
            if not bool(torch.isfinite(gnorm)):
                return after, metrics
            if not bool(gnorm < cfg.max_grad_norm):
                g.div_(gnorm).mul_(cfg.max_grad_norm)
            masters = layout.local_slice(params)
            u, opt_state = tx.update_flat(g, state.opt_state, masters,
                                          clip=False)
            whole = layout.host_flat(masters + u)
            torch._foreach_copy_(params, [
                x.view_as(p) for x, p in zip(
                    whole.split([p.numel() for p in params]), params)])
        return dataclasses.replace(after, opt_state=opt_state), metrics

    return step, sharded, frozen


def tp_train_step(models: DressingModels, cfg: TrainConfig, tx: Optimizer,
                  mesh: mesh_lib.Mesh, state: TrainState, frozen: Modules,
                  sched_cfg: Optional[SchedulerConfig] = None):
    """Tensor-parallel (+ data-parallel) training over a (data, model)
    mesh, as the JAX package's `tp_train_step`: both UNets (and the garment
    adapters) split by `core/tp.py` over the model group, in place, the
    batch split over the data group. The moments split like their
    parameters. The split leaves' gradients are averaged over the data
    group; the replicated leaves' over every rank (the model group's
    copies are equal), so they stay equal everywhere. The global norm sums
    the split leaves' squares over the model group; the clip and the
    non-finite skip act on it, with the single-device step's semantics
    (the skip counts, as optax's `apply_if_finite`). Each rank's kernels
    run its heads (the JAX package falls back to XLA's flash backward
    under TP; the port keeps K5 / K6a / K6b).

    `state` is the whole state of `init_train_state`; returns (step,
    sharded_state, frozen) as `shard_train_step`."""
    layout = TPLayout(state.params, mesh)
    opt_state = _map_opt(state.opt_state, layout.local_flat)
    for module in (state.params["ref_unet"], state.params["ref_adapters"],
                   frozen["unet"]):
        tp_lib.split_module(module, mesh.model_rank, mesh.model,
                            mesh.model_group)
    if models.unet_cfg.attention_num_heads % mesh.model:
        raise ValueError(f"{models.unet_cfg.attention_num_heads} heads do "
                         f"not split {mesh.model} ways")
    sharded = TrainState(step=state.step, params=state.params,
                         opt_state=opt_state, layout=layout)
    loss_from_draws = make_loss_fn(models, cfg, sched_cfg)
    draws_fn = _draws_fn(models, sched_cfg)
    n_rep, k_rep = layout.n_replicated, layout.n_replicated_params

    def norm(x: torch.Tensor) -> torch.Tensor:
        rep, split = x[:n_rep], x[n_rep:]
        return torch.sqrt(torch.sum(rep * rep) + mesh_lib.psum(
            torch.sum(split * split), mesh.model_group))

    def step(state: TrainState, frozen: Modules, batch: Batch, seed: int,
             draws: Optional[Draws] = None):
        b = batch["person_image"].shape[0]
        if draws is None:
            lo = mesh.data_rank * b
            draws = draws_fn(seed, state.step, range(lo, lo + b), batch)
        params = layout.local_params(state.params)
        loss = loss_from_draws(state.params, frozen, batch, draws)
        grads = _grads(loss, params)
        with torch.no_grad():
            g = torch.cat([
                mesh_lib.pmean(_flat(grads[:k_rep]), mesh.world_group),
                mesh_lib.pmean(_flat(grads[k_rep:]), mesh.data_group)])
            del grads
            gnorm = norm(g)
            u, opt_state = tx.update_flat(g, state.opt_state,
                                          lambda: _flat(params), norm=norm)
            apply_updates(params, [x.view_as(p) for x, p in zip(
                u.split([p.numel() for p in params]), params)])
        return (TrainState(step=state.step + 1, params=state.params,
                           opt_state=opt_state, layout=layout),
                {"loss": mesh_lib.pmean(loss.detach(), mesh.data_group),
                 "grad_norm": gnorm})

    return step, sharded, frozen
