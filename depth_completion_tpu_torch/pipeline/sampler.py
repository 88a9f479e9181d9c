"""The guided sampling loop, PyTorch counterpart of
``depth_completion_tpu.pipeline.sampler``.

The JAX sampler runs its steps as one jit-compiled ``lax.scan``, compiled
once per signature. Here the per-step guided branch with the fused
epilogue is a ``GuidedStepProgram`` per signature (held by a
``programs.ProgramCache``): on a card, one CUDA graph of one step, captured
at the signature's first request and replayed at every DDIM step; on the
CPU, the same step run eagerly. Its per-step values (t, the schedule's
coefficients, the bias corrections) are device tables indexed by a device
step index, so a replay reads what an eager step took as host floats,
bit for bit. Every other loop here runs eagerly. Per-step guided training
(the main path) keeps the JAX package's dataflow exactly:

- ε̂ comes from the UNet applied to the *pre-update* latent; the DDIM step
  is applied to the *post-update* latent with that old ε̂;
- the guidance gradient flows through the UNet and the VAE decoder (TAESD
  or KL) into the latent (``torch.autograd.grad`` w.r.t. the latent and the affine
  scale/shift);
- per-sample losses are summed before the gradient (samples are
  independent, so this is the per-sample gradient);
- the latent gradient is rescaled per sample by ‖ε̂‖ / max(‖g‖, 1e-7) before
  the optimizer step; the affine gradients are left as they are.

With Adam and v- or ε-prediction without sample clipping (the Marigold
configuration) the rescale, the latent's Adam update and the DDIM
transition run as one fused epilogue (``ops.guidance_epilogue``, the Hopper
kernel on CUDA; JAX ``sampler.py:466-511``), which holds the latent's Adam
moments; the affine's Adam is ``torch.optim.Adam``'s arithmetic as tensor
ops. SGD and Adagrad run the same math as a chain of eager ops.

Native-resolution mode (``ring_mesh``, a ring of ``ops.ring_attention``)
routes the UNet's self-attention through the ring wherever the sequence
divides the ring size, whatever its length (JAX ``sampler.py:357-370``);
cross-attention, the other self-attention calls and the VAE keep the base
attention.

Also ported: the no-training DDIM branch, the LCM branch (no training;
JAX's threefry key chain for the re-noise), per-input training (a no-grad
DDIM denoise, then ``train_steps`` optimizer steps on the latent and the
affine through the unclamped decode of the latent itself), the KLD penalty,
UNet rematerialisation (``remat_unet``), fast guidance (``detach_unet_grad``:
the UNet runs without a graph, as JAX's ``stop_gradient`` lets XLA drop its
activations) and the final decode.

Per-input training deliberately departs from the original PyTorch
Marigold-DC, whose optimizer holds a stale latent so that only the affine
trains: here the latent trains too, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import threading
import time
from typing import Any

import numpy as np
import torch

from depth_completion_tpu_torch.core import prng
from depth_completion_tpu_torch.device import upload
from depth_completion_tpu_torch.guidance.affine import (
    affine_to_metric_closed_form,
    affine_to_metric_learned,
)
from depth_completion_tpu_torch.guidance.losses import compute_loss
from depth_completion_tpu_torch.guidance.optim import make_optimizer
from depth_completion_tpu_torch.guidance.projection import (
    DepthNormalization,
    denormalize_depth,
    normalize_sparse,
    renormalize_to_guidance,
)
from depth_completion_tpu_torch.models.bundle import ModelBundle
from depth_completion_tpu_torch.models.layers import attention
from depth_completion_tpu_torch.models.unet import apply_unet
from depth_completion_tpu_torch.ops.conv3x3 import conv3x3_fused
from depth_completion_tpu_torch.ops.flash_attention import flash_attention
from depth_completion_tpu_torch.ops.guidance_epilogue import (
    ADAM_B1,
    ADAM_B2,
    ADAM_EPS,
    epilogue_table,
    guidance_epilogue,
)
from depth_completion_tpu_torch.ops.guidance_epilogue import supported as epilogue_supported
from depth_completion_tpu_torch.ops.resize import latent_size, resize_antialias, unpad
from depth_completion_tpu_torch.ops.ring_attention import LocalRing, ring_attention
from depth_completion_tpu_torch.pipeline.preprocess import preprocess_images
from depth_completion_tpu_torch.pipeline.programs import (
    ProgramCache,
    add_launches,
    launch_counts,
    program_key,
)
from depth_completion_tpu_torch.sched.ddim import (
    DDIMConfig,
    ddim_step,
    make_schedule,
    make_timesteps,
    pred_epsilon,
    pred_original,
    pred_original_at,
    step_tables,
)
from depth_completion_tpu_torch.sched.lcm import LCMConfig, lcm_step, make_lcm_timesteps

EPSILON = 1e-7

# One per-step guided step's peak device memory, per VAE kind and UNet
# remat setting, as n·EH·EW latent pixels times the bytes per latent pixel
# plus the fixed bytes (the weights, the decode's workspace). Measured by
# chip_smoke.py phase 5 (the peaks of one guided step, Marigold UNet, bf16,
# 72x96 latents, through batch 1 and 8 with TAESD, 1 and 4 with the KL VAE;
# batch 2 within 0.3% of the line) on an NVIDIA H100 80GB HBM3 at 700 W:
# TAESD 4.13 / 21.09 GiB at batch 1 / 8 (2.41 / 7.40 with remat), KL 14.60 /
# 52.83 at batch 1 / 4 (12.86 / 45.90). The KL decoder is not
# rematerialised: its full-resolution activations dominate that path's
# bytes per pixel with and without, so the largest KL batch that fits an
# 80 GB card at 72x96 is 6.
STEP_PEAK_BYTES = {  # (vae kind, remat) → (bytes per latent pixel, fixed bytes)
    ("tiny", False): (376_312, 1_833_996_288),
    ("tiny", True): (110_756, 1_822_760_448),
    ("kl", False): (1_979_392, 1_994_747_221),
    ("kl", True): (1_710_515, 1_987_920_213),
}
# remat_unet="auto" turns remat on where the step without it would pass
# this share of the card's memory; a batch that passes it even with remat
# is refused before the first kernel.
REMAT_MEMORY_SHARE = 0.9


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampling configuration: the JAX package's fields and defaults."""

    steps: int = 50
    resolution: int = 768
    projection: str = "linear"  # "linear" | "log" | "log10"
    inv: bool = False
    norm: str = "minmax"  # "const" | "minmax" | "percentile"
    percentile: tuple[float, float] = (0.01, 0.99)
    beta: float = 0.9
    closed_form: bool | None = None
    opt: str = "adam"
    lr_latent: float = 0.05
    lr_scaling: float = 0.005
    kld: bool = False
    kld_weight: float = 0.1
    kld_mode: str = "simple"
    interp_mode: str = "bilinear"
    loss_funcs: tuple[str, ...] = ("l1", "l2")
    seed: int = 2024
    train_latents: bool = True
    train_method: str = "per-step"  # "per-step" | "per-input"
    train_steps: int = 10
    min_depth: float = 0.0
    max_depth: float = 120.0
    scheduler: str = "ddim"  # "ddim" | "lcm"
    ddim: DDIMConfig = DDIMConfig()
    lcm: LCMConfig = LCMConfig()
    # rematerialise the UNet's down and up stages in the guidance backward:
    # "on"/True, "off"/False, or "auto" (on a CUDA card: on when the step's
    # estimated peak memory passes REMAT_MEMORY_SHARE of the card's; on the
    # CPU: off)
    remat_unet: str | bool = "auto"
    # "auto" / "on": ops.flash_attention (the Hopper kernel on CUDA);
    # "off": the plain layers.attention.
    flash_attention: str = "auto"
    # native-resolution mode: a LocalRing or ProcessGroupRing
    # (ops.ring_attention) over which the UNet's self-attention sequence is
    # split; the JAX package's mesh and axis name in one object
    ring_mesh: Any = None
    # stop the guidance gradient at the UNet output (a faster approximation;
    # off by default to keep the exact dataflow)
    detach_unet_grad: bool = False

    def resolved_closed_form(self) -> bool:
        """closed_form=None → not train_latents."""
        if self.closed_form is None:
            return not self.train_latents
        if not self.closed_form and not self.train_latents:
            raise ValueError("closed_form must be True (or None) when train_latents=False")
        return self.closed_form

    def validate(self) -> None:
        if self.train_method not in ("per-step", "per-input"):
            raise ValueError(f"Unknown train_method: {self.train_method}")
        if self.train_method == "per-input" and self.train_steps <= 0:
            raise ValueError("train_steps must be > 0 for per-input training")
        if not (0 < self.beta < 1):
            raise ValueError(f"beta must be in (0, 1), got {self.beta}")
        if self.norm == "percentile" and not all(0 <= p <= 1 for p in self.percentile):
            raise ValueError(f"percentile must be in [0, 1], got {self.percentile}")
        if self.projection not in ("linear", "log", "log10"):
            raise ValueError(f"Unknown projection method: {self.projection}")
        if (self.projection in ("log", "log10") or self.inv) and self.min_depth <= EPSILON:
            raise ValueError(f"min_depth must be > {EPSILON} for log/log10/inverse projection")
        if self.norm not in ("const", "minmax", "percentile"):
            raise ValueError(f"Unknown norm method: {self.norm}")
        self.resolved_closed_form()


def _check_options(cfg: SamplerConfig) -> None:
    if cfg.remat_unet not in ("auto", "on", "off", True, False):
        raise ValueError(f"remat_unet must be 'auto'/'on'/'off' or bool, got {cfg.remat_unet!r}")
    if cfg.flash_attention not in ("auto", "on", "off"):
        raise ValueError(f"flash_attention must be 'auto'/'on'/'off', got {cfg.flash_attention!r}")


def card_memory_bytes(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).total_memory


def step_peak_bytes(vae_kind: str, remat: bool, n: int, latent_hw: tuple[int, int]) -> int:
    """Estimated peak device bytes of one per-step guided step at batch ``n``
    (``STEP_PEAK_BYTES``)."""
    per_pixel, fixed = STEP_PEAK_BYTES[(vae_kind, remat)]
    return n * latent_hw[0] * latent_hw[1] * per_pixel + fixed


def largest_batch(vae_kind: str, latent_hw: tuple[int, int], device: torch.device) -> int:
    """The largest per-step guided batch whose estimated peak, with UNet
    remat, stays within ``REMAT_MEMORY_SHARE`` of the card's memory."""
    per_pixel, fixed = STEP_PEAK_BYTES[(vae_kind, True)]
    budget = REMAT_MEMORY_SHARE * card_memory_bytes(device)
    return max(0, int((budget - fixed) // (latent_hw[0] * latent_hw[1] * per_pixel)))


def check_batch_fits(vae_kind: str, n: int, latent_hw: tuple[int, int],
                     device: torch.device) -> None:
    """Raise a ``ValueError`` naming the largest batch that fits where a
    per-step guided batch of ``n`` would not fit on the card even with UNet
    remat; nothing to check on the CPU."""
    if device.type != "cuda":
        return
    limit = largest_batch(vae_kind, latent_hw, device)
    if n > limit:
        need = step_peak_bytes(vae_kind, True, n, latent_hw)
        raise ValueError(
            f"a guided batch of {n} at {latent_hw[0]}x{latent_hw[1]} latents with the "
            f"{vae_kind!r} VAE needs about {need / 2**30:.1f} GiB even with UNet remat, more "
            f"than {REMAT_MEMORY_SHARE:.0%} of the card's "
            f"{card_memory_bytes(device) / 2**30:.1f} GiB; the largest batch that fits at "
            f"this geometry is {limit}")


def resolve_remat(cfg: SamplerConfig, n: int, latent_hw: tuple[int, int],
                  device: torch.device, vae_kind: str = "tiny") -> bool:
    """``cfg.remat_unet`` for a batch of ``n`` latents of ``latent_hw`` on
    ``device`` with the ``vae_kind`` decoder ("auto": on where the step's
    estimated peak without remat passes ``REMAT_MEMORY_SHARE`` of the card's
    memory; always off on the CPU)."""
    if cfg.remat_unet == "auto":
        if device.type != "cuda":
            return False
        budget = REMAT_MEMORY_SHARE * card_memory_bytes(device)
        return step_peak_bytes(vae_kind, False, n, latent_hw) > budget
    if isinstance(cfg.remat_unet, bool):
        return cfg.remat_unet
    return cfg.remat_unet == "on"


def decode_prediction(bundle: ModelBundle, latents: torch.Tensor,
                      conv_fn=conv3x3_fused, attention_fn=flash_attention) -> torch.Tensor:
    """Latent → [0,1] affine depth at processing resolution, decoded in the
    model dtype with ``conv_fn`` running the decoder's 3x3 convs and
    ``attention_fn`` the KL decoder's mid attention."""
    return bundle.vae.decode_depth(latents.to(bundle.dtype), conv_fn, attention_fn)


def latent_to_affine(decode, latents, orig_res, padding, interp_mode):
    """Decode (``decode``: latent → [0,1] depth, e.g. a partial of
    ``decode_prediction``), unpad, resize to the original resolution (fp32)."""
    affine = unpad(decode(latents), padding)
    return resize_antialias(affine.float(), orig_res, method=interp_mode)


def _affine_to_metric(affines, dn: DepthNormalization, affine_params, closed_form: bool):
    if closed_form:
        return affine_to_metric_closed_form(affines, dn.sparses_normed, dn.masks)
    scale, shift = affine_params
    return affine_to_metric_learned(affines, dn.sparses_normed, dn.masks, scale, shift)


def _prepare(bundle, images, sparses, cfg, pred_latents_prev, init_noise=None):
    """No-grad preprocessing: noise, image latents, normalisation state.

    Without ``init_noise`` the noise is JAX's for ``cfg.seed``
    (``PRNGKey(seed)``, a split, ``normal`` of the second key), drawn on
    the host in float32 and copied to the device: one seed gives the same
    starting latent on both sides, on any device."""
    n = images.shape[0]
    imgs_proc, padding, orig_res = preprocess_images(images, cfg.resolution, cfg.interp_mode)
    img_latents = bundle.vae.encode(imgs_proc.to(bundle.dtype))  # [N, EH, EW, 4]
    eh, ew = img_latents.shape[1], img_latents.shape[2]
    if init_noise is not None:
        pred_latents = init_noise.float()
    else:
        # one noise draw shared across the batch
        _, noise_key = prng.split(prng.PRNGKey(cfg.seed))
        noise = upload(prng.normal(noise_key, (1, eh, ew, 4)), images.device)
        pred_latents = noise.expand(n, -1, -1, -1)
    if pred_latents_prev is not None:
        pred_latents = cfg.beta * pred_latents + (1.0 - cfg.beta) * pred_latents_prev.float()
    dn = normalize_sparse(
        sparses, norm=cfg.norm, projection=cfg.projection, inv=cfg.inv,
        min_depth=cfg.min_depth, max_depth=cfg.max_depth, percentile=cfg.percentile,
    )
    return img_latents, pred_latents.contiguous(), dn, padding, orig_res


def guidance_loss(decode, cfg, dn, images, orig_res, padding, closed_form,
                  latents_for_decode, affine_params, pred_latents, clamp=True):
    """Per-sample guidance losses on a decoded latent → [N]; the KLD
    penalty, with ``cfg.kld``, is taken on ``pred_latents``. ``clamp``: the
    per-step branch clips the metric prediction to [0, 1] before the loss,
    the per-input branch does not."""
    denses = latent_to_affine(decode, latents_for_decode, orig_res, padding, cfg.interp_mode)
    denses = _affine_to_metric(denses, dn, affine_params, closed_form)
    if clamp:
        denses = torch.clamp(denses, 0.0, 1.0)
    denses = renormalize_to_guidance(denses, dn, cfg.projection, cfg.inv)
    return compute_loss(denses, dn.sparses_normed, dn.masks, cfg.loss_funcs, images=images,
                        kld=cfg.kld, kld_weight=cfg.kld_weight, kld_mode=cfg.kld_mode,
                        pred_latents=pred_latents)


def ring_or_base(ring, base, q, k, v, num_heads):
    """Native-resolution routing: self-attention whose length divides the
    ring size takes ``ring``; everything else ``base``."""
    if q.shape[1] == k.shape[1] and q.shape[1] % ring.size == 0:
        return ring_attention(q, k, v, num_heads, ring)
    return base(q, k, v, num_heads)


class _Denoiser:
    """ε̂ = UNet(img_latents ⊕ latent, t, context) in the model dtype, with
    ``attention_fn`` running the UNet's attention and ``remat`` its stages
    rematerialised in the backward."""

    def __init__(self, bundle: ModelBundle, img_latents: torch.Tensor, attention_fn,
                 remat: bool = False):
        self.bundle, self.img_latents = bundle, img_latents
        n = img_latents.shape[0]
        self.ctx = bundle.text_context.expand(n, -1, -1)
        self.attention_fn, self.remat = attention_fn, remat

    def __call__(self, latents: torch.Tensor, t: int) -> torch.Tensor:
        x = torch.cat([self.img_latents, latents.to(self.img_latents.dtype)], dim=-1)
        return apply_unet(
            self.bundle.unet_params, x, t, self.ctx, self.bundle.unet_config,
            attention_fn=self.attention_fn, remat=self.remat,
        )


def guided_step_grads(denoise, decode, sched, cfg, dn, images, orig_res, padding,
                      closed_form, latents, affine_params, t, coeffs=None):
    """One guided step's forward and backward through the UNet ``denoise``
    and the decoder ``decode``: (per-sample losses [N], UNet output, grads
    w.r.t. [latents, *affine_params]). ``t`` is a Python int, or with
    ``coeffs`` (√ᾱ_t, √(1−ᾱ_t) as 0-d tensors) a tensor on the device: a
    ``step_tables`` row."""
    with torch.enable_grad():
        # a detached UNet output (fast guidance) needs no graph through the
        # UNet: the latent's gradient flows through pred_original's own
        # latent term
        with torch.set_grad_enabled(not cfg.detach_unet_grad):
            out = denoise(latents, t)
        x0 = (pred_original(sched, out, t, latents) if coeffs is None
              else pred_original_at(sched, out, latents, *coeffs))
        losses = guidance_loss(
            decode, cfg, dn, images, orig_res, padding, closed_form, x0, affine_params, latents
        )
        grads = torch.autograd.grad(losses.sum(), [latents, *affine_params])
    return losses.detach(), out.detach(), grads


@torch.no_grad()
def guided_sample(
    bundle: ModelBundle,
    images: torch.Tensor,
    sparses: torch.Tensor,
    cfg: SamplerConfig,
    pred_latents_prev: torch.Tensor | None = None,
    init_noise: torch.Tensor | None = None,
    *,
    programs: ProgramCache,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full depth-completion sampling → (metric denses [N,H,W,1], latents).

    ``images`` [N,H,W,3] (0..255) and ``sparses`` [N,H,W,1] are tensors on
    the bundle's device. A per-step guided batch that would not fit on the
    card even with UNet remat raises ``ValueError`` (``check_batch_fits``)
    before the first kernel. The per-step branch with the fused epilogue
    runs through ``programs`` (the caller's cache, e.g. the pipeline's, or
    a ``programs.EagerTwin``): one ``GuidedStepProgram`` per signature, its
    steps replayed from one captured CUDA graph on a card and run eagerly
    on the CPU.
    """
    cfg.validate()
    _check_options(cfg)
    closed_form = cfg.resolved_closed_form()
    n = images.shape[0]
    latent_hw = latent_size(tuple(images.shape[1:3]), cfg.resolution,
                            bundle.vae.downsample_factor)
    unet_backward = (cfg.train_latents and cfg.scheduler != "lcm"
                     and cfg.train_method == "per-step" and not cfg.detach_unet_grad)
    if unet_backward:
        check_batch_fits(bundle.vae.kind, n, latent_hw, images.device)
    remat = resolve_remat(cfg, n, latent_hw, images.device, bundle.vae.kind)
    sched = make_schedule(cfg.ddim)
    img_latents, pred_latents, dn, padding, orig_res = _prepare(
        bundle, images, sparses, cfg, pred_latents_prev, init_noise
    )
    attention_fn = attention if cfg.flash_attention == "off" else flash_attention
    unet_attention = attention_fn if cfg.ring_mesh is None else functools.partial(
        ring_or_base, cfg.ring_mesh, attention_fn)
    denoise = _Denoiser(bundle, img_latents, unet_attention, remat)
    decode = functools.partial(decode_prediction, bundle, attention_fn=attention_fn)

    affine_params: list[torch.Tensor] = []
    if not (cfg.train_latents and cfg.scheduler != "lcm"):
        if cfg.scheduler == "lcm":
            final_latents = _lcm_denoise(denoise, sched, cfg, pred_latents)
        else:
            final_latents = _ddim_denoise(denoise, sched, cfg, pred_latents)
    elif cfg.train_method == "per-step" and cfg.opt == "adam" and epilogue_supported(sched):
        program = programs.get(
            program_key(bundle, images.shape, cfg, remat),
            lambda: GuidedStepProgram(bundle, cfg, sched, remat, closed_form, img_latents,
                                      pred_latents, dn, images, orig_res, padding))
        with program.lock:
            program.load(img_latents, pred_latents, dn, images)
            programs.run(program)
            final_latents = program.latents.clone()
            affine_params = [p.clone() for p in program.affine]
    else:
        if not closed_form:
            affine_params = _initial_affine(n, images.device)
            for p in affine_params:
                p.requires_grad_(True)
        if cfg.train_method == "per-input":
            latents = _ddim_denoise(denoise, sched, cfg, pred_latents).requires_grad_(True)
            _per_input_steps(decode, cfg, dn, images, orig_res, padding, closed_form,
                             latents, affine_params)
        else:
            latents = pred_latents.clone().requires_grad_(True)
            step = functools.partial(
                guided_step_grads, denoise, decode, sched, cfg, dn, images, orig_res, padding,
                closed_form, latents, affine_params,
            )
            ts = [int(t) for t in make_timesteps(cfg.ddim, cfg.steps)]
            _eager_steps(step, sched, cfg, ts, latents, affine_params)
        final_latents = latents.detach()

    denses_affine = latent_to_affine(decode, final_latents, orig_res, padding, cfg.interp_mode)
    denses_normed = torch.clamp(
        _affine_to_metric(denses_affine, dn, affine_params, closed_form), 0.0, 1.0
    )
    return denormalize_depth(denses_normed, dn), final_latents


def _ddim_denoise(denoise, sched, cfg, lat):
    """Plain η=0 DDIM over the trailing timesteps, no guidance."""
    for t in make_timesteps(cfg.ddim, cfg.steps):
        lat, _ = ddim_step(sched, denoise(lat, int(t)), int(t), lat, cfg.steps)
    return lat


def _lcm_denoise(denoise, sched, cfg, lat):
    """The LCM steps. The key chain is JAX's: the carry starts from the
    first key of ``split(PRNGKey(seed))`` (the second drew the initial
    noise); each step splits it and re-noises with the second key."""
    ts = [int(t) for t in make_lcm_timesteps(cfg.ddim.num_train_timesteps, cfg.steps, cfg.lcm)]
    key = prng.split(prng.PRNGKey(cfg.seed))[0]
    for i, t in enumerate(ts):
        key, sub = prng.split(key)
        last = i == len(ts) - 1
        lat, _ = lcm_step(sched, denoise(lat, t), t, -1 if last else ts[i + 1], lat, sub,
                          last, cfg.lcm)
    return lat


def per_input_grads(decode, cfg, dn, images, orig_res, padding, closed_form, latents,
                    affine_params):
    """One per-input training step's forward and backward: the guidance
    loss of the latent's own decode, unclamped (no Tweedie preview, no
    UNet) → (per-sample losses [N], grads w.r.t. [latents, *affine_params])."""
    with torch.enable_grad():
        losses = guidance_loss(decode, cfg, dn, images, orig_res, padding, closed_form,
                               latents, affine_params, latents, clamp=False)
        grads = torch.autograd.grad(losses.sum(), [latents, *affine_params])
    return losses.detach(), grads


def _per_input_steps(decode, cfg, dn, images, orig_res, padding, closed_form, latents,
                     affine_params):
    """``cfg.train_steps`` optimizer steps (``make_optimizer``: the latent
    and the affine together) on the raw per-input gradients (no ε-norm
    rescale)."""
    opt = make_optimizer(cfg.opt, latents, affine_params, cfg.lr_latent, cfg.lr_scaling)
    for _ in range(cfg.train_steps):
        _, grads = per_input_grads(decode, cfg, dn, images, orig_res, padding, closed_form,
                                   latents, affine_params)
        for p, g in zip([latents, *affine_params], grads):
            p.grad = g
        opt.step()


def _initial_affine(n: int, device: torch.device) -> list[torch.Tensor]:
    """The learned affine's start: scale 1, shift 0 per sample."""
    return [torch.ones((n, 1, 1, 1), device=device), torch.zeros((n, 1, 1, 1), device=device)]


def affine_adam_table(num_steps: int, lr: float, device: torch.device) -> torch.Tensor:
    """[steps, 2] float32: step k's −lr/(1−b1^(k+1)) and √(1−b2^(k+1)), the
    values ``torch.optim.Adam`` takes as host floats at its (k+1)-th step."""
    rows = [(-(lr / (1 - ADAM_B1 ** c)), (1 - ADAM_B2 ** c) ** 0.5)
            for c in range(1, num_steps + 1)]
    return upload(np.array(rows, dtype=np.float32), device)


_SIDE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}
_SIDE_STREAMS_LOCK = threading.Lock()


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One stream per card for the eager step before every capture: each
    new stream would keep a cuBLAS workspace of its own for the process's
    life."""
    with _SIDE_STREAMS_LOCK:
        if device not in _SIDE_STREAMS:
            _SIDE_STREAMS[device] = torch.cuda.Stream(device)
        return _SIDE_STREAMS[device]


class GuidedStepProgram:
    """One per-step guided step with the fused epilogue (Adam; v- or
    ε-prediction; any ring; UNet remat, fast guidance and tensor
    parallelism as configured) over fixed buffers: the port's counterpart of the JAX
    sampler's scan body, compiled once per signature
    (``depth_completion_tpu/pipeline/sampler.py:490-511``).

    - Buffers, at fixed addresses: the image latents, the latent and its
      Adam moments, the learned affine and its Adam moments, the
      ``DepthNormalization`` tensors, the images, the step index and the
      per-step tables (``step_tables``, ``epilogue_table``,
      ``affine_adam_table``). ``load`` copies a request's tensors in and
      resets the state.
    - ``step()``: one step at the step index, eagerly. It is the graph's
      plain twin: ``run`` without a cache, the tests and ``chip_smoke.py``
      call it directly.
    - ``run(cache)``: one request's steps. On a card, the first request runs
      step 0 eagerly on a side stream (the kernels build, cuDNN picks its
      plans, the resize tables fill), captures one step into the cache's
      graph pool and replays steps 1..N−1; later requests replay all N.
      Before each replay the host advances the step index with one
      asynchronous ``fill_``; nothing in a step waits on the device. The
      step's results land in the buffers (the epilogue and the affine's
      Adam update them in place), so the graph keeps no live tensor in the
      pool. On the CPU, without a cache (``programs.EagerTwin``), with a
      ``ProcessGroupRing`` or with a tensor-parallel UNet, every step runs
      eagerly: those steps hold collectives, and gloo's cannot be captured
      (NCCL's can, but a captured NCCL step has not run on two cards yet).
      A data-parallel step has no collective and is captured. A failed
      capture raises.

    Outside the program, eager: the encode and the final decode (once per
    request), ``_eager_steps`` (SGD, Adagrad), per-input training, LCM and
    the no-training DDIM branch.
    """

    def __init__(self, bundle, cfg, sched, remat, closed_form, img_latents, pred_latents, dn,
                 images, orig_res, padding):
        dev = images.device
        self.cfg, self.sched, self.closed_form, self.remat = cfg, sched, closed_form, remat
        self.orig_res, self.padding = orig_res, padding
        self.steps = cfg.steps
        self.v_pred = sched.config.prediction_type == "v_prediction"
        # no collective may sit in a captured step: a ProcessGroupRing
        # (batch_isend_irecv, waited on the host) and a tensor-parallel UNet
        # (all_reduce over the model group) run every step eagerly
        self.capturable = (dev.type == "cuda" and bundle.model_group is None
                           and (cfg.ring_mesh is None or isinstance(cfg.ring_mesh, LocalRing)))
        self.lock = threading.Lock()
        ts = make_timesteps(cfg.ddim, cfg.steps)
        self.tables = step_tables(sched, ts, cfg.steps, dev)
        self.epilogue = epilogue_table(sched, ts, cfg.steps, dev)
        self.affine_adam = affine_adam_table(cfg.steps, cfg.lr_scaling, dev)
        self.step_index = torch.zeros(1, dtype=torch.int64, device=dev)
        self.img_latents = torch.empty_like(img_latents)
        self.latents = torch.empty_like(pred_latents, dtype=torch.float32)
        self.m, self.v = torch.zeros_like(self.latents), torch.zeros_like(self.latents)
        n = images.shape[0]
        self.affine = [] if closed_form else _initial_affine(n, dev)
        self.affine_m = [torch.zeros_like(p) for p in self.affine]
        self.affine_v = [torch.zeros_like(p) for p in self.affine]
        self.dn = DepthNormalization(**{f.name: torch.empty_like(getattr(dn, f.name))
                                        for f in dataclasses.fields(dn)})
        self.images = torch.empty_like(images)
        attention_fn = attention if cfg.flash_attention == "off" else flash_attention
        unet_attention = attention_fn if cfg.ring_mesh is None else functools.partial(
            ring_or_base, cfg.ring_mesh, attention_fn)
        self._denoise = _Denoiser(bundle, self.img_latents, unet_attention, remat)
        self._decode = functools.partial(decode_prediction, bundle, attention_fn=attention_fn)
        self.graph = None
        self.launch_delta: dict[str, int] = {}  # one captured step's kernel launches
        self.stats: dict[str, Any] = {}  # capture ms, instantiate ms, pool growth

    def load(self, img_latents, pred_latents, dn, images) -> None:
        """A request's tensors into the buffers, and the state reset."""
        self.img_latents.copy_(img_latents)
        self.latents.copy_(pred_latents)
        self.m.zero_()
        self.v.zero_()
        for f in dataclasses.fields(dn):
            getattr(self.dn, f.name).copy_(getattr(dn, f.name))
        self.images.copy_(images)
        for p, init in zip(self.affine, (1.0, 0.0)):
            p.fill_(init)
        for buf in (*self.affine_m, *self.affine_v):
            buf.zero_()

    def step(self) -> None:
        """One guided step at ``step_index``, eagerly, on the buffers."""
        # rows by index_select: Python indexing with a 0-d tensor may read it on the host
        k = self.step_index
        t = self.tables.t.index_select(0, k).expand(self.images.shape[0])
        sqrt_a, sqrt_1ma = self.tables.coeffs.index_select(0, k)[0, :2].unbind(0)
        lat = self.latents.detach().requires_grad_(True)
        aff = [p.detach().requires_grad_(True) for p in self.affine]
        _, out, grads = guided_step_grads(
            self._denoise, self._decode, self.sched, self.cfg, self.dn, self.images,
            self.orig_res, self.padding, self.closed_form, lat, aff, t, (sqrt_a, sqrt_1ma))
        if self.affine:
            # torch.optim.Adam's single-tensor arithmetic, its host floats
            # read from the table row
            neg_step_size, bc2_sqrt = self.affine_adam.index_select(0, k)[0].unbind(0)
            for p, g, m, v in zip(self.affine, grads[1:], self.affine_m, self.affine_v):
                m.lerp_(g, 1 - ADAM_B1)
                v.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                p.add_(m * neg_step_size / (v.sqrt() / bc2_sqrt).add_(ADAM_EPS))
        guidance_epilogue(self.latents, grads[0], out, self.m, self.v, self.epilogue, k,
                          lr=self.cfg.lr_latent, v_pred=self.v_pred)

    def step_eager(self, k: int) -> None:
        self.step_index.fill_(k)
        self.step()

    def replay(self, k: int) -> None:
        """Step ``k`` through the captured graph."""
        self.step_index.fill_(k)
        self.graph.replay()
        add_launches(self.launch_delta)

    def run(self, cache: ProgramCache | None = None) -> None:
        """One request's steps (see the class docstring)."""
        if cache is None or not self.capturable:
            for k in range(self.steps):
                self.step_eager(k)
            return
        first = 0
        if self.graph is None:
            self._capture(cache)
            first = 1
        for k in range(first, self.steps):
            self.replay(k)

    def _capture(self, cache: ProgramCache) -> None:
        """Step 0 eagerly on a side stream, then one step captured into the
        cache's pool (PyTorch's whole-network capture recipe)."""
        dev = self.latents.device
        cur = torch.cuda.current_stream(dev)
        side = _side_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.step_eager(0)
        cur.wait_stream(side)
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, pool=cache.pool()):
                self.step()
                t1 = time.perf_counter()
            t2 = time.perf_counter()
        finally:
            # the capture launched nothing: its counts move to the replays
            # (an aborted capture's counts are dropped)
            after = launch_counts()
            delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            add_launches(delta, -1)
        # cuBLAS keeps a workspace per stream for the process's life; the
        # capture's lives in the pool (its replays reuse the block), the
        # side stream's would stay allocated: both are made again on use
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        self.launch_delta = delta
        self.graph = graph
        self.stats = {"capture_ms": (t1 - t0) * 1e3, "instantiate_ms": (t2 - t1) * 1e3,
                      "pool_growth_bytes": torch.cuda.memory_reserved(dev) - reserved}


def eager_epilogue(sched, opt, latents, g, out, t: int, num_steps: int) -> None:
    """The step's epilogue as a chain of eager ops: the ε-norm rescale of
    the latent gradient ``g`` (per sample), ``opt.step()`` (the affine's
    gradients, if any, already set) and the DDIM transition of the updated
    ``latents`` with the old UNet output ``out``, in place."""
    n = latents.shape[0]
    eps_norm = pred_epsilon(sched, out, t, latents).reshape(n, -1).float().norm(dim=1)
    g = g.float()
    g_norm = g.reshape(n, -1).norm(dim=1)
    latents.grad = g * (eps_norm / torch.clamp(g_norm, min=EPSILON)).reshape(n, 1, 1, 1)
    opt.step()
    new_lat, _ = ddim_step(sched, out, t, latents, num_steps)
    latents.copy_(new_lat)


def _eager_steps(step, sched, cfg, ts, latents, affine_params):
    """Per-step guided steps as eager ops, for any optimizer."""
    opt = make_optimizer(cfg.opt, latents, affine_params, cfg.lr_latent, cfg.lr_scaling)
    for t in ts:
        _, out, grads = step(t)
        for p, gp in zip(affine_params, grads[1:]):
            p.grad = gp
        eager_epilogue(sched, opt, latents, grads[0], out, t, cfg.steps)
