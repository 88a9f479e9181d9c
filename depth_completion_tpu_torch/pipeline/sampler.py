"""The guided sampling loop, PyTorch counterpart of
``depth_completion_tpu.pipeline.sampler``.

The JAX sampler runs its steps as one jit-compiled ``lax.scan``, and the
JAX pipeline jits the whole of ``guided_sample`` once per signature. Here
every branch is a ``SamplerProgram`` per signature (held by a
``programs.ProgramCache``): a prepare step (preprocessing, the encode, the
carried-latent mix, the sparse normalisation), the branch's step or steps
and a finish step (the final decode to metric depth), each on a card one
CUDA graph captured at the signature's first request and replayed (the
branch's step once per DDIM, LCM or training step), on the CPU the same
bodies run eagerly. Their per-step values (t, the schedule's and LCM's
coefficients, the bias corrections, the LCM re-noise) are device tables
indexed by a device step index, so a replay reads what an eager step took
as host floats, bit for bit. Per-step guided training (the main path)
keeps the JAX package's dataflow exactly:

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
ops (``guidance.optim.FixedOptimizer``). SGD, Adagrad and Adam where the
epilogue does not apply run the same math as a chain of tensor ops, the
optimizer a ``FixedOptimizer`` over the latent and the affine.

Native-resolution mode (``ring_mesh``, a ring of ``ops.ring_attention``)
routes the UNet's self-attention through the ring wherever the sequence
divides the ring size, whatever its length (JAX ``sampler.py:357-370``);
cross-attention, the other self-attention calls and the VAE keep the base
attention.

Also ported, each a program: the no-training DDIM branch, the LCM branch
(no training; JAX's threefry key chain for the re-noise, drawn on the host
for a request's seed), per-input training (a no-grad DDIM denoise, then
``train_steps`` optimizer steps on the latent and the affine through the
unclamped decode of the latent itself); and the KLD penalty,
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

import torch

from depth_completion_tpu_torch.core import prng
from depth_completion_tpu_torch.device import upload
from depth_completion_tpu_torch.guidance.affine import (
    affine_to_metric_closed_form,
    affine_to_metric_learned,
)
from depth_completion_tpu_torch.guidance.losses import compute_loss
from depth_completion_tpu_torch.guidance.optim import FixedOptimizer
from depth_completion_tpu_torch.guidance.projection import (
    DepthNormalization,
    denormalize_depth,
    normalize_sparse,
    renormalize_to_guidance,
)
from depth_completion_tpu_torch.models.bundle import ModelBundle
from depth_completion_tpu_torch.models.layers import attention
from depth_completion_tpu_torch.models.unet import apply_unet
from depth_completion_tpu_torch.ops.conv3x3 import conv3x3_routed
from depth_completion_tpu_torch.ops.flash_attention import flash_attention
from depth_completion_tpu_torch.ops.guidance_epilogue import epilogue_table, guidance_epilogue
from depth_completion_tpu_torch.ops.guidance_epilogue import supported as epilogue_supported
from depth_completion_tpu_torch.ops.resize import (
    latent_size,
    processing_padding,
    resize_antialias,
    unpad,
)
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
    ddim_step_at,
    make_schedule,
    make_timesteps,
    pred_epsilon_at,
    pred_original,
    pred_original_at,
    step_tables,
)
from depth_completion_tpu_torch.sched.lcm import (
    LCMConfig,
    lcm_renoise,
    lcm_step_at,
    lcm_tables,
    make_lcm_timesteps,
)

EPSILON = 1e-7

# One per-step guided step's peak device memory, per VAE kind, UNet remat
# setting and model dtype, as n·EH·EW latent pixels times the bytes per
# latent pixel plus the fixed bytes (the weights, the decode's workspace).
# Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W (the peaks
# of one guided step, Marigold UNet, 72x96 latents). bf16 (phase 5: TAESD
# through batch 1 and 8, KL through 1 and 4; batch 2 within 0.3% of the
# line): TAESD 4.13 / 21.09 GiB at batch 1 / 8 (2.41 / 7.40 with remat), KL
# 14.60 / 52.83 at batch 1 / 4 (12.86 / 45.90). fp32 (phase 5b, TAESD
# through batch 1 and 4, KL through 1 and 2): TAESD 7.37 / 18.50 GiB (5.23 /
# 12.10 with remat), KL 19.00 / 34.34 (16.62 / 29.62). The KL decoder is not
# rematerialised: its full-resolution activations dominate that path's
# bytes per pixel with and without, so the largest bf16 KL batch that fits
# an 80 GB card at 72x96 is 6.
STEP_PEAK_BYTES = {  # (vae kind, remat, dtype) → (bytes per latent pixel, fixed bytes)
    ("tiny", False, torch.bfloat16): (376_312, 1_833_996_288),
    ("tiny", True, torch.bfloat16): (110_756, 1_822_760_448),
    ("kl", False, torch.bfloat16): (1_979_392, 1_994_747_221),
    ("kl", True, torch.bfloat16): (1_710_515, 1_987_920_213),
    ("tiny", False, torch.float32): (576_238, 3_928_159_061),
    ("tiny", True, torch.float32): (355_738, 3_158_503_253),
    ("kl", False, torch.float32): (2_382_839, 3_933_459_456),
    ("kl", True, torch.float32): (2_018_243, 3_899_750_912),
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


def step_peak_bytes(vae_kind: str, remat: bool, n: int, latent_hw: tuple[int, int],
                    dtype: torch.dtype = torch.bfloat16) -> int:
    """Estimated peak device bytes of one per-step guided step at batch ``n``
    with a ``dtype`` bundle (``STEP_PEAK_BYTES``)."""
    per_pixel, fixed = STEP_PEAK_BYTES[(vae_kind, remat, dtype)]
    return n * latent_hw[0] * latent_hw[1] * per_pixel + fixed


def largest_batch(vae_kind: str, latent_hw: tuple[int, int], device: torch.device,
                  dtype: torch.dtype = torch.bfloat16) -> int:
    """The largest per-step guided batch of a ``dtype`` bundle whose
    estimated peak, with UNet remat, stays within ``REMAT_MEMORY_SHARE`` of
    the card's memory."""
    per_pixel, fixed = STEP_PEAK_BYTES[(vae_kind, True, dtype)]
    budget = REMAT_MEMORY_SHARE * card_memory_bytes(device)
    return max(0, int((budget - fixed) // (latent_hw[0] * latent_hw[1] * per_pixel)))


def check_batch_fits(vae_kind: str, n: int, latent_hw: tuple[int, int],
                     device: torch.device, dtype: torch.dtype = torch.bfloat16) -> None:
    """Raise a ``ValueError`` naming the largest batch that fits where a
    per-step guided batch of ``n`` with a ``dtype`` bundle would not fit on
    the card even with UNet remat; nothing to check on the CPU."""
    if device.type != "cuda":
        return
    limit = largest_batch(vae_kind, latent_hw, device, dtype)
    if n > limit:
        need = step_peak_bytes(vae_kind, True, n, latent_hw, dtype)
        precision = "bf16" if dtype == torch.bfloat16 else "fp32"
        raise ValueError(
            f"a {precision} guided batch of {n} at {latent_hw[0]}x{latent_hw[1]} latents with the "
            f"{vae_kind!r} VAE needs about {need / 2**30:.1f} GiB even with UNet remat, more "
            f"than {REMAT_MEMORY_SHARE:.0%} of the card's "
            f"{card_memory_bytes(device) / 2**30:.1f} GiB; the largest batch that fits at "
            f"this geometry is {limit}")


def resolve_remat(cfg: SamplerConfig, n: int, latent_hw: tuple[int, int],
                  device: torch.device, vae_kind: str = "tiny",
                  dtype: torch.dtype = torch.bfloat16) -> bool:
    """``cfg.remat_unet`` for a batch of ``n`` latents of ``latent_hw`` on
    ``device`` with the ``vae_kind`` decoder and a ``dtype`` bundle ("auto":
    on where the step's estimated peak without remat passes
    ``REMAT_MEMORY_SHARE`` of the card's memory; always off on the CPU)."""
    if cfg.remat_unet == "auto":
        if device.type != "cuda":
            return False
        budget = REMAT_MEMORY_SHARE * card_memory_bytes(device)
        return step_peak_bytes(vae_kind, False, n, latent_hw, dtype) > budget
    if isinstance(cfg.remat_unet, bool):
        return cfg.remat_unet
    return cfg.remat_unet == "on"


def decode_prediction(bundle: ModelBundle, latents: torch.Tensor,
                      conv_fn=conv3x3_routed, attention_fn=flash_attention) -> torch.Tensor:
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
    """No-grad preprocessing: noise, image latents, normalisation state (the
    arithmetic of a program's prepare step, which the tests hold to it bit
    for bit; the reference steps of ``chip_smoke.py`` start from it).

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


def sampler_branch(cfg: SamplerConfig, sched) -> str:
    """The branch of ``guided_sample`` that ``cfg`` takes (JAX
    ``sampler.py:410-592``), the tag of its program key: "lcm" or "ddim"
    (no training), "fused-step" (per-step guided with Adam through the fused
    epilogue: v- or ε-prediction, no sample clipping), "general-step" (any
    other per-step optimizer or schedule), "per-input"."""
    if not (cfg.train_latents and cfg.scheduler != "lcm"):
        return "lcm" if cfg.scheduler == "lcm" else "ddim"
    if cfg.train_method == "per-input":
        return "per-input"
    if cfg.opt == "adam" and epilogue_supported(sched):
        return "fused-step"
    return "general-step"


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
    before the first kernel. Every branch runs through ``programs`` (the
    caller's cache, e.g. the pipeline's, or a ``programs.EagerTwin``): one
    program per signature (``PROGRAMS``), its prepare, step and finish
    graphs replayed on a card and their bodies run eagerly on the CPU.
    Without ``init_noise`` the initial noise is JAX's for ``cfg.seed``
    (``PRNGKey(seed)``, a split, ``normal`` of the second key), drawn on the
    host in float32 and shared by the batch: one seed gives the same
    starting latent on both sides, on any device. The outputs are copies:
    the program's buffers belong to its next request.
    """
    cfg.validate()
    _check_options(cfg)
    n = images.shape[0]
    latent_hw = latent_size(tuple(images.shape[1:3]), cfg.resolution,
                            bundle.vae.downsample_factor)
    sched = make_schedule(cfg.ddim)
    branch = sampler_branch(cfg, sched)
    if branch in ("fused-step", "general-step") and not cfg.detach_unet_grad:
        check_batch_fits(bundle.vae.kind, n, latent_hw, images.device, bundle.dtype)
    remat = resolve_remat(cfg, n, latent_hw, images.device, bundle.vae.kind, bundle.dtype)
    program = programs.get(
        program_key(branch, bundle, images.shape, cfg, remat),
        lambda: PROGRAMS[branch](bundle, cfg, sched, remat, images, sparses))
    if init_noise is None:
        _, noise_key = prng.split(prng.PRNGKey(cfg.seed))
        init_noise = upload(prng.normal(noise_key, (1, *latent_hw, 4)), images.device)
    with program.lock:
        program.load(images, sparses, init_noise, pred_latents_prev, cfg)
        programs.run(program)
        return program.dense.clone(), program.latents.clone()


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


def _initial_affine(n: int, device: torch.device) -> list[torch.Tensor]:
    """The learned affine's start: scale 1, shift 0 per sample."""
    return [torch.ones((n, 1, 1, 1), device=device), torch.zeros((n, 1, 1, 1), device=device)]


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


class SamplerProgram:
    """One signature's program: the port's counterpart of the JAX
    pipeline's one jit of the whole ``guided_sample``
    (``depth_completion_tpu/pipeline/pipeline.py:27``), a subclass per
    branch (``PROGRAMS``).

    - Buffers, at fixed addresses: the request's inputs (the frames, the
      initial noise, the carried latent and the two mixing weights), what
      the prepare step makes (the image latents, the latent, the
      ``DepthNormalization`` tensors), the branch's state (optimizer state,
      the learned affine), the dense output, the step index and the
      per-step tables. ``load`` copies a request's inputs in.
    - Phases (``phases``: name and count), each a method of that name run
      ``count`` times with the step index at 0..count-1: ``prepare``
      (``preprocess_images``, ``vae.encode``, the carried-latent mix,
      ``normalize_sparse``, the state reset; ``_prepare``'s arithmetic),
      the branch's steps, and ``finish`` (decode, unpad, resize, the affine
      to metric, clamp, ``denormalize_depth``, into ``dense``).
    - ``step_eager(k, name)``: phase ``name``'s body at step index ``k``,
      eagerly: the plain twin of its graph.
    - ``run(cache)``: one request. On a card, each phase's first request
      runs its step 0 eagerly on a side stream (the kernels build, cuDNN
      picks its plans, the resize tables fill), captures one step into the
      cache's graph pool and replays the rest; later requests replay every
      step. Before each replay the host sets the step index with one
      asynchronous ``fill_``; nothing in a step waits on the device. Every
      result lands in the buffers, so a graph keeps no live tensor in the
      pool. On the CPU and without a cache (``programs.EagerTwin``) every
      phase runs eagerly, and so do the UNet's phases (``unet_phases``)
      with a ``ProcessGroupRing`` or a tensor-parallel UNet: those hold
      collectives, and gloo's cannot be captured (NCCL's can, but a captured
      NCCL step has not run on two cards yet). The prepare and finish
      phases hold none and are captured there too. A data-parallel step has
      no collective and is captured. A failed capture raises.
    - ``launch_delta[name]``: the kernel launches that phase's capture
      counted, taken off the counts and added back at each of its replays;
      ``stats[name]``: capture and instantiate ms, pool growth.
    """

    tag = ""
    unet_phases = ("step",)  # the phases that run the UNet (and any collective it holds)

    def __init__(self, bundle, cfg, sched, remat, images, sparses):
        dev = images.device
        n, h, w, _ = images.shape
        self.bundle, self.cfg, self.sched, self.remat = bundle, cfg, sched, remat
        self.closed_form = cfg.resolved_closed_form()
        self.orig_res = (h, w)
        self.padding = processing_padding((h, w), cfg.resolution)
        eh, ew = latent_size((h, w), cfg.resolution, bundle.vae.downsample_factor)
        shape = (n, eh, ew, bundle.vae.config.latent_channels)
        self.steps = cfg.steps
        self.capturable = (dev.type == "cuda" and bundle.model_group is None
                           and (cfg.ring_mesh is None or isinstance(cfg.ring_mesh, LocalRing)))
        self.lock = threading.Lock()
        self.step_index = torch.zeros(1, dtype=torch.int64, device=dev)

        def buf(*size, dtype=torch.float32):
            return torch.empty(size, dtype=dtype, device=dev)

        self.images, self.sparses = torch.empty_like(images), torch.empty_like(sparses)
        self.noise, self.prev, self.mix = buf(*shape), buf(*shape), buf(2)
        self.img_latents = buf(*shape, dtype=bundle.dtype)
        self.latents = buf(*shape)
        self.dn = DepthNormalization(
            sparses_normed=buf(n, h, w, 1), masks=buf(n, h, w, 1, dtype=torch.bool),
            min_depths=buf(n, 1, 1, 1), max_depths=buf(n, 1, 1, 1), min_proj=buf(n, 1, 1, 1),
            max_proj=buf(n, 1, 1, 1), any_valid=buf(n, dtype=torch.bool))
        self.dense = buf(n, h, w, 1)
        self.affine: list[torch.Tensor] = []
        attention_fn = attention if cfg.flash_attention == "off" else flash_attention
        unet_attention = attention_fn if cfg.ring_mesh is None else functools.partial(
            ring_or_base, cfg.ring_mesh, attention_fn)
        self._denoise = _Denoiser(bundle, self.img_latents, unet_attention, remat)
        self._decode = functools.partial(decode_prediction, bundle, attention_fn=attention_fn)
        self.graphs: dict[str, torch.cuda.CUDAGraph] = {}
        self.launch_delta: dict[str, dict[str, int]] = {}
        self.stats: dict[str, dict[str, float]] = {}

    @property
    def phases(self) -> list[tuple[str, int]]:
        return [("prepare", 1), ("step", self.steps), ("finish", 1)]

    def load(self, images, sparses, noise, prev, cfg) -> None:
        """A request's inputs into the buffers: the frames, the initial
        noise ([1 or N, EH, EW, C]), and the carried latent with weights β,
        1−β; without one, a zero latent with weights 1, 0, which gives the
        noise itself bit for bit. ``cfg``: the request's (seed, β)."""
        self.images.copy_(images)
        self.sparses.copy_(sparses)
        self.noise.copy_(noise)
        beta = 1.0
        if prev is None:
            self.prev.zero_()
        else:
            self.prev.copy_(prev)
            beta = cfg.beta
        self.mix[0].fill_(beta)
        self.mix[1].fill_(1.0 - beta)

    def prepare(self) -> None:
        """The request's preprocessing (``_prepare``'s), into the buffers,
        then the state reset."""
        cfg = self.cfg
        imgs_proc, _, _ = preprocess_images(self.images, cfg.resolution, cfg.interp_mode)
        self.img_latents.copy_(self.bundle.vae.encode(imgs_proc.to(self.bundle.dtype)))
        beta, rest = self.mix.unbind(0)
        self.latents.copy_(beta * self.noise + rest * self.prev)
        dn = normalize_sparse(
            self.sparses, norm=cfg.norm, projection=cfg.projection, inv=cfg.inv,
            min_depth=cfg.min_depth, max_depth=cfg.max_depth, percentile=cfg.percentile,
        )
        for f in dataclasses.fields(dn):
            getattr(self.dn, f.name).copy_(getattr(dn, f.name))
        self.reset_state()

    def reset_state(self) -> None:
        """The branch's state at a request's start (the prepare step's last
        part)."""

    def finish(self) -> None:
        """The final decode (JAX ``sampler.py:594-601``) into ``dense``."""
        affine = latent_to_affine(self._decode, self.latents, self.orig_res, self.padding,
                                  self.cfg.interp_mode)
        normed = torch.clamp(_affine_to_metric(affine, self.dn, self.affine, self.closed_form),
                             0.0, 1.0)
        self.dense.copy_(denormalize_depth(normed, self.dn))

    def state_groups(self, name: str = "step") -> dict[str, list[torch.Tensor]]:
        """The state phase ``name`` reads and writes, by group (the latent,
        the affine, each optimizer state); empty groups left out."""
        return {"latent": [self.latents]}

    def _step_row(self):
        """The step index, t for the batch and the step's coefficient row
        (``tables``), read on the device."""
        k = self.step_index
        # rows by index_select: Python indexing with a 0-d tensor may read it on the host
        t = self.tables.t.index_select(0, k).expand(self.images.shape[0])
        return k, t, self.tables.coeffs.index_select(0, k)[0].unbind(0)

    @torch.no_grad()
    def step_eager(self, k: int, name: str = "step") -> None:
        self.step_index.fill_(k)
        getattr(self, name)()

    def replay(self, k: int, name: str = "step") -> None:
        """Phase ``name``'s step ``k`` through its captured graph."""
        self.step_index.fill_(k)
        self.graphs[name].replay()
        add_launches(self.launch_delta[name])

    def capturable_phase(self, name: str) -> bool:
        return self.capturable if name in self.unet_phases else self.latents.is_cuda

    @torch.no_grad()
    def run(self, cache: ProgramCache | None = None) -> None:
        """One request's phases (see the class docstring)."""
        for name, count in self.phases:
            graph = cache is not None and self.capturable_phase(name)
            ks = range(count)
            if graph and name not in self.graphs:
                self._capture(cache, name)
                ks = range(1, count)
            for k in ks:
                (self.replay if graph else self.step_eager)(k, name)

    def _capture(self, cache: ProgramCache, name: str) -> None:
        """Phase ``name``'s step 0 eagerly on a side stream, then one step
        captured into the cache's pool (PyTorch's whole-network capture
        recipe)."""
        dev = self.latents.device
        cur = torch.cuda.current_stream(dev)
        side = _side_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.step_eager(0, name)
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
                getattr(self, name)()
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
        self.launch_delta[name] = delta
        self.graphs[name] = graph
        self.stats[name] = {"capture_ms": (t1 - t0) * 1e3, "instantiate_ms": (t2 - t1) * 1e3,
                            "pool_growth_bytes": torch.cuda.memory_reserved(dev) - reserved}


class _GuidedProgram(SamplerProgram):
    """A training branch's shared part: the learned affine (unless the
    affine is closed form), the DDIM tables, and ``make_optimizer``'s
    optimizer over the latent and the affine as a ``FixedOptimizer``
    (``opt``, made by the branch for its number of optimizer steps)."""

    def __init__(self, bundle, cfg, sched, remat, images, sparses):
        super().__init__(bundle, cfg, sched, remat, images, sparses)
        dev = images.device
        self.tables = step_tables(sched, make_timesteps(cfg.ddim, cfg.steps), cfg.steps, dev)
        if not self.closed_form:
            self.affine = _initial_affine(images.shape[0], dev)

    def _optimizer(self, num_steps: int) -> FixedOptimizer:
        return FixedOptimizer(self.cfg.opt, [self.latents, *self.affine],
                              [self.cfg.lr_latent] + [self.cfg.lr_scaling] * len(self.affine),
                              num_steps)

    def _reset_affine(self) -> None:
        for p, init in zip(self.affine, (1.0, 0.0)):
            p.fill_(init)

    def reset_state(self) -> None:
        self._reset_affine()
        self.opt.reset()

    def state_groups(self, name: str = "step") -> dict[str, list[torch.Tensor]]:
        groups = {"latent": [self.latents], "affine": self.affine, **self.opt.state}
        return {k: v for k, v in groups.items() if v}


class FusedStepProgram(_GuidedProgram):
    """Per-step guided training with the fused epilogue (Adam; v- or
    ε-prediction, no sample clipping; any ring; UNet remat, fast guidance
    and tensor parallelism as configured): the JAX sampler's scan body
    ``sampler.py:490-511``. The epilogue holds the latent's Adam moments
    (``m``, ``v``) and reads its six scalars from ``epilogue_table``; the
    affine's Adam is a ``FixedOptimizer``."""

    tag = "fused-step"

    def __init__(self, bundle, cfg, sched, remat, images, sparses):
        super().__init__(bundle, cfg, sched, remat, images, sparses)
        dev = images.device
        self.v_pred = sched.config.prediction_type == "v_prediction"
        self.epilogue = epilogue_table(sched, make_timesteps(cfg.ddim, cfg.steps), cfg.steps, dev)
        self.m, self.v = torch.zeros_like(self.latents), torch.zeros_like(self.latents)
        self.affine_opt = FixedOptimizer("adam", self.affine,
                                         [cfg.lr_scaling] * len(self.affine), cfg.steps)

    def reset_state(self) -> None:
        self.m.zero_()
        self.v.zero_()
        self._reset_affine()
        self.affine_opt.reset()

    def state_groups(self, name: str = "step") -> dict[str, list[torch.Tensor]]:
        opt = self.affine_opt.state
        return {k: v for k, v in {"latent": [self.latents], "affine": self.affine,
                                  "adam_m": [self.m, *opt.get("adam_m", [])],
                                  "adam_v": [self.v, *opt.get("adam_v", [])]}.items() if v}

    def step(self) -> None:
        """One guided step at ``step_index`` on the buffers."""
        k, t, (sqrt_a, sqrt_1ma, _, _) = self._step_row()
        lat = self.latents.detach().requires_grad_(True)
        aff = [p.detach().requires_grad_(True) for p in self.affine]
        _, out, grads = guided_step_grads(
            self._denoise, self._decode, self.sched, self.cfg, self.dn, self.images,
            self.orig_res, self.padding, self.closed_form, lat, aff, t, (sqrt_a, sqrt_1ma))
        self.affine_opt.step(grads[1:], k)
        guidance_epilogue(self.latents, grads[0], out, self.m, self.v, self.epilogue, k,
                          lr=self.cfg.lr_latent, v_pred=self.v_pred)


class GeneralStepProgram(_GuidedProgram):
    """Per-step guided training with any other optimizer or schedule (SGD,
    Adagrad, Adam where the epilogue does not apply): the JAX sampler's
    general optax chain (``sampler.py:512-545``). The guided step, the
    ε-norm rescale of the latent gradient, the optimizer (a
    ``FixedOptimizer`` over the latent and the affine), then the DDIM
    transition of the updated latent with the old UNet output."""

    tag = "general-step"

    def __init__(self, bundle, cfg, sched, remat, images, sparses):
        super().__init__(bundle, cfg, sched, remat, images, sparses)
        self.opt = self._optimizer(cfg.steps)

    def step(self) -> None:
        """One guided step at ``step_index`` on the buffers."""
        k, t, (sqrt_a, sqrt_1ma, sqrt_ap, sqrt_1map) = self._step_row()
        n = self.latents.shape[0]
        lat = self.latents.detach().requires_grad_(True)
        aff = [p.detach().requires_grad_(True) for p in self.affine]
        _, out, grads = guided_step_grads(
            self._denoise, self._decode, self.sched, self.cfg, self.dn, self.images,
            self.orig_res, self.padding, self.closed_form, lat, aff, t, (sqrt_a, sqrt_1ma))
        # the ε-norm rescale of the latent gradient, per sample
        eps = pred_epsilon_at(self.sched, out, self.latents, sqrt_a, sqrt_1ma)
        eps_norm = eps.reshape(n, -1).float().norm(dim=1)
        g = grads[0].float()
        g_norm = g.reshape(n, -1).norm(dim=1)
        g = g * (eps_norm / torch.clamp(g_norm, min=EPSILON)).reshape(n, 1, 1, 1)
        self.opt.step([g, *grads[1:]], k)
        new_lat, _ = ddim_step_at(self.sched, out, self.latents, sqrt_a, sqrt_1ma, sqrt_ap,
                                  sqrt_1map)
        self.latents.copy_(new_lat)


class DDIMProgram(SamplerProgram):
    """No training, η=0 DDIM (JAX ``sampler.py:430-437``): per step one UNet
    forward and ``ddim_step``."""

    tag = "ddim"

    def __init__(self, bundle, cfg, sched, remat, images, sparses):
        super().__init__(bundle, cfg, sched, remat, images, sparses)
        self.tables = step_tables(sched, make_timesteps(cfg.ddim, cfg.steps), cfg.steps,
                                  images.device)

    def step(self) -> None:
        _, t, row = self._step_row()
        new_lat, _ = ddim_step_at(self.sched, self._denoise(self.latents, t), self.latents, *row)
        self.latents.copy_(new_lat)


class LCMProgram(SamplerProgram):
    """No training, LCM (JAX ``sampler.py:410-429``): per step one UNet
    forward and ``lcm_step``, its scalars from ``lcm_tables`` and its
    re-noise from ``renoise`` ([steps, N, EH, EW, C], ``lcm_renoise``: JAX's
    key chain for a seed). The seed is not in the program key: ``load``
    draws the table again for a request whose seed is not the one it
    holds."""

    tag = "lcm"

    def __init__(self, bundle, cfg, sched, remat, images, sparses):
        super().__init__(bundle, cfg, sched, remat, images, sparses)
        dev = images.device
        ts = make_lcm_timesteps(cfg.ddim.num_train_timesteps, cfg.steps, cfg.lcm)
        self.tables = lcm_tables(sched, ts, cfg.lcm, dev)
        self.renoise = upload(lcm_renoise(cfg.seed, cfg.steps, tuple(self.latents.shape)), dev)
        self.renoise_seed = cfg.seed

    def load(self, images, sparses, noise, prev, cfg) -> None:
        super().load(images, sparses, noise, prev, cfg)
        if cfg.seed != self.renoise_seed:
            self.renoise.copy_(upload(lcm_renoise(cfg.seed, self.steps,
                                                  tuple(self.latents.shape)),
                                      self.renoise.device))
            self.renoise_seed = cfg.seed

    def step(self) -> None:
        k, t, row = self._step_row()
        noise = self.renoise.index_select(0, k)[0]
        new_lat, _ = lcm_step_at(self.sched, self._denoise(self.latents, t), self.latents, noise,
                                 *row)
        self.latents.copy_(new_lat)


class PerInputProgram(_GuidedProgram):
    """Per-input training (JAX ``sampler.py:549-592``): the DDIM denoise
    (``step``: one UNet forward and ``ddim_step``, ``steps`` times), then
    ``train``, ``train_steps`` times: the guidance loss of the latent's own
    decode, unclamped, its gradient and the optimizer (a ``FixedOptimizer``
    over the latent and the affine, no ε-norm rescale)."""

    tag = "per-input"

    def __init__(self, bundle, cfg, sched, remat, images, sparses):
        super().__init__(bundle, cfg, sched, remat, images, sparses)
        self.train_steps = cfg.train_steps
        self.opt = self._optimizer(cfg.train_steps)

    @property
    def phases(self) -> list[tuple[str, int]]:
        return [("prepare", 1), ("step", self.steps), ("train", self.train_steps),
                ("finish", 1)]

    def state_groups(self, name: str = "step") -> dict[str, list[torch.Tensor]]:
        return super().state_groups() if name == "train" else {"latent": [self.latents]}

    step = DDIMProgram.step

    def train(self) -> None:
        """One training step at ``step_index`` on the buffers."""
        lat = self.latents.detach().requires_grad_(True)
        aff = [p.detach().requires_grad_(True) for p in self.affine]
        _, grads = per_input_grads(self._decode, self.cfg, self.dn, self.images, self.orig_res,
                                   self.padding, self.closed_form, lat, aff)
        self.opt.step(grads, self.step_index)


PROGRAMS = {cls.tag: cls for cls in (FusedStepProgram, GeneralStepProgram, DDIMProgram,
                                     LCMProgram, PerInputProgram)}
