"""The plain guided sampler (Marigold-DC, per-step guidance), float32.

One request: preprocess (scale to [-1, 1], antialiased resize of the longer
side to the processing resolution, edge padding to 16), encode, the initial
latent (JAX's threefry normal for the sampler seed, shared by the batch,
mixed with a carried latent by β), the sparse normalisation (``const``:
[min_depth, max_depth]), then ``steps`` trailing-DDIM steps, each:

    out = UNet(img_latent ⊕ z, t);  x0 = √ᾱ·z − √(1−ᾱ)·out   (v-prediction)
    d   = clamp(s²·(g_max − g_min)·resize(decode(x0)) + t²·g_min, 0, 1)
    L   = Σ_samples mean_masked(|d − g|) + mean_masked((d − g)²)
    (s, t) ← Adam(∂L/∂(s, t));  ĝ = ∂L/∂z · ‖ε̂‖ / max(‖∂L/∂z‖, 1e-7)
    z ← Adam(ĝ);  z ← √ᾱ'·(√ᾱ·z − √(1−ᾱ)·out) + √(1−ᾱ')·(√ᾱ·out + √(1−ᾱ)·z)

and the final decode to metric depth. Written from the method's
description and the JAX original's equations; it imports nothing of the
system under test.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.models import VAE, text_context, unet

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LATENT_ALIGN = 16

# -- JAX's default random numbers (threefry2x32, partitionable) -------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                        1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                        2.83297682], np.float32)


def _threefry(key, x0, x1):
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = ((x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def _counters(n):
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def initial_noise(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(split(PRNGKey(seed))[1], shape)``: float32."""
    key = np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)
    b0, b1 = _threefry(key, *_counters(2))
    sub = np.array([b0[1], b1[1]], np.uint32)
    w0, w1 = _threefry(sub, *_counters(int(np.prod(shape))))
    bits = ((w0 ^ w1) >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = np.maximum(lo, (bits.view(np.float32) - np.float32(1.0)) * (np.float32(1.0) - lo) + lo)
    # XLA's float32 erfinv (Giles' polynomial; each step one fused multiply-add)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = (-np.log1p(-(u * u).astype(np.float64))).astype(np.float32)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
        for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = (np.where(lt, c_lt, c_ge).astype(np.float64) + p * w.astype(np.float64)).astype(
                np.float32)
    return (np.float32(np.sqrt(2)) * (p * u)).astype(np.float32).reshape(shape)


# -- the DDIM schedule ------------------------------------------------------

def schedule(cfg: dict) -> tuple[np.ndarray, list[tuple[int, float, float, float, float]]]:
    """(ᾱ [T] float32, per step (t, √ᾱ_t, √(1−ᾱ_t), √ᾱ_prev, √(1−ᾱ_prev)))
    for scaled-linear betas and trailing spacing."""
    T, steps = cfg["num_train_timesteps"], cfg["steps"]
    betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, T, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas).astype(np.float32)

    def coeffs(t):
        a = np.float32(acp[t] if t >= 0 else acp[0])  # set_alpha_to_one off
        return float(np.sqrt(a)), float(np.sqrt(np.float32(1.0) - a))

    ts = np.round(np.arange(T, 0, -T / steps)).astype(np.int32) - 1
    return acp, [(int(t), *coeffs(int(t)), *coeffs(int(t) - T // steps)) for t in ts]


# -- resize (jax.image.resize, antialiased) ---------------------------------

def _weights(n_in: int, n_out: int) -> np.ndarray:
    """The antialiased triangle kernel's [out, in] matrix at half-pixel
    centres, each output's weights normalised by their sum."""
    f32 = np.float32
    inv = 1.0 / (n_out / n_in)
    kscale = f32(max(inv, 1.0))
    centre = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv) - f32(0.5)
    x = np.abs(centre[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kscale
    w = np.maximum(f32(0), f32(1) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    w = np.where(((centre >= -0.5) & (centre <= n_in - 0.5))[None, :], w, f32(0))
    return np.ascontiguousarray(w.T, dtype=f32)


def resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    out = x.float()
    for axis, n_out, spec in ((1, size[0], "oh,nhwc->nowc"), (2, size[1], "ow,nhwc->nhoc")):
        if out.shape[axis] != n_out:
            wm = torch.from_numpy(_weights(out.shape[axis], n_out)).to(out.device)
            out = torch.einsum(spec, wm, out)
    return out


def preprocess(images: torch.Tensor, resolution: int):
    """Raw [N, H, W, 3] (0..255) → ([N, PH, PW, 3] in [-1, 1], padding)."""
    _, h, w, _ = images.shape
    m = max(h, w)
    x = resize(images.float() / 255.0 * 2.0 - 1.0, (resolution * h // m, resolution * w // m))
    ph, pw = -x.shape[1] % LATENT_ALIGN, -x.shape[2] % LATENT_ALIGN
    if ph or pw:
        x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                                    mode="replicate").permute(0, 2, 3, 1)
    return x, (ph, pw)


# -- the sampler --------------------------------------------------------------

class Reference:
    """The plain sampler over one configuration's parameter trees.

    ``params``: {"unet", "vae", "text_encoder"} trees; ``config``: the
    configuration file's dict; ``request``: the traffic's sampler settings
    (steps, resolution, norm, losses, learning rates, β, seed, depths)."""

    def __init__(self, params: dict, config: dict, request: dict):
        if request["norm"] != "const" or tuple(request["loss_funcs"]) != ("l1", "l2"):
            raise ValueError("the reference runs norm=const with the l1+l2 losses")
        self.unet_params, self.unet_cfg = params["unet"], config["unet"]
        self.vae = VAE(config["vae_kind"], params["vae"], config["vae"])
        self.text_params, self.text_cfg = params["text_encoder"], config["text"]
        self.req = request
        sched = dict(config["scheduler"], steps=request["steps"])
        self.rows = schedule(sched)[1]
        self._ctx = None

    def context(self) -> torch.Tensor:
        if self._ctx is None:
            with torch.no_grad():
                self._ctx = text_context(self.text_params, self.text_cfg)
        return self._ctx

    def prepare(self, nx, images, carry=None):
        """→ (image latents, initial latent, padding)."""
        r = self.req
        x, padding = preprocess(images, r["resolution"])
        img_latents = self.vae.encode(nx, x)
        n, eh, ew, c = img_latents.shape
        z = torch.from_numpy(initial_noise(r["seed"], (1, eh, ew, c))).to(images.device)
        z = z.expand(n, -1, -1, -1)
        if carry is not None:
            z = r["beta"] * z + (1.0 - r["beta"]) * carry.float()
        return img_latents, z.contiguous(), padding

    def decoded(self, nx, latents, padding, orig):
        """``latents`` decoded to depth in [0, 1], cropped and resized to the
        frame: what the learned affine maps to metric depth."""
        d = self.vae.decode_depth(nx, latents)
        ph, pw = padding
        return resize(d[:, : d.shape[1] - ph, : d.shape[2] - pw], orig)

    def _metric(self, nx, latents, padding, orig, gmin, gmax, scale, shift):
        d = self.decoded(nx, latents, padding, orig)
        return scale.square() * (gmax - gmin) * d + shift.square() * gmin

    def step(self, nx, k, img_latents, z, padding, orig, sparse_n, mask, gmin, gmax, state):
        """One guided step → the next latent (``state``: Adam moments and
        the affine, updated in place)."""
        t, sa, s1, sap, s1p = self.rows[k]
        n = z.shape[0]
        ctx = self.context().expand(n, -1, -1)
        tt = torch.full((n,), t, dtype=torch.int64, device=z.device)
        with torch.enable_grad():
            lat = z.detach().requires_grad_(True)
            aff = [p.detach().requires_grad_(True) for p in state["affine"]]
            out = unet(nx, self.unet_params, torch.cat([img_latents, lat], dim=-1), tt, ctx,
                       self.unet_cfg)
            x0 = sa * lat - s1 * out
            d = torch.clamp(self._metric(nx, x0, padding, orig, gmin, gmax, *aff), 0.0, 1.0)
            m = mask.float()
            valid = torch.clamp(m.sum(dim=(1, 2, 3)), min=1.0)
            loss = (((d - sparse_n).abs() * m).sum(dim=(1, 2, 3))
                    + ((d - sparse_n).square() * m).sum(dim=(1, 2, 3))) / valid
            grads = torch.autograd.grad(loss.sum(), [lat, *aff])
        out = out.detach()
        c = k + 1
        # the affine: torch.optim.Adam's step
        for p, g, m_, v_ in zip(state["affine"], grads[1:], state["am"], state["av"]):
            m_.lerp_(g, 1 - ADAM_B1)
            v_.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
            step = self.req["lr_scaling"] / (1 - ADAM_B1 ** c)
            p.sub_(step * m_ / (v_.sqrt() / (1 - ADAM_B2 ** c) ** 0.5 + ADAM_EPS))
        # the latent: ε-norm rescale, Adam, then the DDIM transition
        eps_hat = sa * out + s1 * z
        g = grads[0]
        g = g * (eps_hat.reshape(n, -1).norm(dim=1)
                 / torch.clamp(g.reshape(n, -1).norm(dim=1), min=1e-7)).reshape(n, 1, 1, 1)
        state["m"] = ADAM_B1 * state["m"] + (1 - ADAM_B1) * g
        state["v"] = ADAM_B2 * state["v"] + (1 - ADAM_B2) * g * g
        bc1, bc2 = 1 / (1 - ADAM_B1 ** c), 1 / (1 - ADAM_B2 ** c)
        z = z - self.req["lr_latent"] * state["m"] * bc1 / (torch.sqrt(state["v"] * bc2) + ADAM_EPS)
        return sap * (sa * z - s1 * out) + s1p * (sa * out + s1 * z)

    @torch.no_grad()
    def __call__(self, nx, images, sparses, carry=None):
        """One request → (metric depth [N, H, W, 1], final latent)."""
        r = self.req
        n, h, w, _ = images.shape
        img_latents, z, padding = self.prepare(nx, images, carry)
        s = sparses.float()
        mask = s > 0
        lo, hi = float(r["min_depth"]), float(r["max_depth"])
        sparse_n = (torch.clamp(s, lo, hi) - lo) / (hi - lo)
        flat, fm = sparse_n.reshape(n, -1), mask.reshape(n, -1)
        gmin = torch.where(fm, flat, float("inf")).amin(dim=1).reshape(n, 1, 1, 1)
        gmax = torch.where(fm, flat, float("-inf")).amax(dim=1).reshape(n, 1, 1, 1)
        dev = images.device
        state = {"affine": [torch.ones((n, 1, 1, 1), device=dev),
                            torch.zeros((n, 1, 1, 1), device=dev)],
                 "am": [torch.zeros((n, 1, 1, 1), device=dev) for _ in range(2)],
                 "av": [torch.zeros((n, 1, 1, 1), device=dev) for _ in range(2)],
                 "m": torch.zeros_like(z), "v": torch.zeros_like(z)}
        for k in range(r["steps"]):
            z = self.step(nx, k, img_latents, z, padding, (h, w), sparse_n, mask, gmin, gmax,
                          state)
        d = torch.clamp(self._metric(nx, z, padding, (h, w), gmin, gmax, *state["affine"]),
                        0.0, 1.0)
        return d * (hi - lo) + lo, z
