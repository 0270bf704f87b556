"""Visual anagrams: multi-view optical illusions (counterpart of
`lumina_t2x_tpu/pipelines/anagrams.py`).

- views are invertible latent transforms of a (C, H, W) tensor
  (`VIEW_MAP`, 25 of them), written in torch to the JAX package's
  definitions: the permutations come from the same numpy RandomState seeds,
  the rotation samples bilinearly with every tap outside the image reading 0
  (`map_coordinates(order=1, mode="constant")`), and the resampling is
  `jax.image.resize`'s (`image_resize`: Keys' cubic with a = -0.5 and
  border-renormalised weights, the antialiased triangle for "linear");
- phase 1 (`anagram_init_phase`): per step, each (prompt, view) pair
  denoises the viewed latent with a midpoint step; the inverted noises are
  averaged;
- phase 2 (`anagram_upscale_phase`): skip-residual guidance towards the
  upsampled, re-encoded phase-1 image with the cosine decay
  c(t) = 0.5 (1 + cos(pi t)) and a noise inversion between the half-steps;
- each phase is a Python loop over the steps (one `lax.scan` in JAX);
- the tiled VAE averages overlapping windows (`tiled_encode`,
  `tiled_decode`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F


# -- resampling as `jax.image.resize` --------------------------------------------


def _linear_kernel(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic_kernel(x):
    """Keys' cubic convolution kernel with a = -0.5."""
    x = x.abs()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"linear": _linear_kernel, "bicubic": _keys_cubic_kernel}


def _weight_matrix(in_size: int, out_size: int, kernel, device):
    """(in_size, out_size) resampling weights of one axis: the kernel at the
    sample positions, widened by the scale when downsampling (antialias),
    each column renormalised to sum to 1, and zero where the sample lies
    outside the input."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None])
    weights = kernel(x.abs() / kernel_scale)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def image_resize(x, shape: Sequence[int], method: str):
    """`jax.image.resize(x, shape, method)` for "nearest", "linear" and
    "bicubic" (antialiased when downsampling, as JAX's default), in fp32.
    Axes whose size changes are resampled one after another."""
    x = x.float()
    if method == "nearest":
        for d, (m, n) in enumerate(zip(x.shape, shape)):
            if m != n:
                idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * m / n)
                x = x.index_select(d, idx.long().to(x.device))
        return x
    kernel = _KERNELS[method]
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m != n:
            w = _weight_matrix(m, n, kernel, x.device)
            x = torch.tensordot(x.movedim(d, -1), w, dims=1).movedim(-1, d)
    return x


# -- views -------------------------------------------------------------------------


def _set3(x, first3):
    """x with its first 3 channels replaced (JAX's `x.at[:3].set`)."""
    return torch.cat([first3.to(x.dtype), x[3:]], dim=0)


class BaseView:
    """A view / inverse_view pair over (C, H, W) latents."""

    def view(self, x):
        raise NotImplementedError

    def inverse_view(self, x):
        raise NotImplementedError


class IdentityView(BaseView):
    def view(self, x):
        return x

    inverse_view = view


class FlipView(BaseView):
    def view(self, x):
        return torch.flip(x, dims=(-2,))

    inverse_view = view


class Rotate180View(BaseView):
    def view(self, x):
        return torch.rot90(x, 2, dims=(-2, -1))

    inverse_view = view


class Rotate90CWView(BaseView):
    def view(self, x):
        return torch.rot90(x, -1, dims=(-2, -1))

    def inverse_view(self, x):
        return torch.rot90(x, 1, dims=(-2, -1))


class Rotate90CCWView(BaseView):
    def view(self, x):
        return torch.rot90(x, 1, dims=(-2, -1))

    def inverse_view(self, x):
        return torch.rot90(x, -1, dims=(-2, -1))


class NegateView(BaseView):
    def view(self, x):
        return -x

    inverse_view = view


class SkewView(BaseView):
    """Circular row shifts proportional to the row index."""

    def __init__(self, skew_factor: float = 1.5):
        self.skew_factor = skew_factor

    def _roll(self, x, sign):
        return torch.stack([torch.roll(x[..., r, :], int(sign * self.skew_factor * r), dims=-1)
                            for r in range(x.shape[-2])], dim=-2)

    def view(self, x):
        return self._roll(x, 1)

    def inverse_view(self, x):
        return self._roll(x, -1)


class PatchPermuteView(BaseView):
    """A permutation of square patches, from numpy's RandomState(seed)."""

    def __init__(self, num_patches: int = 8, seed: int = 0):
        self.num_patches = num_patches
        self.seed = seed

    def _perm(self, n):
        return np.random.RandomState(self.seed).permutation(n)

    def _apply(self, x, order):
        c, h, w = x.shape[-3:]
        p = self.num_patches
        patches = x.reshape(*x.shape[:-3], c, p, h // p, p, w // p)
        patches = torch.movedim(patches, (-4, -2), (-2, -1))  # (..., c, ph, pw, p, p)
        flat = patches.reshape(*patches.shape[:-2], p * p)
        flat = flat[..., torch.from_numpy(order).to(x.device)]
        patches = torch.movedim(flat.reshape(*patches.shape), (-2, -1), (-4, -2))
        return patches.reshape(x.shape)

    def view(self, x):
        return self._apply(x, self._perm(self.num_patches ** 2))

    def inverse_view(self, x):
        return self._apply(x, np.argsort(self._perm(self.num_patches ** 2)))


class PixelPermuteView(PatchPermuteView):
    def __init__(self, num_patches: int = 32, seed: int = 0):
        super().__init__(num_patches, seed)


class InnerCircleView(BaseView):
    """Rotate the inner disk by 180 degrees (self-inverse)."""

    def view(self, x):
        h, w = x.shape[-2:]
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx = (h - 1) / 2, (w - 1) / 2
        r = min(h, w) * 0.45
        mask = torch.from_numpy(((yy - cy) ** 2 + (xx - cx) ** 2) < r**2).to(x.device)
        return torch.where(mask, torch.rot90(x, 2, dims=(-2, -1)), x)

    inverse_view = view


class SquareHingeView(BaseView):
    """Rotate each quadrant by 180 degrees in place."""

    def view(self, x):
        hh, hw = x.shape[-2] // 2, x.shape[-1] // 2
        q = lambda a: torch.rot90(a, 2, dims=(-2, -1))
        top = torch.cat([q(x[..., :hh, :hw]), q(x[..., :hh, hw:])], dim=-1)
        bot = torch.cat([q(x[..., hh:, :hw]), q(x[..., hh:, hw:])], dim=-1)
        return torch.cat([top, bot], dim=-2)

    inverse_view = view


def _reflect_index(n: int, half: int):
    """numpy's `pad(mode="reflect")` source indices of an axis of n padded by
    `half` on both sides (the reflection repeats when half >= n)."""
    i = np.arange(-half, n + half)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    m = np.mod(i, period)
    return np.where(m >= n, period - m, m)


def gaussian_blur(x, sigma: float, kernel_size: int):
    """Separable 2-D Gaussian blur over (..., H, W), reflect padding, fp32."""
    if kernel_size % 2 == 0:
        raise ValueError(f"gaussian_blur kernel_size must be odd, got {kernel_size}")
    half = kernel_size // 2
    t = np.arange(kernel_size) - half
    k = np.exp(-(t**2) / (2.0 * sigma**2))
    k = torch.tensor(k / k.sum(), dtype=torch.float32, device=x.device)

    def conv1d(a, axis):
        a = a.movedim(axis, -1)
        idx = torch.from_numpy(_reflect_index(a.shape[-1], half)).to(x.device)
        padded = a.index_select(-1, idx)
        out = F.conv1d(padded.reshape(-1, 1, padded.shape[-1]), k.flip(0)[None, None])
        return out.reshape(*a.shape).movedim(-1, axis)

    return conv1d(conv1d(x.float(), -2), -1).to(x.dtype)


def _scaled_blur(noise, sigma, kernel_size):
    """The blur kernel scaled with the latent size (64 rows per factor)."""
    factor = max(noise.shape[-2] // 64, 1)
    return gaussian_blur(noise, sigma * factor, kernel_size * factor + ((factor + 1) % 2))


class GrayscaleView(BaseView):
    """Factorized diffusion: the inverse projects the first 3 channels onto
    their mean."""

    def view(self, x):
        return x

    def inverse_view(self, x):
        gray = x[:3].mean(dim=0, keepdim=True)
        return _set3(x, gray.expand_as(x[:3]))


class ColorView(BaseView):
    """The inverse keeps the colour residual."""

    def view(self, x):
        return x

    def inverse_view(self, x):
        return _set3(x, x[:3] - x[:3].mean(dim=0, keepdim=True))


class HybridLowPassView(BaseView):
    """The inverse keeps the low-frequency band."""

    def __init__(self, sigma: float = 2.0, kernel_size: int = 33):
        self.sigma, self.kernel_size = sigma, kernel_size

    def view(self, x):
        return x

    def inverse_view(self, x):
        return _set3(x, _scaled_blur(x[:3], self.sigma, self.kernel_size))


class HybridHighPassView(HybridLowPassView):
    def inverse_view(self, x):
        return _set3(x, x[:3] - _scaled_blur(x[:3], self.sigma, self.kernel_size))


class TripleHybridLowPassView(BaseView):
    def __init__(self, sigma_1: float = 1.0, sigma_2: float = 4.0, kernel_size: int = 33):
        self.sigma_1, self.sigma_2, self.kernel_size = sigma_1, sigma_2, kernel_size

    def view(self, x):
        return x

    def _bands(self, x):
        lp = _scaled_blur(x[:3], self.sigma_2, self.kernel_size)
        mid_cut = _scaled_blur(x[:3], self.sigma_1, self.kernel_size)
        return lp, mid_cut - lp, x[:3] - mid_cut

    def inverse_view(self, x):
        return _set3(x, self._bands(x)[0])


class TripleHybridMediumPassView(TripleHybridLowPassView):
    def inverse_view(self, x):
        return _set3(x, self._bands(x)[1])


class TripleHybridHighPassView(TripleHybridLowPassView):
    def inverse_view(self, x):
        return _set3(x, self._bands(x)[2])


class JigsawView(BaseView):
    """Procedural jigsaw: a seeded permutation of grid pieces and per-piece
    180-degree rotations (numpy's RandomState(seed))."""

    def __init__(self, grid: int = 4, seed: int = 0):
        self.grid = grid
        rng = np.random.RandomState(seed)
        self.perm = rng.permutation(grid * grid)
        self.rots = rng.randint(0, 2, grid * grid) * 2  # 0 or 180 degrees

    def _pieces(self, x):
        c, h, w = x.shape[-3:]
        g = self.grid
        return x.reshape(c, g, h // g, g, w // g).permute(1, 3, 0, 2, 4).reshape(
            g * g, c, h // g, w // g)

    def _assemble(self, pieces, shape):
        c, h, w = shape
        g = self.grid
        return pieces.reshape(g, g, c, h // g, w // g).permute(2, 0, 3, 1, 4).reshape(c, h, w)

    def view(self, x):
        pieces = self._pieces(x)
        rot = torch.stack([torch.rot90(pieces[i], int(self.rots[i] // 90), dims=(-2, -1))
                           for i in range(len(self.perm))])
        return self._assemble(rot[torch.from_numpy(self.perm).to(x.device)], x.shape[-3:])

    def inverse_view(self, x):
        pieces = self._pieces(x)
        unperm = pieces[torch.from_numpy(np.argsort(self.perm)).to(x.device)]
        unrot = torch.stack([torch.rot90(unperm[i], -int(self.rots[i] // 90), dims=(-2, -1))
                             for i in range(len(self.perm))])
        return self._assemble(unrot, x.shape[-3:])


class ScaleView(BaseView):
    """view = identity; the inverse scales the first 3 channels."""

    def __init__(self, scale: float = 0.5):
        self.scale = scale

    def view(self, x):
        return x

    def inverse_view(self, x):
        return _set3(x, self.scale * x[:3])


class WhiteBalanceViewFailure(BaseView):
    """The 'dress illusion' attempt: view scales the first 3 channels by a
    constant, the inverse divides them (a known-failure view, kept for
    parity)."""

    def __init__(self, factor: float = 1.5):
        self.factor = factor

    def view(self, x):
        return _set3(x, self.factor * x[:3])

    def inverse_view(self, x):
        return _set3(x, x[:3] / self.factor)


class BlurViewFailure(BaseView):
    """Blur by a linear downsample then upsample; not invertible, so the
    inverse passes through."""

    def __init__(self, factor: int = 8):
        self.factor = int(factor)

    def view(self, x):
        h, w = x.shape[-2:]
        small = image_resize(x, (*x.shape[:-2], h // self.factor, w // self.factor), "linear")
        return image_resize(small, x.shape, "linear").to(x.dtype)

    def inverse_view(self, x):
        return x


def _diagonal_blur(x, size: int):
    """Depthwise convolution with eye(size) / size (a diagonal streak),
    padding size // 2."""
    c = x.shape[-3]
    k = (torch.eye(size, dtype=torch.float32, device=x.device) / size)[None, None]
    out = F.conv2d(x.float().reshape(-1, c, *x.shape[-2:]), k.repeat(c, 1, 1, 1),
                   padding=size // 2, groups=c)
    return out.reshape(x.shape).to(x.dtype)


class MotionBlurView(BaseView):
    """view = identity; the inverse blurs the first 3 channels along the
    diagonal, kernel size scaled by h // 64 and kept odd."""

    def __init__(self, size: int = 7):
        self.size = int(size)

    def _kernel_size(self, h: int) -> int:
        factor = max(h // 64, 1)
        return self.size * factor + ((factor + 1) % 2)

    def view(self, x):
        return x

    def inverse_view(self, x):
        return _set3(x, _diagonal_blur(x[:3], self._kernel_size(x.shape[-2])))

    def save_view(self, x):
        """The whole image blurred, for saving."""
        return _diagonal_blur(x, self._kernel_size(x.shape[-2]))


class MotionBlurResView(MotionBlurView):
    """Residual variant: the inverse keeps x - blur(x)."""

    def inverse_view(self, x):
        return _set3(x, x[:3] - _diagonal_blur(x[:3], self._kernel_size(x.shape[-2])))


def _rotate_bilinear(x, angle_deg: float):
    """Counter-clockwise bilinear rotation about the image centre: each
    output pixel samples the source at the coordinates rotated the other
    way, with the four taps weighted bilinearly and every tap outside the
    image reading 0."""
    h, w = x.shape[-2:]
    dev = x.device
    theta = torch.deg2rad(torch.tensor(angle_deg, dtype=torch.float32))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(h, device=dev) - cy, torch.arange(w, device=dev) - cx,
                            indexing="ij")
    cos, sin = torch.cos(theta).to(dev), torch.sin(theta).to(dev)
    src = (cos * yy + sin * xx + cy, -sin * yy + cos * xx + cx)
    flat = x.reshape(-1, h, w).float()
    taps = []
    for coord in src:
        lower = torch.floor(coord)
        upper_w = coord - lower
        idx = lower.long()
        taps.append([(idx, 1.0 - upper_w), (idx + 1, upper_w)])
    out = torch.zeros_like(flat)
    for iy, wy in taps[0]:
        for ix, wx in taps[1]:
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            vals = flat[:, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
            out = out + (wy * wx) * torch.where(valid, vals, torch.zeros_like(vals))
    return out.reshape(x.shape).to(x.dtype)


class InnerCircleViewFailure(BaseView):
    """Bilinear (lossy) rotation of the inner disk of radius 3/8 * size by
    `angle` degrees; the inverse rotates by -angle (a known-failure view,
    kept for parity)."""

    def __init__(self, interpolation: str = "bilinear", angle: float = 135.0):
        if interpolation != "bilinear":
            raise NotImplementedError("only bilinear interpolation is supported")
        self.angle = angle

    def _masked_rotate(self, x, angle):
        size = x.shape[-1]
        r = int(size / 8 * 3)
        coords = torch.arange(size, dtype=torch.float32, device=x.device) - size / 2.0
        yy, xx = torch.meshgrid(coords, coords, indexing="ij")
        mask = (xx**2 + yy**2 < r**2).to(x.dtype)
        return mask * _rotate_bilinear(x, angle) + (1 - mask) * x

    def view(self, x):
        return self._masked_rotate(x, self.angle)

    def inverse_view(self, x):
        return self._masked_rotate(x, -self.angle)


VIEW_MAP: Dict[str, Callable[[], BaseView]] = {
    "identity": IdentityView,
    "flip": FlipView,
    "rotate_cw": Rotate90CWView,
    "rotate_ccw": Rotate90CCWView,
    "rotate_180": Rotate180View,
    "negate": NegateView,
    "skew": SkewView,
    "patch_permute": PatchPermuteView,
    "pixel_permute": PixelPermuteView,
    "inner_circle": InnerCircleView,
    "square_hinge": SquareHingeView,
    "jigsaw": JigsawView,
    "grayscale": GrayscaleView,
    "color": ColorView,
    "low_pass": HybridLowPassView,
    "high_pass": HybridHighPassView,
    "triple_low_pass": TripleHybridLowPassView,
    "triple_medium_pass": TripleHybridMediumPassView,
    "triple_high_pass": TripleHybridHighPassView,
    "scale": ScaleView,
    "white_balance_failure": WhiteBalanceViewFailure,
    "blur_failure": BlurViewFailure,
    "inner_circle_failure": InnerCircleViewFailure,
    "motion": MotionBlurView,
    "motion_res": MotionBlurResView,
}


def get_anagrams_views(view_names: Sequence[str], view_args=None) -> List[BaseView]:
    """Views by name, each built with its argument when one is given."""
    views = []
    view_args = view_args or [None] * len(view_names)
    for name, arg in zip(view_names, view_args):
        cls = VIEW_MAP.get(name)
        if cls is None:
            raise NotImplementedError(f"view {name!r} not available (known: {sorted(VIEW_MAP)})")
        views.append(cls(arg) if arg is not None else cls())
    return views


# -- the two phases ----------------------------------------------------------------


def _times(b, t, like):
    return torch.full((b,), float(t), dtype=torch.float32, device=like.device)


def midpoint_delta(func, t0: float, t1: float, y0):
    """dt * f(y0 + f(y0, t0) dt / 2, t0 + dt / 2): one midpoint step's
    displacement."""
    b = y0.shape[0]
    dt = t1 - t0
    f0 = func(y0, _times(b, t0, y0))
    return func(y0 + f0 * (0.5 * dt), _times(b, t0 + 0.5 * dt, y0)) * dt


def midpoint_delta_extra(func, t0: float, t1: float, y0, guidance, noise, anchor, view_fn):
    """The skip-residual guided midpoint step: the model input is
    (1 - c) y + c guidance_t with c(t) = 0.5 (1 + cos(pi t)), viewed; the
    half-step inverts the predicted noise through the view."""
    b = y0.shape[0]
    dt = t1 - t0
    half_dt = 0.5 * dt
    t_mid = t0 + half_dt

    def viewed_input(y, t):
        c = 0.5 * (1.0 + math.cos(math.pi * t))
        guidance_t = (t * guidance + (1.0 - t) * noise) / anchor
        model_input = (1.0 - c) * y + c * guidance_t
        return torch.stack([view_fn.view(model_input[0])] * b)

    f0 = func(viewed_input(y0, t0), _times(b, t0, y0))
    inv = view_fn.inverse_view((-f0 * half_dt)[0])
    y_mid = y0 - torch.stack([inv] * b)
    return func(viewed_input(y_mid, t_mid), _times(b, t_mid, y0)) * dt


def _pairs(timesteps):
    ts = [float(t) for t in timesteps]
    return list(zip(ts[:-1], ts[1:]))


def anagram_init_phase(model_fns: Sequence[Callable], views: Sequence[BaseView], z, timesteps):
    """Phase 1: per step, the mean over (prompt, view) pairs of the
    view-inverted midpoint noise predictions is taken off the latent."""
    x = z
    for t0, t1 in _pairs(timesteps):
        inverted = []
        for fn, view_fn in zip(model_fns, views):
            viewed = torch.stack([view_fn.view(x[0])] * x.shape[0])
            inverted.append(view_fn.inverse_view(-midpoint_delta(fn, t0, t1, viewed)[0]))
        x = x - torch.stack(inverted).mean(dim=0)[None]
    return x


def anagram_upscale_phase(model_fns: Sequence[Callable], views: Sequence[BaseView], z,
                          guidance, timesteps):
    """Phase 2: skip-residual guided refinement from the noise z towards
    `guidance` (the re-encoded, upsampled phase-1 image)."""
    anchor = torch.ones_like(guidance)
    x = z
    for t0, t1 in _pairs(timesteps):
        inverted = []
        for fn, view_fn in zip(model_fns, views):
            d = -midpoint_delta_extra(fn, t0, t1, x, guidance, z, anchor, view_fn)
            inverted.append(view_fn.inverse_view(d[0]))
        x = x - torch.stack(inverted).mean(dim=0)[None]
    return x


# -- tiled VAE ---------------------------------------------------------------------


def get_tile_views(height: int, width: int, window_size: int = 128, stride: int = 64):
    """MultiDiffusion-style window coordinates (h0, h1, w0, w1)."""
    nh = int((height - window_size) / stride - 1e-6) + 2 if height > window_size else 1
    nw = int((width - window_size) / stride - 1e-6) + 2 if width > window_size else 1
    views = []
    for i in range(nh * nw):
        h_start, w_start = (i // nw) * stride, (i % nw) * stride
        h_end, w_end = h_start + window_size, w_start + window_size
        if h_end > height:
            h_start, h_end = height - window_size, height
        if w_end > width:
            w_start, w_end = width - window_size, width
        views.append((max(h_start, 0), h_end, max(w_start, 0), w_end))
    return views


def tiled_apply(fn: Callable, x, window: int, stride: int, scale: float, out_channels: int):
    """`fn` over overlapping windows of x (coordinates in x's space), the
    overlaps averaged, in fp32; `scale` is the output's size over the
    input's (1/8 to encode, 8 to decode)."""
    b, _, h, w = x.shape
    o = lambda v: int(v * scale)
    out = torch.zeros((b, out_channels, o(h), o(w)), dtype=torch.float32, device=x.device)
    count = torch.zeros((1, 1, o(h), o(w)), dtype=torch.float32, device=x.device)
    for hs, he, ws, we in get_tile_views(h, w, window, stride):
        out[:, :, o(hs):o(he), o(ws):o(we)] += fn(x[:, :, hs:he, ws:we]).float()
        count[:, :, o(hs):o(he), o(ws):o(we)] += 1.0
    return out / count


def tiled_encode(encode_fn: Callable, images, window: int = 1024, stride: int = 512):
    """images (B, 3, H, W) -> latents (B, 4, H/8, W/8) over overlapping
    windows."""
    return tiled_apply(encode_fn, images, window, stride, scale=1 / 8, out_channels=4)


def tiled_decode(decode_fn: Callable, latents, window: int = 128, stride: int = 64):
    """latents (B, 4, h, w) -> images (B, 3, 8h, 8w) over overlapping
    windows."""
    return tiled_apply(decode_fn, latents, window, stride, scale=8, out_channels=3)
