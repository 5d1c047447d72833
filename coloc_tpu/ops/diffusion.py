"""Nonlinear diffusion scale space (AKAZE backbone).

Reference parity: the OpenMVG AKAZE path (CPUDetector.hpp + AKAZE.hpp) builds
a nonlinear scale space by Fast Explicit Diffusion: octaves of evolution
levels where image structure diffuses everywhere EXCEPT across strong edges
(Perona-Malik conductivity), then detects scale-space extrema of the Hessian
determinant. Every FED step here is a 5-point stencil over the whole image
(elementwise work that XLA fuses), with trace-static FED cycle lengths.

Conventions follow the standard KAZE/AKAZE formulation:
  - conductivity g2 = 1 / (1 + |grad L|^2 / k^2) (Perona-Malik).
  - contrast k = 70th percentile of gradient magnitudes of the base image.
  - evolution times t_i = sigma_i^2 / 2, sigma_i = sigma0 * 2^(o + s/S).
  - FED cycle: n steps with tau_j = tau_max / (2 cos^2(pi (2j+1)/(4n+2))),
    rescaled to sum to the required time advance; tau_max = 0.25 (2-D
    explicit stability bound).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp


class Evolution(NamedTuple):
    """One nonlinear scale-space level."""

    L: jnp.ndarray        # (H, W) diffused image
    Lx: jnp.ndarray       # (H, W) Scharr x-derivative (at feature scale)
    Ly: jnp.ndarray       # (H, W)
    response: jnp.ndarray # (H, W) sigma^2-normalized Hessian determinant
    sigma: float          # scale in base-image pixels
    octave: int           # downsampling power


def _scharr(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scharr 3x3 derivatives (the derivative stencil AKAZE uses)."""
    p = jnp.pad(img, 1, mode="edge")
    h, w = img.shape

    def s(dy, dx):
        return p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    gx = (
        3.0 * (s(-1, 1) - s(-1, -1))
        + 10.0 * (s(0, 1) - s(0, -1))
        + 3.0 * (s(1, 1) - s(1, -1))
    ) / 32.0
    gy = (
        3.0 * (s(1, -1) - s(-1, -1))
        + 10.0 * (s(1, 0) - s(-1, 0))
        + 3.0 * (s(1, 1) - s(-1, 1))
    ) / 32.0
    return gx, gy


def contrast_factor(
    image: jnp.ndarray, percentile: float = 70.0, nbins: int = 300
) -> jnp.ndarray:
    """k = percentile of nonzero gradient magnitudes.

    OpenMVG/KAZE parity (Compute_Contrast_Factor): a 300-bin histogram of
    gradient magnitudes, k = hmax * b / nbins at the first bin b whose
    cumulative count reaches the percentile, found by a binary search of
    compare-reduce passes rather than a full sort.
    """
    gx, gy = _scharr(image)
    mag = jnp.sqrt(gx * gx + gy * gy)
    pos = mag > 1e-6
    hmax = jnp.maximum(jnp.max(mag), 1e-6)
    idx = jnp.minimum((mag / hmax * nbins).astype(jnp.int32), nbins - 1)
    npos = jnp.sum(pos.astype(jnp.int32))
    target = (percentile / 100.0) * npos.astype(jnp.float32)
    # first bin b with cumcount(idx <= b) >= target, by binary search:
    # ceil(log2(nbins)) full-image reductions instead of a materialized
    # (nbins, N) histogram or a full sort
    steps = max(int(math.ceil(math.log2(nbins))), 1)

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        cnt = jnp.sum((pos & (idx <= mid)).astype(jnp.int32))
        reached = cnt.astype(jnp.float32) >= target
        return jnp.where(reached, lo, mid + 1), jnp.where(reached, mid, hi)

    b, _ = jax.lax.fori_loop(
        0, steps, body, (jnp.int32(0), jnp.int32(nbins - 1))
    )
    k = hmax * (b.astype(jnp.float32) + 1.0) / nbins
    return jnp.maximum(k, 1e-3)


def fed_tau_cycle(T: float, tau_max: float = 0.25) -> List[float]:
    """FED step sizes summing to T (fed_tau_by_process_time equivalent).

    Static python computation — cycle lengths are baked into the trace.
    """
    n = max(int(math.ceil(math.sqrt(3.0 * T / tau_max + 0.25) - 0.5 - 1e-8)) + 1, 1)
    taus = [
        tau_max / (2.0 * math.cos(math.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
        for j in range(n)
    ]
    scale = T / sum(taus)
    return [t * scale for t in taus]


def _diffusion_step(L: jnp.ndarray, g: jnp.ndarray, tau: float) -> jnp.ndarray:
    """One explicit step of div(g grad L) with conductivities on half-grid
    (the standard KAZE discretization)."""
    p = jnp.pad(L, 1, mode="edge")
    gp = jnp.pad(g, 1, mode="edge")
    h, w = L.shape

    def s(a, dy, dx):
        return a[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    # half-point conductivities
    g_e = 0.5 * (g + s(gp, 0, 1))
    g_w = 0.5 * (g + s(gp, 0, -1))
    g_s = 0.5 * (g + s(gp, 1, 0))
    g_n = 0.5 * (g + s(gp, -1, 0))

    flux = (
        g_e * (s(p, 0, 1) - L)
        + g_w * (s(p, 0, -1) - L)
        + g_s * (s(p, 1, 0) - L)
        + g_n * (s(p, -1, 0) - L)
    )
    return L + tau * flux


def _hessian_response(L: jnp.ndarray, sigma_px: float):
    """sigma^2-normalized Hessian determinant + first derivatives."""
    Lx, Ly = _scharr(L)
    Lxx, Lxy = _scharr(Lx)
    _, Lyy = _scharr(Ly)
    det = Lxx * Lyy - Lxy * Lxy
    return (sigma_px ** 2) ** 2 * det, Lx, Ly
    # note: KAZE normalizes derivatives by sigma; det of second derivatives
    # scales as sigma^4


def build_scale_space(
    image: jnp.ndarray,
    num_octaves: int = 4,
    num_sublevels: int = 4,
    sigma0: float = 1.6,
    percentile: float = 70.0,
) -> List[Evolution]:
    """Nonlinear scale space (AKAZE Create_Nonlinear_Scale_Space parity).

    Single-image form of build_scale_space_batch (B = 1, leading axis
    squeezed).
    """
    levels = build_scale_space_batch(
        image[None], num_octaves, num_sublevels, sigma0, percentile
    )
    return [
        Evolution(L=ev.L[0], Lx=ev.Lx[0], Ly=ev.Ly[0],
                  response=ev.response[0], sigma=ev.sigma, octave=ev.octave)
        for ev in levels
    ]


def build_scale_space_batch(
    images: jnp.ndarray,
    num_octaves: int = 4,
    num_sublevels: int = 4,
    sigma0: float = 1.6,
    percentile: float = 70.0,
    tau_max: float = 0.25,
) -> List[Evolution]:
    """Batched nonlinear scale space: (B, H, W) -> Evolution fields
    (B, h_o, w_o).

    Octave o holds the image at 2^-o resolution; each sublevel advances the
    diffusion to t = sigma^2/2 with one FED cycle. All loop lengths are
    static (sigma schedule known at trace time). The batch is vmapped — not
    B unrolled pipeline copies.
    """
    img = images.astype(jnp.float32) / 255.0
    # initial smoothing to sigma0 (approximated by a short linear diffusion)
    k = jax.vmap(lambda im: contrast_factor(im, percentile))(img)
    k2 = k * k

    levels: List[Evolution] = []
    L = img
    t_prev = 0.5 * 0.5 ** 2  # assume camera blur sigma ~0.5
    for o in range(num_octaves):
        # static per-octave schedule: (sigma, tau cycle) per sublevel.
        # Time is advanced on the CURRENT octave's grid: downsampling by 2
        # scales time by 4.
        grid_scale = 4.0 ** o
        sigmas, cycles = [], []
        for s in range(num_sublevels):
            sigma = sigma0 * (2.0 ** (o + s / num_sublevels))
            t = 0.5 * sigma * sigma
            dt = max((t - t_prev) / grid_scale, 1e-4)
            sigmas.append(sigma)
            cycles.append(tuple(fed_tau_cycle(dt, tau_max)))
            t_prev = t

        # per-step stencils, vmapped over the batch.
        # FED semantics (and OpenMVG AKAZE parity): the conductivity is
        # computed ONCE per cycle and held FIXED across the cycle's
        # explicit steps — the varying tau schedule is only stable as a
        # cycle of steps of one linear operator.
        def octave(L1, k21):
            outs = []
            for s, taus in enumerate(cycles):
                gx, gy = _scharr(L1)
                g = 1.0 / (1.0 + (gx * gx + gy * gy) / k21)
                for tau in taus:
                    L1 = _diffusion_step(L1, g, tau)
                sigma_px = sigmas[s] / (2.0 ** o)  # octave pixels
                resp, Lx, Ly = _hessian_response(L1, sigma_px)
                outs.append((L1, Lx, Ly, resp))
            return tuple(
                jnp.stack([ot[i] for ot in outs]) for i in range(4)
            )

        Ls, Lxs, Lys, resps = jax.vmap(octave)(L, k2)
        for s in range(num_sublevels):
            levels.append(
                Evolution(L=Ls[:, s], Lx=Lxs[:, s], Ly=Lys[:, s],
                          response=resps[:, s], sigma=sigmas[s],
                          octave=o)
            )
        L = Ls[:, num_sublevels - 1]
        if o + 1 < num_octaves:
            # downsample by 2 for the next octave
            L = L[:, ::2, ::2]
    return levels
