"""Weight quantizers producing the packed low-bit weight format.

``QuantizedWeight`` holds, for one [N, K] projection:

  * ``packed``       uint8 [N, ceil(K*B/8)] — folded group codes (Eq. 6),
  * ``scale``        float32 [N]            — s' = s/2 (reinterpreted),
  * ``zero_prime``   float32 [N] or None    — z' (None ⇒ symmetric),
  * ``plane_scales`` tuple of B floats      — [1,2,4..] or [1,1] (ternary),
  * ``bits, k_group, k_total, n``           — static metadata,
  * ``plane_start, stored_planes``          — plane-slice view fields.

The bytes equal the reference quantizers' bytes for the same float weights.
"""

from __future__ import annotations

import torch

from . import packing, reinterpret
from .table import true_divide

__all__ = ["QuantizedWeight", "quantize_symmetric", "quantize_asymmetric",
           "quantize_ternary", "quantize", "dequantize"]


class QuantizedWeight:
    """Packed low-bit weights of one projection (see module docstring)."""

    def __init__(self, packed, scale, zero_prime, plane_scales, *, bits,
                 k_group, k_total, n, plane_start=0, stored_planes=None):
        self.packed = packed
        self.scale = scale
        self.zero_prime = zero_prime
        # static metadata: the kernels unroll the bit-serial loop over them
        self.plane_scales = tuple(float(s) for s in plane_scales)
        self.bits = int(bits)
        self.k_group = int(k_group)
        self.k_total = int(k_total)
        self.n = int(n)
        # A plane-sliced view reads planes [plane_start, plane_start +
        # num_planes) of a buffer packed with ``stored_planes`` planes.
        self.plane_start = int(plane_start)
        self.stored_planes = (len(self.plane_scales) if stored_planes is None
                              else int(stored_planes))

    @property
    def num_planes(self) -> int:
        return len(self.plane_scales)

    @property
    def g(self) -> int:
        return self.k_total // self.k_group

    @property
    def is_plane_sliced(self) -> bool:
        return self.plane_start != 0 or self.stored_planes != self.num_planes

    def sign_idx(self):
        """Unpack to (sign, idx) uint8 [N, G, B] of this view's planes."""
        sign, idx = packing.unpack_group_codes(
            self.packed, self.k_group, self.g, self.stored_planes)
        if self.is_plane_sliced:
            sl = slice(self.plane_start, self.plane_start + self.num_planes)
            sign, idx = sign[..., sl], idx[..., sl]
        return sign, idx

    def plane_slice(self, keep: int) -> "QuantizedWeight":
        """Top-``keep``-planes view of the same packed buffer (zero-copy)."""
        if keep >= self.num_planes:
            return self
        if keep < 1:
            raise ValueError(f"plane_slice(keep={keep}): need >= 1 plane")
        return QuantizedWeight(
            self.packed, self.scale, self.zero_prime,
            self.plane_scales[self.num_planes - keep:],
            bits=self.bits, k_group=self.k_group, k_total=self.k_total,
            n=self.n, plane_start=self.plane_start + self.num_planes - keep,
            stored_planes=self.stored_planes)

    def to(self, device) -> "QuantizedWeight":
        move = lambda t: None if t is None else t.to(device)
        return QuantizedWeight(
            move(self.packed), move(self.scale), move(self.zero_prime),
            self.plane_scales, bits=self.bits, k_group=self.k_group,
            k_total=self.k_total, n=self.n, plane_start=self.plane_start,
            stored_planes=self.stored_planes)

    def __repr__(self):
        return (f"QuantizedWeight(n={self.n}, k={self.k_total}, "
                f"bits={self.bits}, k_group={self.k_group}, "
                f"planes={self.num_planes})")


def _pack_planes(planes, k_group):
    sign, idx = reinterpret.fold_msb_negation(planes, k_group)
    return packing.pack_group_codes(sign, idx, k_group)


def _clip_ratios(device) -> torch.Tensor:
    """The 17 clip ratios of ``linspace(0.6, 1.0, 17)``, computed in f32 the
    way the reference computes them (``0.6·(1−t) + 1.0·t``, t = i/16) so the
    chosen scales, and hence the packed bytes, are the reference's."""
    f32 = dict(dtype=torch.float32, device=device)
    t = torch.arange(16, **f32) / torch.tensor(16.0, **f32)
    lo, hi = torch.tensor(0.6, **f32), torch.tensor(1.0, **f32)
    return torch.cat([lo * (1 - t) + hi * t, hi[None]])


def quantize_symmetric(w: torch.Tensor, bits: int,
                       k_group: int = 4) -> QuantizedWeight:
    """MSE-optimal symmetric quantization onto the odd grid {±1, ±3, ...}·s'.

    w: float [N, K] (output-major). The per-row scale is picked from a grid
    of clip ratios r·absmax/qmax, r ∈ [0.6, 1.0], minimizing the squared
    reconstruction error; z' = 0.
    """
    n, k = w.shape
    wf = w.to(torch.float32)
    qmax = (1 << bits) - 1
    absmax = wf.abs().amax(dim=1).clamp_min(1e-30)
    ratios = _clip_ratios(w.device)

    def codes(s):
        return torch.clamp(torch.round((wf / s[:, None] + qmax) / 2.0), 0, qmax)

    errs = []
    for r in ratios:  # a loop, not a [R, N, K] batch: full-width rows are big
        s = true_divide(absmax * r, qmax)
        wr = s[:, None] * (2.0 * codes(s) - qmax)
        errs.append(torch.square(wf - wr).sum(dim=1))
    best = torch.stack(errs).argmin(dim=0)
    s_prime = true_divide(absmax * ratios[best], qmax)
    planes = reinterpret.codes_to_sign_planes(codes(s_prime).to(torch.uint8),
                                              bits)
    return QuantizedWeight(
        _pack_planes(planes, k_group), s_prime, None,
        reinterpret.plane_scales_for(bits),
        bits=bits, k_group=k_group, k_total=k, n=n)


def quantize_asymmetric(w: torch.Tensor, bits: int,
                        k_group: int = 4) -> QuantizedWeight:
    """Min/max affine quantization, then reinterpretation (Eq. 2)."""
    n, k = w.shape
    wf = w.to(torch.float32)
    wmin, wmax = wf.amin(dim=1), wf.amax(dim=1)
    qmax = (1 << bits) - 1
    s = true_divide((wmax - wmin).clamp_min(1e-30), qmax)
    z = -wmin / s
    q = torch.clamp(torch.round(wf / s[:, None] + z[:, None]), 0, qmax)
    s_prime, z_prime = reinterpret.reinterpret_scale_zero(s, z, bits)
    planes = reinterpret.codes_to_sign_planes(q.to(torch.uint8), bits)
    return QuantizedWeight(
        _pack_planes(planes, k_group), s_prime, z_prime,
        reinterpret.plane_scales_for(bits),
        bits=bits, k_group=k_group, k_total=k, n=n)


def quantize_ternary(w: torch.Tensor, k_group: int = 4) -> QuantizedWeight:
    """BitNet b1.58 absmean ternary: t = clip(round(W/mean|W|), -1, 1)."""
    n, k = w.shape
    wf = w.to(torch.float32)
    s = wf.abs().mean(dim=1).clamp_min(1e-30)
    t = torch.clamp(torch.round(wf / s[:, None]), -1, 1)
    planes = reinterpret.ternary_to_sign_planes(t)
    # w ≈ s·t = (s/2)·(σ_a + σ_b): plane_scales [1,1], stored scale s/2
    return QuantizedWeight(
        _pack_planes(planes, k_group), s / 2.0, None,
        reinterpret.plane_scales_for(2, ternary=True),
        bits=2, k_group=k_group, k_total=k, n=n)


def quantize(w, bits: int, k_group: int = 4,
             scheme: str = "symmetric") -> QuantizedWeight:
    if scheme == "symmetric":
        return quantize_symmetric(w, bits, k_group)
    if scheme == "asymmetric":
        return quantize_asymmetric(w, bits, k_group)
    if scheme == "ternary":
        return quantize_ternary(w, k_group)
    raise ValueError(f"unknown scheme {scheme!r}")


def dequantize(qw: QuantizedWeight) -> torch.Tensor:
    """Reconstruct float weights [N, K]: s'·(Σ_b ps_b·σ_b − z')."""
    sign, idx = qw.sign_idx()
    planes = reinterpret.unfold_group_codes(sign, idx, qw.k_group)
    sigma = 2.0 * planes.to(torch.float32) - 1.0
    ps = torch.tensor(qw.plane_scales, dtype=torch.float32,
                      device=sigma.device)
    qp = torch.einsum("nkb,b->nk", sigma, ps)
    if qw.zero_prime is not None:
        qp = qp - qw.zero_prime[:, None]
    return qw.scale[:, None] * qp
