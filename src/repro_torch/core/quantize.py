"""Weight quantizers producing the packed low-bit weight format.

``QuantizedWeight`` holds, for one [N, K] projection:

  * ``packed``       uint8 [N, ceil(K*B/8)] — folded group codes (Eq. 6),
  * ``scale``        float32 [N]            — s' = s/2 (reinterpreted),
  * ``zero_prime``   float32 [N] or None    — z' (None ⇒ symmetric),

or, for a stack of E experts' projections (the MoE FFN), the same with a
leading [E] on ``packed``, ``scale`` and ``zero_prime``: one weight per
expert, the bytes of E separate packings (``quantize_experts``). The
metadata is per expert:

  * ``plane_scales`` tuple of B floats      — [1,2,4..] or [1,1] (ternary),
  * ``bits, k_group, k_total, n``           — static metadata,
  * ``plane_start, stored_planes``          — plane-slice view fields.

The bytes equal the reference quantizers' bytes for the same float weights.

The offline-CW store (``to_cw_format``) keeps, in place of ``packed``, the
combined-lookup matrix ``cw`` int8 [G·E, N] ([E, G·E, N] for an expert
stack) that ``kernels.ref.build_cw`` would build from the codes on every
call: the reference's store for single-device CPU ``lut_xla`` serving,
8× the packed bytes at W2 / K = 4 and read once instead of expanded each
step. Only ``lut_xla`` reads it; what needs the codes (``sign_idx``,
``plane_slice``, ``dequantize``, the kernels) refuses a CW-only weight.
"""

from __future__ import annotations

import torch

from . import packing, reinterpret
from .table import true_divide

__all__ = ["QuantizedWeight", "quantize_symmetric", "quantize_asymmetric",
           "quantize_ternary", "quantize", "quantize_experts", "to_cw_format",
           "cw_layout", "plane_codes", "dequantize", "fake_quant"]


class QuantizedWeight:
    """Packed low-bit weights of one projection (see module docstring)."""

    def __init__(self, packed, scale, zero_prime, plane_scales, *, bits,
                 k_group, k_total, n, plane_start=0, stored_planes=None,
                 cw=None):
        self.packed = packed
        self.scale = scale
        self.zero_prime = zero_prime
        # the offline-CW store: int8 [G·E, N] (or [E, G·E, N]), with
        # ``packed`` None (``to_cw_format``)
        self.cw = cw
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
    def is_cw(self) -> bool:
        """Whether the weight is held only in the offline-CW store."""
        return self.packed is None

    @property
    def experts(self):
        """E for a stack of experts' weights (``packed`` [E, N, bytes] or
        ``cw`` [E, G·E, N]), else None."""
        t = self.cw if self.is_cw else self.packed
        return t.shape[0] if t.dim() == 3 else None

    def expert(self, e: int) -> "QuantizedWeight":
        """Expert ``e`` of a stack, as a 2-D weight (views, no copy)."""
        pick = lambda t: None if t is None else t[e]
        return QuantizedWeight(
            pick(self.packed), self.scale[e], pick(self.zero_prime),
            self.plane_scales, bits=self.bits, k_group=self.k_group,
            k_total=self.k_total, n=self.n, plane_start=self.plane_start,
            stored_planes=self.stored_planes, cw=pick(self.cw))

    def _need_codes(self, what: str):
        if self.is_cw:
            raise ValueError(
                f"{what} needs the packed store: the offline CW matrix bakes "
                "every plane into its entries (pin quant['store']='packed' "
                "before converting)")

    @property
    def is_plane_sliced(self) -> bool:
        return self.plane_start != 0 or self.stored_planes != self.num_planes

    def sign_idx(self):
        """Unpack to (sign, idx) uint8 [N, G, B] of this view's planes."""
        self._need_codes("sign_idx")
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
        self._need_codes("plane_slice")
        return QuantizedWeight(
            self.packed, self.scale, self.zero_prime,
            self.plane_scales[self.num_planes - keep:],
            bits=self.bits, k_group=self.k_group, k_total=self.k_total,
            n=self.n, plane_start=self.plane_start + self.num_planes - keep,
            stored_planes=self.stored_planes)

    def storage_bits_per_weight(self) -> float:
        """Stored bits a weight: a packed row's bytes over its K weights (an
        expert stack's rows are one expert's); in the CW store, a column's
        G·E int8 entries over its K weights."""
        if self.is_cw:
            return self.cw.shape[-2] * 8 / self.k_total
        return self.packed.shape[-1] * 8 / self.k_total

    def to(self, device) -> "QuantizedWeight":
        move = lambda t: None if t is None else t.to(device)
        return QuantizedWeight(
            move(self.packed), move(self.scale), move(self.zero_prime),
            self.plane_scales, bits=self.bits, k_group=self.k_group,
            k_total=self.k_total, n=self.n, plane_start=self.plane_start,
            stored_planes=self.stored_planes, cw=move(self.cw))

    def __repr__(self):
        store = ", store=cw" if self.is_cw else ""
        return (f"QuantizedWeight(n={self.n}, k={self.k_total}, "
                f"bits={self.bits}, k_group={self.k_group}, "
                f"planes={self.num_planes}{store})")


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


# rows a symmetric quantization works on at a time, as elements: its
# temporaries ([rows, K] f32 codes and errors, planes) stay a few MB
QUANT_CHUNK_ELEMENTS = 1 << 21


def quantize_symmetric(w: torch.Tensor, bits: int,
                       k_group: int = 4) -> QuantizedWeight:
    """MSE-optimal symmetric quantization onto the odd grid {±1, ±3, ...}·s'.

    w: float [N, K] (output-major). The per-row scale is picked from a grid
    of clip ratios r·absmax/qmax, r ∈ [0.6, 1.0], minimizing the squared
    reconstruction error; z' = 0. Rows are independent, so a large w is
    quantized in blocks of rows (``QUANT_CHUNK_ELEMENTS``): the working
    memory stays a few MB beside w, not several copies of it (a
    full-width LM head's are 0.26 GB each).
    """
    n, k = w.shape
    rows = max(64, QUANT_CHUNK_ELEMENTS // max(1, k) // 64 * 64)
    if n <= rows:
        return _quantize_symmetric(w, bits, k_group)
    parts = [_quantize_symmetric(w[i:i + rows], bits, k_group)
             for i in range(0, n, rows)]
    return QuantizedWeight(
        torch.cat([p.packed for p in parts]),
        torch.cat([p.scale for p in parts]), None, parts[0].plane_scales,
        bits=bits, k_group=k_group, k_total=k, n=n)


def _quantize_symmetric(w: torch.Tensor, bits: int,
                        k_group: int) -> QuantizedWeight:
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


def quantize_experts(w, bits: int, k_group: int = 4,
                     scheme: str = "symmetric") -> QuantizedWeight:
    """Stacked expert weights w [E, d_in, d_out] -> one QuantizedWeight with
    a leading [E]: expert e's rows are ``quantize(w[e].T)``'s. Every scheme
    works row by row, so the E·d_out rows are quantized in one call."""
    e, d_in, d_out = w.shape
    qw = quantize(w.transpose(1, 2).reshape(e * d_out, d_in), bits, k_group,
                  scheme)
    lead = lambda t: None if t is None else t.reshape(e, d_out, *t.shape[1:])
    return QuantizedWeight(lead(qw.packed), lead(qw.scale),
                           lead(qw.zero_prime), qw.plane_scales, bits=qw.bits,
                           k_group=k_group, k_total=d_in, n=d_out)


def to_cw_format(qw: QuantizedWeight) -> QuantizedWeight:
    """The offline-CW store of a packed weight (the reference's
    ``to_cw_format``): ``cw`` = ``build_cw(qw, int8)``, [G·E, N], or
    [E, G·E, N] for an expert stack, and no ``packed``. ``lut_xla`` on it
    gives the packed weight's bits (``build_cw`` returns the stored
    matrix). A CW weight is returned as it is."""
    from repro_torch.kernels.ref import build_cw
    if qw.is_cw:
        return qw
    if qw.experts is None:
        cw = build_cw(qw, torch.int8)
    else:
        cw = torch.stack([build_cw(qw.expert(e), torch.int8)
                          for e in range(qw.experts)])
    return QuantizedWeight(None, qw.scale, qw.zero_prime, qw.plane_scales,
                           bits=qw.bits, k_group=qw.k_group,
                           k_total=qw.k_total, n=qw.n, cw=cw_layout(cw))


def cw_layout(cw: torch.Tensor) -> torch.Tensor:
    """CW [.., G·E, N] in the memory layout ``build_cw`` gives a packed
    weight's matrix (G·E contiguous for each column): a float GEMM's
    kernel, and so its summation order, follows its operand's layout, so
    the CW store gives the packed store's bits with float tables too."""
    return cw.transpose(-1, -2).contiguous().transpose(-1, -2)


def plane_codes(qw: QuantizedWeight) -> torch.Tensor:
    """Reinterpreted weights q' = Σ_b ps_b·σ_b, f32 [N, K], unfolded from the
    stored codes (Eq. 6); no zero point, no scale."""
    sign, idx = qw.sign_idx()
    planes = reinterpret.unfold_group_codes(sign, idx, qw.k_group)
    sigma = 2.0 * planes.to(torch.float32) - 1.0
    # filled on the device: a host-to-device copy would wait for the stream
    ps = torch.stack([torch.full((), s, dtype=torch.float32,
                                 device=sigma.device)
                      for s in qw.plane_scales])
    return torch.einsum("nkb,b->nk", sigma, ps)


def dequantize(qw: QuantizedWeight) -> torch.Tensor:
    """Reconstruct float weights [N, K]: s'·(Σ_b ps_b·σ_b − z')."""
    qp = plane_codes(qw)
    if qw.zero_prime is not None:
        qp = qp - qw.zero_prime[:, None]
    return qw.scale[:, None] * qp


# ---------------------------------------------------------------------------
# QAT fake-quant (straight-through estimator)
# ---------------------------------------------------------------------------

def fq_scale(w: torch.Tensor, bits: int, scheme: str = "symmetric",
             *, stat=None, k=None) -> torch.Tensor:
    """The fake-quant scale a row of ``w`` (last axis): absmax / (2^b − 1)
    (symmetric), or the mean |w| (ternary). ``stat`` gives the row
    statistic instead (the whole row's absmax, or its |w| sum over ``k``
    entries, of a row split over ranks)."""
    if scheme == "ternary":
        mean = (w.abs().mean(dim=-1, keepdim=True) if stat is None
                else true_divide(stat, float(k)))
        return mean.clamp_min(1e-30)
    amax = w.abs().amax(dim=-1, keepdim=True) if stat is None else stat
    return true_divide(amax.clamp_min(1e-30), (1 << bits) - 1)


def _fq_symmetric(w: torch.Tensor, bits: int, s=None) -> torch.Tensor:
    """Absmax symmetric quantization onto the odd grid, per row of the last
    axis (no clip-ratio search: that is the serving quantizer's)."""
    qmax = (1 << bits) - 1
    s = fq_scale(w, bits) if s is None else s
    q = torch.clamp(torch.round((w / s + qmax) / 2.0), 0, qmax)
    return s * (2.0 * q - qmax)


def _fq_ternary(w: torch.Tensor, s=None) -> torch.Tensor:
    s = fq_scale(w, 2, "ternary") if s is None else s
    return s * torch.clamp(torch.round(w / s), -1, 1)


class _FakeQuant(torch.autograd.Function):
    """Forward: ``w + (wq - w)`` in w's dtype, the reference's expression
    (in f32 it can differ from ``wq`` in the last bit). Backward: the
    identity, the reference's ``stop_gradient`` straight-through estimator."""

    @staticmethod
    def forward(ctx, w, bits, scheme, scale):
        wf = w.to(torch.float32)
        wq = (_fq_ternary(wf, scale) if scheme == "ternary"
              else _fq_symmetric(wf, bits, scale))
        return w + (wq.to(w.dtype) - w)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


def fake_quant(w: torch.Tensor, bits: int, scheme: str = "symmetric",
               scale=None) -> torch.Tensor:
    """STE fake-quant along the last axis (one scale a row): the forward
    uses the quantized value, the gradient passes through unchanged.
    ``scale`` ([.., 1], f32): the rows' scales as given (``fq_scale`` of
    the whole rows where a rank holds a block of each), else this
    tensor's own."""
    return _FakeQuant.apply(w, bits, scheme,
                            None if scale is None else scale.detach())
