"""Three-term roofline of a kernel call or a model step on the H100.

  compute    = Σ operations of each type / the card's peak for that type
  memory     = bytes moved / device memory rate
  collective = Σ collective bytes × ring factor / NVLink rate

The reference reads the terms from a compiled XLA artifact (its
``hlo_cost`` walks the HLO, loops included). PyTorch has no such artifact,
so the port counts operations and bytes from the shapes (``cost``) and
hands them to ``analyze``. ``Roofline`` keeps the reference's fields and
properties; its peak rate and memory rate are fields that default to the
H100's (``hw``), so the same terms give the reference's numbers under the
reference's constants. ``fraction_of`` holds the ideal time against a
measured one (a step's wall or device-busy time).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.roofline import hw


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes: Dict[str, int]
    n_devices: int
    # terms in seconds
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    model_flops: float = 0.0        # 2·N·D (inference) or 6·N·D (train)
    peak_flops: float = hw.PEAK_BF16_FLOPS
    min_bytes: float = 0.0          # least traffic: inputs read once,
    #                                 outputs written once
    hbm_bw: float = hw.HBM_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_ideal(self) -> float:
        """The larger of the useful operations' time at the peak and the
        least traffic's time at the memory rate."""
        return max(self.model_flops / (self.n_devices * self.peak_flops),
                   self.min_bytes / self.hbm_bw)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.n_devices
        return (self.model_flops / total) if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The ideal time over the bound time (1.0 = the counted work is
        the least work), as the reference defines it."""
        if self.t_bound <= 0:
            return 0.0
        return min(1.0, self.t_ideal / self.t_bound)

    def fraction_of(self, seconds: float) -> float:
        """The ideal time over a measured time (a step's wall or busy
        time): how near the card ran to its roofline."""
        return min(1.0, self.t_ideal / seconds) if seconds > 0 else 0.0

    @property
    def memory_efficiency(self) -> float:
        """Least traffic over counted traffic (1.0 = no waste)."""
        return (self.min_bytes / self.bytes_per_device
                if self.bytes_per_device else 0.0)

    def to_dict(self):
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes": self.coll_bytes,
            "n_devices": self.n_devices,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "min_bytes": self.min_bytes,
            "memory_efficiency": self.memory_efficiency,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze(ops: Dict[str, float], nbytes: float, *, n_devices: int = 1,
            model_flops: Optional[float] = None, min_bytes: float = 0.0,
            coll_bytes: Optional[Dict[str, int]] = None) -> Roofline:
    """The roofline of counted work: ``ops`` {type: operations a device}
    (types of ``hw.PEAK_OPS``), ``nbytes`` bytes a device, ``coll_bytes``
    {collective kind: bytes}. ``model_flops`` (default: the counted
    operations) is the useful work, ``min_bytes`` the least traffic. The
    compute term sums each type at its own peak; ``peak_flops`` is the
    rate that term gives the whole count."""
    coll = dict(coll_bytes or {})
    flops = float(sum(ops.values()))
    t_comp = sum(n / hw.PEAK_OPS[k] for k, n in ops.items())
    peak = flops / t_comp if t_comp > 0 else hw.PEAK_BF16_FLOPS
    t_coll = sum(hw.RING_FACTOR.get(k, 1.0) * v
                 for k, v in coll.items()) / hw.NVLINK_BW
    return Roofline(flops, float(nbytes), coll, n_devices,
                    t_compute=t_comp, t_memory=nbytes / hw.HBM_BW,
                    t_collective=t_coll,
                    model_flops=flops if model_flops is None
                    else model_flops,
                    peak_flops=peak, min_bytes=min_bytes)
