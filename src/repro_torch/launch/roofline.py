"""Roofline terms of one step, model side (twin of ``repro.launch.roofline``'s
``RooflineTerms``, ``roofline`` and ``model_flops``).

Three terms, per (arch x shape x card count):
    compute    = FLOPs a card / PEAK_FLOPS
    memory     = HBM bytes a card / HBM_BW
    collective = collective bytes a card / ICI_BW

The constants are one NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, from
NVIDIA's data sheet: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s
of HBM, and 450 GB/s of NVLink a direction (18 links of 25 GB/s). A card
set below 700 W runs slower than these. The names are the reference's, so
a reader finds them; the port states no other card's numbers.

NVLink joins the 8 cards of one node (HGX/DGX H100). Between nodes a card
has one 400 Gb/s NDR InfiniBand port (ConnectX-7, as the DGX H100 has): 50
GB/s. A 16-rank axis of the production mesh spans two nodes, so the dry run
prices each mesh axis at its own link (`axis_link_bw`, `collective_seconds`)
and puts that time in the collective term (`with_collective_s`).

The reference's HLO parsers (``_type_bytes`` through ``top_collectives``)
have their twin in `launch/counters.py`: the port compiles no HLO, it counts
the local ops of one rank's step on DTensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

PEAK_FLOPS = 989e12          # bf16 FLOP/s a card, dense (tensor cores)
HBM_BW = 3.35e12             # B/s a card
ICI_BW = 450e9               # B/s a card, NVLink, one direction
IB_BW = 50e9                 # B/s a card between nodes: one 400 Gb/s NDR port
NODE_CARDS = 8               # cards one NVLink domain (an H100 node) holds


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_global: float
    useful_flops_ratio: float          # MODEL_FLOPS / (flops_per_device * chips)

    def as_dict(self):
        return dataclasses.asdict(self)


def _dominant(c: float, m: float, k: float) -> str:
    return max((("compute", c), ("memory", m), ("collective", k)), key=lambda t: t[1])[0]


def roofline(flops_per_device: float, bytes_per_device: float,
             collective_bytes_per_device: float, n_chips: int,
             model_flops_global: float) -> RooflineTerms:
    c = flops_per_device / PEAK_FLOPS
    m = bytes_per_device / HBM_BW
    k = collective_bytes_per_device / ICI_BW
    dom = _dominant(c, m, k)
    total_flops = flops_per_device * n_chips
    return RooflineTerms(
        compute_s=c, memory_s=m, collective_s=k, dominant=dom,
        flops_per_device=flops_per_device, bytes_per_device=bytes_per_device,
        collective_bytes_per_device=collective_bytes_per_device,
        model_flops_global=model_flops_global,
        useful_flops_ratio=(model_flops_global / total_flops) if total_flops else 0.0)


def model_flops(cfg, shape, n_params_active: int) -> float:
    """6ND (train) / 2ND (inference); D = tokens processed this step."""
    if shape.kind == "train":
        return 6.0 * n_params_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_params_active * shape.global_batch * shape.seq_len
    return 2.0 * n_params_active * shape.global_batch          # decode: 1 tok/seq


def axis_link_bw(ranks: Sequence[int]) -> float:
    """The link a collective over the global ``ranks`` runs on: NVLink when
    they all sit in one node of `NODE_CARDS` cards, else InfiniBand."""
    return ICI_BW if len({r // NODE_CARDS for r in ranks}) <= 1 else IB_BW


def collective_seconds(bytes_by_axis: Dict[str, float],
                       ranks_by_axis: Dict[str, Sequence[int]]) -> float:
    """One card's collective time: each mesh axis's bytes over its link."""
    return sum(b / axis_link_bw(ranks_by_axis[a]) for a, b in bytes_by_axis.items())


def with_collective_s(terms: RooflineTerms, collective_s: float) -> RooflineTerms:
    """``terms`` with the collective term priced per axis (and the dominant
    term chosen again)."""
    return dataclasses.replace(terms, collective_s=collective_s,
                               dominant=_dominant(terms.compute_s, terms.memory_s, collective_s))
