"""Three-term roofline analysis of counted costs (port of
``repro.roofline.analysis``).

Terms (seconds), per (arch × shape × mesh), per device:

    t_compute    = device_FLOPs / peak_FLOPs_per_card
    t_memory     = device_bytes / HBM_bw_per_card
    t_collective = wire_bytes_per_device / NVLink_bw_per_card

The counts come from ``op_cost.count_costs`` over one rank's run (the
port is SPMD, so a rank's counts are per device). Collective bytes are
each collective's operand bytes and group size, converted to ring-
algorithm wire bytes per device (:func:`wire_bytes`):

    all-reduce       2·B·(G−1)/G
    all-gather       B_result·(G−1)/G
    reduce-scatter   B_result·(G−1)        (operand = G·result)
    all-to-all       B·(G−1)/G
    collective-permute  B
    broadcast        B·(G−1)/G             (the port's gathers: G of them)

The peaks are an NVIDIA H100 SXM5 80 GB's (:data:`HW`); no TPU figure.
"""
from __future__ import annotations

import dataclasses

#: NVIDIA H100 SXM5 80 GB (per card): dense bf16 tensor-core peak, HBM3
#: rate, NVLink 4 rate each way, memory.
HW = {
    "name": "NVIDIA H100 SXM5 80GB",
    "peak_flops_bf16": 989.4e12,  # FLOP/s
    "hbm_bw": 3.35e12,            # B/s
    "nvlink_bw": 450e9,           # B/s each way
    "hbm_bytes": 80e9,            # capacity
}


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Ring-algorithm wire bytes per device of one collective of ``kind``
    on ``nbytes`` (the result's bytes) over ``group`` devices."""
    g = max(int(group), 1)
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if kind in ("all-gather", "all-to-all", "broadcast"):
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(nbytes * (g - 1))
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    num_devices: int
    device_flops: float
    device_bytes: float
    wire_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float          # 6·N·D (or 2·N·D inference) GLOBAL
    useful_ratio: float         # model_flops / global counted flops
    memory_per_device: dict     # {"arguments", "peak"} bytes
    collective_ops: dict
    scope_bytes: dict = dataclasses.field(default_factory=dict)
    scope_flops: dict = dataclasses.field(default_factory=dict)
    note: str = ""

    @property
    def step_time(self) -> float:
        """Roofline step time (max of the three terms: perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        total_peak = self.num_devices * HW["peak_flops_bf16"]
        return (self.model_flops / (self.step_time * total_peak)
                if self.step_time else 0.0)


def _terms(flops: float, nbytes: float, wire: float) -> tuple:
    t = {"compute": flops / HW["peak_flops_bf16"],
         "memory": nbytes / HW["hbm_bw"],
         "collective": wire / HW["nvlink_bw"]}
    return t["compute"], t["memory"], t["collective"], max(t, key=t.get)


def analyze(cost, *, arch: str, shape: str, mesh_name: str,
            num_devices: int, model_flops: float,
            note: str = "") -> CellReport:
    """The :class:`CellReport` of one rank's :class:`~.op_cost.OpCost`
    (the counterpart of the JAX package's ``analyze_compiled``)."""
    t_comp, t_mem, t_coll, bottleneck = _terms(cost.flops, cost.bytes,
                                                cost.wire_bytes)
    global_flops = cost.flops * num_devices
    return CellReport(
        arch=arch, shape=shape, mesh=mesh_name, num_devices=num_devices,
        device_flops=cost.flops, device_bytes=cost.bytes,
        wire_bytes=cost.wire_bytes, t_compute=t_comp, t_memory=t_mem,
        t_collective=t_coll, bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=(model_flops / global_flops) if global_flops else 0.0,
        memory_per_device={"arguments": int(cost.argument_bytes),
                           "peak": int(cost.peak_bytes)},
        collective_ops=dict(cost.collective_bytes_by_op),
        scope_bytes=dict(sorted(cost.scope_bytes.items(),
                                key=lambda kv: -kv[1])[:10]),
        scope_flops=dict(sorted(cost.scope_flops.items(),
                                key=lambda kv: -kv[1])[:10]),
        note=note)


def apply_flash_substitution(report: CellReport, *, head_dim: int,
                             causal: bool, block_q: int = 512,
                             block_k: int = 512) -> CellReport:
    """Model replacing the plain chunked attention with a flash kernel
    (kernel E, ``kernels.flash_attention``) in a counted cell.

    Per (block_q × block_k) tile the plain path moves ≈ 3 f32 traversals
    of the score tile through HBM (the dot's result, the exp/mask pass, the
    p operand of the pv dot) plus the bf16 q/k/v/o streams; the kernel
    keeps the tile on chip, so only the streams survive. The ratio is
    applied to the ``chunked_attention`` scope's bytes. Causal cells also
    drop the ~2× rectangle-over-triangle flops (the kernel stops at the
    diagonal)."""
    attn_bytes = report.scope_bytes.get("chunked_attention", 0.0)
    attn_flops = report.scope_flops.get("chunked_attention", 0.0)
    if attn_bytes == 0 and attn_flops == 0:
        return report
    score_traffic = 3.0 * 4.0 * block_q * block_k
    streams = 2.0 * (block_q + block_k) * head_dim * 2.0
    ratio = streams / (score_traffic + streams)
    if causal:
        ratio *= 0.5
    new_bytes = report.device_bytes - attn_bytes * (1.0 - ratio)
    new_flops = report.device_flops - (attn_flops * 0.5 if causal else 0.0)
    t_comp, t_mem, _, _ = _terms(new_flops, new_bytes, 0.0)
    terms = {"compute": t_comp, "memory": t_mem,
             "collective": report.t_collective}
    global_flops = new_flops * report.num_devices
    return dataclasses.replace(
        report, device_flops=new_flops, device_bytes=new_bytes,
        t_compute=t_comp, t_memory=t_mem,
        bottleneck=max(terms, key=terms.get),
        useful_ratio=(report.model_flops / global_flops)
        if global_flops else 0.0,
        note=(report.note + " +flash-attn-kernel").strip())


def format_report_table(reports: list) -> str:
    header = ("| arch | shape | mesh | t_comp (ms) | t_mem (ms) | t_coll (ms) | "
              "bottleneck | useful | roofline MFU | peak/dev (GiB) |\n"
              "|---|---|---|---|---|---|---|---|---|---|")
    rows = [header]
    for r in reports:
        peak = r.memory_per_device.get("peak", 0)
        rows.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.t_compute*1e3:.2f} | "
            f"{r.t_memory*1e3:.2f} | {r.t_collective*1e3:.2f} | "
            f"{r.bottleneck} | {r.useful_ratio:.2f} | {r.mfu*100:.1f}% | "
            f"{peak/2**30:.2f} |")
    return "\n".join(rows)
