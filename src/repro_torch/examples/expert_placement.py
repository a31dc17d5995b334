"""The paper's technique as a framework feature: Ising-based MoE expert
placement (balanced graph partitioning, paper §II-A motivation).
Counterpart of ``examples/expert_placement.py``.

1. Run forward passes of the granite-moe smoke model on the synthetic
   pipeline and collect its router loads.
2. Build the expert traffic matrix (bytes exchanged if co-activated experts
   live on different devices).
3. Solve the balanced partition with Snowball's dual-mode solver (recursive
   bisection) and compare cross-device traffic with the round-robin
   placement that expert-parallel sharding would use.

    PYTHONPATH=src python -m repro_torch.examples.expert_placement [--device cpu]
"""
import argparse

import numpy as np
import torch

from ..configs import get_config
from ..core import placement
from ..data import DataConfig, SyntheticLMData
from ..device import resolve_device
from ..models import forward, init_params, model_specs


def collect_router_stats(cfg, params, data, steps=4):
    """Expert loads (MoE blocks, E) of ``steps`` batches, stacked."""
    loads = []
    with torch.no_grad():
        for step in range(steps):
            batch = data.batch(step)
            out = forward(cfg, params, tokens=batch["tokens"])
            loads.append(out.expert_load.float().cpu().numpy())
    return np.concatenate(loads, axis=0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=2000,
                    help="annealing steps of each bisection")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    params = init_params(model_specs(cfg), torch.Generator(dev).manual_seed(0),
                         dev)
    data = SyntheticLMData(cfg, DataConfig(seed=0, global_batch=4,
                                           seq_len=64), device=dev)

    loads = collect_router_stats(cfg, params, data)
    # Traffic proxy: co-activation of experts weighted by their loads.
    C = placement.expert_traffic_matrix(loads)
    E = C.shape[0]
    D = 4  # devices along the EP axis

    round_robin = np.arange(E) % D
    rr_cut = placement.cut_bytes(C, round_robin)
    result = placement.place(C, num_devices=D, seed=0, steps=args.steps,
                             replicas=8, device=dev)

    print(f"experts={E} devices={D}")
    print(f"round-robin cross-device traffic : {rr_cut:10.4f}")
    print(f"snowball placement traffic       : {result.cut_bytes:10.4f} "
          f"({100 * (1 - result.cut_bytes / max(rr_cut, 1e-9)):.1f}% less)")
    print(f"load imbalance                   : {result.imbalance*100:.1f}%")
    print(f"assignment: {result.assignment.tolist()}")
    return result


if __name__ == "__main__":
    main()
