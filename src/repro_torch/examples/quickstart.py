"""Quickstart: solve a Max-Cut instance with Snowball's dual-mode MCMC.
Counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from ..configs.snowball import default_solver
from ..core.solver import solve
from ..graphs import complete_bipolar, cut_from_energy, maxcut_to_ising


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    # K64: complete graph, J ∈ {−1,+1} — a miniature of the paper's K2000.
    inst = complete_bipolar(64, seed=0)
    problem = maxcut_to_ising(inst)

    for mode in ("rsa", "rwa"):
        config = default_solver(num_spins=64, num_steps=4000, mode=mode,
                                num_replicas=8)
        result = solve(problem, seed=0, config=config, device=args.device)
        best = float(result.best_energy.min())
        cut = float(cut_from_energy(inst, best))
        flips = result.num_flips.to(float).mean()
        print(f"mode={mode:3s}  best_energy={best:8.1f}  cut={cut:6.0f}  "
              f"flips/replica={float(flips):.0f}")


if __name__ == "__main__":
    main()
