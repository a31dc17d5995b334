"""Solver-as-a-service example: a multi-tenant burst of Max-Cut requests
through the batched, cache-warm :class:`repro_torch.serve.SolverService`.
Counterpart of ``examples/serve_solver.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_solver [--device cpu]

Walks the front end's three levers: a burst of same-instance requests
fuses into one replica-stacked launch, a repeat tenant's solve reuses the
content-hash-cached coupling store (no re-encode, nothing copied to the
card), and a target-energy request the service has already beaten is
answered from the warm-start cache without any launch.
"""
import argparse
import dataclasses

from ..configs.snowball import default_solver
from ..core.resilience import BudgetConfig
from ..graphs import complete_bipolar, cut_from_energy, maxcut_to_ising
from ..serve import ServeConfig, SolveRequest, SolverService


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    # Two tenants share one K200 instance; a third brings its own K128.
    k200 = complete_bipolar(200, seed=0)
    k128 = complete_bipolar(128, seed=1)
    shared = maxcut_to_ising(k200)
    private = maxcut_to_ising(k128)
    config = dataclasses.replace(
        default_solver(num_spins=200, num_steps=2000, num_replicas=4),
        coupling_format="bitplane")

    service = SolverService(ServeConfig(), device=args.device)

    # A burst: three seed-free requests on the shared instance stack into
    # one fused launch (12 replicas side by side); the private instance
    # launches separately. One drain serves all four tenants.
    tickets = [service.submit(SolveRequest(shared, config)) for _ in range(3)]
    tickets.append(service.submit(SolveRequest(
        private, dataclasses.replace(config, num_steps=1500))))
    results = service.drain()
    for t in tickets:
        r = results[t]
        inst = k200 if r.result.best_spins.shape[-1] == 200 else k128
        best = float(r.result.best_energy.min())
        print(f"request {t}: plan={r.batched:6s} store_hit={r.store_hit!s:5s} "
              f"cut={float(cut_from_energy(inst, best)):6.0f} "
              f"wall={r.wall_seconds:.2f}s")

    # A repeat tenant: the same instance content in fresh arrays; the
    # coupling store comes from the LRU cache, so nothing is re-encoded.
    repeat = service.solve(maxcut_to_ising(complete_bipolar(200, seed=0)),
                           config, seed=42)
    print(f"repeat tenant: store_hit={repeat.store_hit} "
          f"(cache: {service.stores.hits} hits / {service.stores.misses} "
          "misses)")

    # A budgeted request whose target the service has already reached is
    # answered from the warm-start cache without launching anything.
    best_seen = min(float(results[t].result.best_energy.min())
                    for t in tickets[:3])
    cached = service.solve(shared, config,
                           budget=BudgetConfig(target_energy=best_seen + 50))
    print(f"cached target: stop_reason={cached.stop_reason} "
          f"energy={float(cached.result.best_energy[0]):.1f} "
          f"launches={service.stats['launches']}")

    print(f"stats: {service.stats}")


if __name__ == "__main__":
    main()
