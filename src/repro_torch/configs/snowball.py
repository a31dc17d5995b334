"""Snowball solver configurations (port of ``repro.configs.snowball``).

``K2000`` mirrors paper §V-A2: complete graph, N=2000, J ∈ {−1,+1}; the TTS
target cut is 33,000 (Table III). ``GSET_TABLE1`` mirrors Table I's instance
families at their published sizes (synthetic — see DESIGN.md §8.4).
"""
from __future__ import annotations

import dataclasses

from ..core.schedules import Schedule, geometric, linear
from ..core.solver import SolverConfig


@dataclasses.dataclass(frozen=True)
class BenchmarkInstance:
    name: str
    topology: str
    num_vertices: int
    num_edges: int
    target_cut: float | None = None


# Table I families (|V|, |E| from the paper; synthetic regeneration).
GSET_TABLE1 = (
    BenchmarkInstance("G6", "erdos_renyi", 800, 19176),
    BenchmarkInstance("G61", "erdos_renyi", 7000, 17148),
    BenchmarkInstance("G18", "small_world", 800, 4694),
    BenchmarkInstance("G64", "small_world", 7000, 41459),
    BenchmarkInstance("G11", "torus", 800, 1600),
    BenchmarkInstance("G62", "torus", 7000, 14000),
)

K2000 = BenchmarkInstance("K2000", "complete", 2000, 1_999_000,
                          target_cut=33_000.0)


def default_solver(num_spins: int, num_steps: int, mode: str = "rwa",
                   num_replicas: int = 8, t0: float | None = None,
                   t1: float | None = None,
                   kind: str = "geometric") -> SolverConfig:
    """T0 ~ typical |ΔE| so early acceptance is high; T1 small enough that
    the chain is effectively greedy at the end (the JAX defaults)."""
    t0 = t0 if t0 is not None else max(num_spins ** 0.5, 4.0)
    t1 = t1 if t1 is not None else 0.05
    sched: Schedule = (geometric(t0, t1, num_steps) if kind == "geometric"
                       else linear(t0, t1, num_steps))
    return SolverConfig(num_steps=num_steps, schedule=sched, mode=mode,
                        num_replicas=num_replicas)
