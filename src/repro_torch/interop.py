"""Carry the JAX package's problems, planes, configs, fused state, chain
state, tempering configs and state, colored plans, LM configs and
parameters, and optimizer and train states into the port.

Everything crosses as numpy arrays and plain Python values, so this module
imports neither ``jax`` nor ``repro``: a test converts with ``np.asarray``
on one side and these functions on the other.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.bitplane import BitPlanes
from .core.coupling import CouplingStore
from .core.ising import EdgeList, IsingProblem
from .core.mcmc import ChainState
from .core.schedules import Schedule
from .core.solver import SolverConfig
from .core.tempering import TemperingConfig
from .graphs.coloring import Coloring
from .kernels.ops import ColoredPlan
from .models.config import ModelConfig
from .optim import AdamWState, QTensor
from .train import TrainState

#: dtypes of the fused state ``(u, s, e, best_e, best_s, num_flips)``.
STATE_DTYPES = (torch.float32,) * 5 + (torch.int32,)


def problem_from_numpy(couplings, fields, offset: float = 0.0,
                       device=None) -> IsingProblem:
    """An ``IsingProblem`` with the reference's J, h and offset."""
    return IsingProblem.create(np.asarray(couplings), np.asarray(fields),
                               offset=float(offset), device=device)


def edges_from_numpy(rows, cols, weights, num_spins: int) -> EdgeList:
    """An ``EdgeList`` from the reference's canonical COO arrays (``rows``,
    ``cols``, ``weights`` of a JAX ``EdgeList``)."""
    return EdgeList.create(np.asarray(rows), np.asarray(cols),
                           np.asarray(weights), int(num_spins))


def sparse_problem_from_numpy(rows, cols, weights, num_spins: int,
                              fields=None, offset: float = 0.0,
                              device=None) -> IsingProblem:
    """An edge-list ``IsingProblem`` with the reference's edges, h and
    offset; no (N, N) array is made."""
    return IsingProblem.create_sparse(
        edges_from_numpy(rows, cols, weights, num_spins),
        None if fields is None else np.asarray(fields), offset=float(offset),
        device=device)


def planes_from_numpy(pos, neg, num_spins: int, device=None) -> BitPlanes:
    """``BitPlanes`` with the reference's (B, N, W) uint32 plane words."""
    return BitPlanes.from_numpy(np.asarray(pos), np.asarray(neg), num_spins,
                                device=device)


def config_from_dict(d: dict) -> SolverConfig:
    """A ``SolverConfig`` from ``dataclasses.asdict`` of the JAX one (its
    ``schedule`` a dict of the JAX ``Schedule``'s fields)."""
    d = dict(d)
    sched = d.pop("schedule")
    if not isinstance(sched, Schedule):
        sched = Schedule(**sched)
    return SolverConfig(schedule=sched, **d)


def state_from_numpy(state, device=None):
    """The fused 6-tuple as tensors with the port's dtypes."""
    if len(state) != 6:
        raise ValueError(f"expected the 6-tuple (u, s, e, best_e, best_s, "
                         f"num_flips), got {len(state)} arrays")
    return tuple(torch.from_numpy(np.array(x)).to(device=device, dtype=dt)
                 for x, dt in zip(state, STATE_DTYPES))


def state_to_numpy(state):
    """The fused 6-tuple as numpy arrays (float32 and int32)."""
    return tuple(x.detach().cpu().numpy() for x in state)


def tempering_config_from_dict(d: dict) -> TemperingConfig:
    """A ``TemperingConfig`` from ``dataclasses.asdict`` of the JAX one."""
    return TemperingConfig(**d)


def tempering_state_from_numpy(carry, device=None):
    """The port's 8-tuple ``(u, s, e, best_e, best_s, num_flips, accepted,
    attempted)`` from the JAX tempering runner's carry ``((u, s, e, best_e,
    best_s, num_flips), acc, tot)`` with numpy leaves."""
    state, acc, tot = carry
    counts = tuple(torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                                device=device) for x in (acc, tot))
    return state_from_numpy(state, device) + counts


def tempering_state_to_numpy(state):
    """The JAX runner's carry ``((u, s, e, best_e, best_s, num_flips), acc,
    tot)`` as numpy arrays from the port's 8-tuple."""
    return state_to_numpy(state[:6]), *state_to_numpy(state[6:])


#: dtypes of a reference-engine ``ChainState``, field by field.
CHAIN_DTYPES = (torch.int8, torch.float32, torch.float32, torch.float32,
                torch.int8, torch.int32)


def chain_state_from_numpy(state, device=None) -> ChainState:
    """A ``ChainState`` from the reference's (its six fields in order, e.g.
    ``[np.asarray(x) for x in jax_state]``), batched over any leading axes
    they carry."""
    if len(state) != len(ChainState._fields):
        raise ValueError(f"expected the fields {ChainState._fields}, got "
                         f"{len(state)} arrays")
    return ChainState(*(torch.from_numpy(np.array(x)).to(device=device,
                                                         dtype=dt)
                        for x, dt in zip(state, CHAIN_DTYPES)))


def chain_state_to_numpy(state: ChainState) -> ChainState:
    """The ``ChainState`` with numpy fields (int8, float32, int32)."""
    return ChainState(*(x.detach().cpu().numpy() for x in state))


def coloring_from_numpy(colors, perm, offsets, num_spins: int) -> Coloring:
    """A ``Coloring`` with the reference's ``colors``, ``perm`` and
    ``offsets`` arrays."""
    return Coloring(colors=np.asarray(colors, np.int32),
                    perm=np.asarray(perm, np.int32),
                    offsets=np.asarray(offsets, np.int64),
                    num_spins=int(num_spins))


def colored_plan_from_numpy(colors, perm, offsets, problem: IsingProblem,
                            fmt: str, planes=None) -> ColoredPlan:
    """A ``ColoredPlan`` of ``problem`` (original order) with the reference
    plan's coloring. With ``planes`` — the ``(pos, neg)`` uint32 words of
    the reference plan's color-sorted store — the plan's store holds those
    words instead of its own encoding, so both sides run one operand."""
    plan = ColoredPlan(coloring_from_numpy(colors, perm, offsets,
                                           problem.num_spins), problem, fmt)
    if planes is not None:
        pos, neg = planes
        plan.store = CouplingStore.from_planes(
            planes_from_numpy(pos, neg, problem.num_spins), plan.store.fmt)
    return plan


def _tensor_from_numpy(x, device, dtype) -> torch.Tensor:
    """One leaf. numpy has no bfloat16: a JAX bf16 array comes out of
    ``np.asarray`` as an ``ml_dtypes`` array that ``torch.from_numpy``
    refuses, so it crosses as float32 (exact for bf16) and is cast back."""
    x = np.asarray(x)
    bf16 = x.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(x, dtype=np.float32 if bf16 else None))
    if dtype is None and bf16:
        dtype = torch.bfloat16
    return t.to(device=device, dtype=dtype)


def lm_params_from_numpy(tree, device=None, dtype=None) -> dict:
    """The port's parameter dict from a JAX LM parameter tree with numpy
    leaves (``jax.tree.map(np.asarray, params)``): the same keys and
    layouts, each leaf on ``device`` in its own dtype, or in ``dtype``."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return _tensor_from_numpy(tree, device, dtype)


def model_config_from_dict(d: dict) -> ModelConfig:
    """A ``ModelConfig`` from ``dataclasses.asdict`` of the JAX one."""
    d = dict(d)
    d["block_pattern"] = tuple(d.get("block_pattern", ("attn:mlp",)))
    return ModelConfig(**d)


def _moment_from_numpy(x, device):
    """A moment leaf: a tensor, or a ``QTensor`` from anything with
    ``codes``, ``scales`` and ``orig_last`` (the JAX ``QTensor`` with numpy
    fields)."""
    if hasattr(x, "codes"):
        return QTensor(codes=_tensor_from_numpy(x.codes, device, None),
                       scales=_tensor_from_numpy(x.scales, device, None),
                       orig_last=int(x.orig_last))
    return _tensor_from_numpy(x, device, None)


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def adamw_state_from_numpy(state, device=None) -> AdamWState:
    """The port's ``AdamWState`` from the JAX one with numpy leaves
    (``jax.tree.map(np.asarray, state)``; its ``QTensor`` moments keep
    their fields): each leaf in its own dtype, bf16 included."""
    step, m, v = state
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        m=_tree_map(m, lambda x: _moment_from_numpy(x, device)),
        v=_tree_map(v, lambda x: _moment_from_numpy(x, device)))


def train_state_from_numpy(state, device=None) -> TrainState:
    """The port's ``TrainState`` from the JAX one with numpy leaves."""
    params, opt_state, step = state
    return TrainState(params=lm_params_from_numpy(params, device),
                      opt_state=adamw_state_from_numpy(opt_state, device),
                      step=torch.tensor(int(np.asarray(step)),
                                        dtype=torch.int32, device=device))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 as float32 (exact; numpy has no bf16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _moment_to_numpy(x):
    if isinstance(x, QTensor):
        return QTensor(codes=_numpy(x.codes), scales=_numpy(x.scales),
                       orig_last=x.orig_last)
    return _numpy(x)


def adamw_state_to_numpy(state: AdamWState) -> AdamWState:
    """The ``AdamWState`` with numpy leaves (bf16 moments as float32)."""
    return AdamWState(step=_numpy(state.step),
                      m=_tree_map(state.m, _moment_to_numpy),
                      v=_tree_map(state.v, _moment_to_numpy))


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The ``TrainState`` with numpy leaves (bf16 as float32)."""
    return TrainState(params=_tree_map(state.params, _numpy),
                      opt_state=adamw_state_to_numpy(state.opt_state),
                      step=_numpy(state.step))
