"""``lm_loss`` and its gradients (``repro_torch.train.step``) against
JAX's ``jax.value_and_grad(lm_loss)``, for each of the ten architectures'
smoke configs, on the CPU: the train-step counterpart of
``tests/test_arch_smoke.py``'s train step. Parameters come from JAX's
``init_params`` and cross with ``interop.lm_params_from_numpy``; the batch
is the data pipeline's, bitwise the same in both packages.

Bounds: in f32 compute the loss within 1e-5 relative and each gradient
leaf within 1e-4 of its largest magnitude; in bf16 compute the loss within
1e-3 relative and the whole gradient within 0.03·√(L/2) of its norm (the
LM bound of two layers, widened with depth as the forward's is).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMData as JSyntheticLMData
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.train import step as jstep
from repro_torch import interop
from repro_torch.configs import ARCH_IDS
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.models.params import tree_paths
from repro_torch.train import step as tstep

B, S = 2, 32
#: XLA's backend at optimisation level 0 compiles the reference in half
#: the time; it is the same function, its multiply-adds contracted
#: differently (the loss moves by ~1e-7), far inside the bounds.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, and the
    tier-1 run shares the cores among several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, compute):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               compute_dtype=compute)
    return jcfg, interop.model_config_from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def jax_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jconfigs.get_config(arch, smoke=True)
            p = jparams.init_params(jmodel.model_specs(cfg), jax.random.key(0))
            cache[arch] = jax.tree.map(np.asarray, p)
        return cache[arch]

    return get


def _batches(jcfg, tcfg):
    jb = JSyntheticLMData(jcfg, JDataConfig(seed=1, global_batch=B,
                                            seq_len=S)).batch(0)
    tb = SyntheticLMData(tcfg, DataConfig(seed=1, global_batch=B,
                                          seq_len=S), "cpu").batch(0)
    return jb, tb


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float32)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_loss_and_grads_match_jax(arch, compute, jax_params):
    jcfg, tcfg = _cfgs(arch, compute)
    np_params = jax_params(arch)
    jb, tb = _batches(jcfg, tcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    run = jax.jit(jax.value_and_grad(lambda p: jstep.lm_loss(jcfg, p, jb),
                                     has_aux=True))
    (jl, jm), jg = run.lower(jp).compile(compiler_options=FAST_COMPILE)(jp)
    jg = jax.tree.map(np.asarray, jg)
    loss, metrics, grads = tstep.value_and_grad(
        tcfg, interop.lm_params_from_numpy(np_params, "cpu"), tb)
    assert float(metrics["tokens"]) == float(jm["tokens"])
    if compute == "float32":
        assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
        assert abs(float(metrics["aux"]) - float(jm["aux"])) <= 1e-5
        for path, g in tree_paths(grads):
            want = _leaf(jg, path)
            assert g.dtype == torch.float32 and g.shape == want.shape
            err = float(np.abs(g.numpy() - want).max())
            assert err <= 1e-4 * max(float(np.abs(want).max()), 1e-12), path
    else:
        assert abs(float(loss) - float(jl)) <= 1e-3 * abs(float(jl))
        num = sum(float(((g.numpy() - _leaf(jg, p)) ** 2).sum())
                  for p, g in tree_paths(grads))
        den = sum(float((_leaf(jg, p) ** 2).sum()) for p, _ in tree_paths(grads))
        bound = 0.03 * math.sqrt(max(tcfg.num_layers, 2) / 2)
        assert math.sqrt(num / den) <= bound
