"""The int8 gradient exchange and the GPipe schedule of the port
(``repro_torch.distributed.compress`` and ``.pipeline``) against the JAX
package's under ``shard_map``.

One gloo world of 4 (``torch_worlds.compress_pipeline_world``) and, at the
same time, one JAX subprocess on 4 forced host devices
(``conftest.run_with_forced_devices``) run the same inputs, made from
seeds with numpy:

* ``compressed_psum_grads`` over 20 error-feedback steps, every rank's
  gradients its own (a leaf zero on every rank at even steps): the reduced
  gradients and each rank's error feedback bitwise JAX's, every step;
* ``pipeline_apply`` of 4 tanh stages on 8 microbatches: within 2e-5 of
  JAX's (the bound of ``tests/test_distributed.py``), and of the sequential
  composition; ``bubble_fraction`` equal to JAX's.
"""
import concurrent.futures
import json

import numpy as np
import pytest
import torch

import torch_worlds as tw
from conftest import run_with_forced_devices
from repro.distributed.pipeline import bubble_fraction as jbubble
from repro_torch.distributed.compress import (compressed_psum_grads,
                                              compression_ratio,
                                              init_compression)
from repro_torch.distributed.mesh import init_world
from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply
from repro_torch.distributed.world import run_world

JAX_CODE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
sys.path.insert(0, "tests")
import torch_worlds as tw
from repro.distributed import shard_map_compat
from repro.distributed.compress import CompressionState, compressed_psum_grads
from repro.distributed.pipeline import pipeline_apply

mesh = jax.make_mesh((4,), ("data",))
grads = tw.compress_grads(4)
names = sorted(tw.COMPRESS_SHAPES)

def step(g, ef):
    out, st = compressed_psum_grads(
        {k: g[k][0] for k in names},
        CompressionState({k: ef[k][0] for k in names}), axis="data")
    return ({k: out[k][None] for k in names},
            {k: st.error_feedback[k][None] for k in names})

fn = jax.jit(shard_map_compat(step, mesh=mesh, in_specs=(P("data"), P("data")),
                              out_specs=(P("data"), P("data"))))
ef = {k: jnp.zeros((4,) + tw.COMPRESS_SHAPES[k], jnp.float32) for k in names}
steps = []
for t in range(tw.COMPRESS_STEPS):
    red, ef = fn({k: jnp.asarray(grads[k][t]) for k in names}, ef)
    steps.append({"reduced": {k: np.asarray(red[k]).view(np.int32).tolist()
                              for k in names},
                  "ef": {k: np.asarray(ef[k]).view(np.int32).tolist()
                         for k in names}})

pmesh = jax.make_mesh((tw.PIPE_STAGES,), ("pp",))
w, x = tw.pipeline_inputs()
pfn = jax.jit(shard_map_compat(
    lambda sw, xx: pipeline_apply(lambda a, h: jnp.tanh(h @ a), sw[0], xx,
                                  axis="pp"),
    mesh=pmesh, in_specs=(P("pp"), P()), out_specs=P()))
print("JSON" + json.dumps({"steps": steps,
                           "pipeline": np.asarray(pfn(w, x)).tolist()}))
"""


def _jax_run() -> dict:
    out = run_with_forced_devices(JAX_CODE, n_devices=4, timeout=300)
    line = next(ln for ln in out.splitlines() if ln.startswith("JSON"))
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def runs():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_jax_run)
        ranks = run_world("torch_worlds:compress_pipeline_world", 4,
                          timeout=300)
        return ranks, ref.result()


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.int32)


@pytest.mark.parametrize("step", range(tw.COMPRESS_STEPS))
def test_compressed_psum_bitwise_jax(runs, step):
    ranks, ref = runs
    want = ref["steps"][step]
    for rank in ranks:
        r = rank["rank"]
        got = rank["steps"][step]
        for k in tw.COMPRESS_SHAPES:
            assert np.array_equal(_bits(got["reduced"][k]),
                                  np.asarray(want["reduced"][k][r])), k
            assert np.array_equal(_bits(got["ef"][k]),
                                  np.asarray(want["ef"][k][r])), k


def test_pipeline_matches_jax_and_sequential(runs):
    ranks, ref = runs
    w, x = tw.pipeline_inputs()
    seq = torch.from_numpy(x)
    for i in range(tw.PIPE_STAGES):
        seq = tw.pipeline_stage(torch.from_numpy(w[i]), seq)
    want = np.asarray(ref["pipeline"], np.float32)
    for rank in ranks:
        got = rank["pipeline"].numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, seq.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("m,p", [(8, 4), (1, 1), (16, 2), (3, 7)])
def test_bubble_fraction_equals_jax(m, p):
    assert bubble_fraction(m, p) == jbubble(m, p)


def test_world_of_one_is_the_local_arithmetic():
    """On a world of 1 the exchange is the rank's own int8 round trip
    (mean over one rank) and the pipeline is the single stage."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    init_world("gloo", rank=0, world_size=1, device_type="cpu")
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        g = {"w": torch.tensor([1.0, -2.0, 0.5])}
        red, st = compressed_psum_grads(g, init_compression(g), mesh, "data")
        scale = torch.tensor(2.0) * (torch.tensor(1.0) / 127.0)
        q = torch.round(g["w"] / scale)
        assert torch.equal(red["w"], q * scale)
        assert torch.equal(st.error_feedback["w"],
                           (g["w"].double() - q.double() * scale.double())
                           .float())
        w, x = tw.pipeline_inputs()
        out = pipeline_apply(tw.pipeline_stage, torch.from_numpy(w[0]),
                             torch.from_numpy(x), mesh, "data")
        assert torch.equal(out, tw.pipeline_stage(torch.from_numpy(w[0]),
                                                  torch.from_numpy(x)))
    finally:
        dist.destroy_process_group()


def test_compression_ratio():
    g = {"a": torch.zeros(1000), "b": torch.zeros(24)}
    assert compression_ratio(g) == (1024 * 4) / (1024 + 8)
