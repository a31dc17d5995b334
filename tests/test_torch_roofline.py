"""The port's roofline (``repro_torch.roofline``): op-level costs counted
in eager execution against known-cost programs and against the JAX
package's HLO walker, the wire-byte formulas against JAX's, and the
report."""
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.roofline import analysis as janalysis
from repro.roofline import hlo_cost
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.device import meta_device
from repro_torch.distributed import mesh as M
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import forward
from repro_torch.roofline import (HW, CellReport, analyze,
                                  apply_flash_substitution, count_costs,
                                  format_report_table, named_scope,
                                  wire_bytes)

HLO = """
HloModule m
ENTRY %main (a: f32[{n}]) -> f32[{n}] {{
  %a = f32[{n}]{{0}} parameter(0)
  %ar = f32[{n}]{{0}} all-reduce(%a), replica_groups={{{{{g}}}}}, to_apply=%sum
  %ag = f32[{gn}]{{0}} all-gather(%ar), replica_groups={{{{{g}}}}}, dimensions={{0}}
  %rs = f32[{n}]{{0}} reduce-scatter(%ag), replica_groups={{{{{g}}}}}, dimensions={{0}}
  %aa = f32[{n}]{{0}} all-to-all(%rs), replica_groups={{{{{g}}}}}, dimensions={{0}}
  ROOT %cp = f32[{n}]{{0}} collective-permute(%aa), source_target_pairs={{{{0,1}},{{1,0}}}}
}}
"""


@pytest.mark.parametrize("n,group", [(1024, 4), (4096, 2), (333, 8),
                                     (64, 1)])
def test_wire_bytes_equal_jax_formulas(n, group):
    hlo = HLO.format(n=n, gn=n * group, g=",".join(map(str, range(group))))
    stats = janalysis.collective_bytes(hlo, default_group=group)
    b = 4 * n
    want = {"all-reduce": b, "all-gather": b * group, "reduce-scatter": b,
            "all-to-all": b, "collective-permute": b}
    for kind, nbytes in want.items():
        assert wire_bytes(kind, nbytes, group) == pytest.approx(
            stats.op_bytes.get(kind, 0.0), rel=1e-12, abs=0), kind


def test_python_loop_counts_every_iteration():
    x = torch.randn(256, 256)
    with count_costs() as c:
        y = x
        for _ in range(10):
            y = y @ x
    assert c.cost.flops == 10 * 2 * 256 ** 3


def test_nested_loops_multiply():
    x = torch.randn(128, 128)
    with count_costs() as c:
        y = x
        for _ in range(3):
            for _ in range(4):
                y = y @ x
    assert c.cost.flops == 12 * 2 * 128 ** 3


def test_bytes_at_least_io_and_views_free():
    a = torch.randn(512, 512)
    with count_costs() as c:
        a @ a
    assert c.cost.bytes >= 3 * 512 * 512 * 4
    with count_costs() as v:
        a.t().unsqueeze(0)[:, 1:]
        a.view(-1)
    assert v.cost.bytes == 0 and v.cost.flops == 0


def test_meta_counts_equal_cpu_counts():
    """The counts of a program are the same on the meta device (a dry run,
    its kernels run once a signature) and on the CPU."""
    def prog(x, w):
        h = torch.relu(x @ w)
        for _ in range(3):
            h = torch.tanh(h @ w) + h
        return h.sum()

    out = {}
    for dev in ("cpu", "meta"):
        x = torch.ones(64, 32, device=dev)
        w = torch.ones(32, 32, device=dev)
        with count_costs(arguments=(x, w)) as c:
            prog(x, w)
        out[dev] = c.cost
    assert out["cpu"].flops == out["meta"].flops == 4 * 2 * 64 * 32 * 32
    assert out["cpu"].bytes == out["meta"].bytes
    assert out["cpu"].ops == out["meta"].ops
    assert out["cpu"].peak_bytes == out["meta"].peak_bytes


def test_peak_holds_saved_tensors():
    """Autograd's saved activations stay live until the backward."""
    w = torch.randn(256, 256, requires_grad=True)
    x = torch.randn(64, 256)
    with count_costs(arguments=(w, x)) as c:
        h = x
        for _ in range(4):
            h = torch.tanh(h @ w)
        h.sum().backward()
    act = 64 * 256 * 4
    assert c.cost.argument_bytes == 256 * 256 * 4 + act
    assert c.cost.peak_bytes >= c.cost.argument_bytes + 8 * act


def test_counter_holds_nothing_after_the_run():
    """The counter lets go of its arguments when the run ends (a caller
    frees a model's weights right after counting its step)."""
    x = torch.randn(1000)
    ref = weakref.ref(x)
    with count_costs(arguments=(x,)) as c:
        x * 2
    del x
    assert ref() is None and c.cost.argument_bytes == 4000


def test_scopes_are_innermost():
    @named_scope("mlp")
    def inner(x):
        return x @ x

    @named_scope("moe_ffn")
    def outer(x):
        return inner(x) @ x

    x = torch.randn(32, 32)
    with count_costs() as c:
        outer(x)
        x @ x
    f = 2 * 32 ** 3
    assert c.cost.scope_flops == {"mlp": f, "moe_ffn": f, "other": f}


def test_collectives_counted_at_the_mesh_log():
    x = torch.zeros(1024)
    with count_costs() as c:
        M.COLLECTIVES.add(("all_reduce_sum", "data"), x, 4)
        M.COLLECTIVES.add(("broadcast", "model"), x, 8)
    assert c.cost.collective_bytes_by_op == {
        "all-reduce": 2 * 4096 * 3 / 4, "broadcast": 4096 * 7 / 8}
    assert c.cost.wire_bytes == 2 * 4096 * 3 / 4 + 4096 * 7 / 8
    assert not M.COLLECTIVES.listeners


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_e_counts_its_own_formula(causal, dtype):
    """Kernel E counts 4·B·Hq·D·S(S+1)/2 (causal) at its entry and nothing
    inside, so its plain version (the CPU's) and a meta call (a dry run's)
    count alike."""
    b, hq, hkv, s, d = 2, 4, 2, 64, 16
    out = {}
    for dev in ("cpu", "meta"):
        q = torch.ones(b, hq, s, d, dtype=dtype, device=dev)
        k = torch.ones(b, hkv, s, d, dtype=dtype, device=dev)
        with count_costs() as c, meta_device():
            fa.flash_attention(q, k, k, causal, d ** -0.5, 16, 16)
        out[dev] = c.cost
    pairs = s * (s + 1) / 2 if causal else s * s
    for cost in out.values():
        assert cost.flops == 4 * b * hq * d * pairs
        assert cost.kernels == {"flash_attention": 1}
        assert cost.ops == 0
    assert out["cpu"].bytes == out["meta"].bytes


def test_qwen2_prefill_flops_equal_jax_walker():
    """On the qwen2 smoke prefill, one device: the port's flops outside
    ``chunked_attention`` within 1 % of the JAX walker's outside that
    scope (and each scope's)."""
    cfg = jconfigs.get_config("qwen2-7b", smoke=True)
    p = jparams.init_params(jmodel.model_specs(cfg), jax.random.key(0))
    toks = np.random.default_rng(1).integers(0, 512, (4, 32)).astype(np.int32)
    txt = jax.jit(lambda p, t: jmodel.forward(cfg, p, tokens=t).logits) \
        .lower(p, jnp.asarray(toks)).compile().as_text()
    want = hlo_cost.analyze(txt)
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    with torch.no_grad(), count_costs() as c:
        forward(get_config("qwen2-7b", smoke=True), tp,
                tokens=torch.from_numpy(toks).long())
    got = c.cost
    outside = got.flops - got.scope_flops.get("chunked_attention", 0.0)
    jout = want.flops - want.scope_flops.get("chunked_attention", 0.0)
    assert outside == pytest.approx(jout, rel=1e-2)
    for scope in ("mlp", "_logits", "chunked_attention"):
        assert got.scope_flops[scope] == pytest.approx(
            want.scope_flops[scope], rel=1e-2), scope


def _report(**kw):
    base = dict(arch="x", shape="train_4k", mesh="pod", num_devices=256,
                device_flops=1e12, device_bytes=1e9, wire_bytes=1e6,
                t_compute=1e12 / HW["peak_flops_bf16"],
                t_memory=1e9 / HW["hbm_bw"],
                t_collective=1e6 / HW["nvlink_bw"], bottleneck="compute",
                model_flops=256 * 0.9e12, useful_ratio=0.9,
                memory_per_device={"arguments": 1, "peak": 2},
                collective_ops={})
    base.update(kw)
    return CellReport(**base)


def test_cell_report_bottleneck_mfu_and_table():
    r = _report()
    assert r.step_time == max(r.t_compute, r.t_memory, r.t_collective)
    assert 0.0 < r.mfu <= 1.0
    table = format_report_table([r])
    assert "train_4k" in table and "compute" in table


def test_analyze_and_flash_substitution():
    from repro_torch.roofline.op_cost import OpCost

    cost = OpCost(flops=2e12, bytes=4e12, wire_bytes=9e9,
                  scope_flops={"chunked_attention": 1e12},
                  scope_bytes={"chunked_attention": 3e12},
                  argument_bytes=10, peak_bytes=20)
    r = analyze(cost, arch="a", shape="s", mesh_name="pod", num_devices=4,
                model_flops=4e12)
    assert r.bottleneck == "memory"
    assert r.t_memory == 4e12 / HW["hbm_bw"]
    assert r.t_collective == 9e9 / HW["nvlink_bw"]
    assert r.useful_ratio == 0.5
    assert r.memory_per_device == {"arguments": 10, "peak": 20}
    f = apply_flash_substitution(r, head_dim=128, causal=True)
    assert f.device_flops == 1.5e12 and f.device_bytes < r.device_bytes
    assert "flash" in f.note
    assert dataclasses.replace(r) == r


def test_hw_is_the_h100():
    assert "H100" in HW["name"]
    assert HW["peak_flops_bf16"] == 989.4e12
    assert HW["hbm_bw"] == 3.35e12 and HW["nvlink_bw"] == 450e9
