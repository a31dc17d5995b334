"""The port stands alone and runs on the card unless told otherwise.

Every module of ``repro_torch`` imports without JAX or the JAX package;
entry points with no device raise when there is no card (they never fall
back to the CPU); the mesh backends resolve and raise without a mesh, the
fused path refuses the sharded tiers and a colored config; every LM arch resolves
and runs its smoke forward; the CLI runs end to end on the CPU when asked,
single-flip, colored and supervised.
"""
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax  # noqa: F401  (the port's tests import both packages)
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs.snowball import default_solver
from repro_torch.core.solver import solve
from repro_torch.device import resolve_device
from repro_torch.graphs import complete_bipolar, maxcut_to_ising
from repro_torch.kernels import ops

SRC = Path(__file__).resolve().parents[1] / "src"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.kernels.sweep" in mods and len(mods) >= 20
    for name in ("repro_torch.models.model", "repro_torch.models.layers",
                 "repro_torch.models.params", "repro_torch.models.config",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.configs.qwen2_7b",
                 "repro_torch.models.moe", "repro_torch.models.ssm",
                 "repro_torch.models.rwkv", "repro_torch.serve",
                 "repro_torch.serve.batching", "repro_torch.serve.cache",
                 "repro_torch.serve.service",
                 "repro_torch.examples.serve_solver",
                 "repro_torch.configs.jamba_15_large",
                 "repro_torch.optim", "repro_torch.optim.adamw",
                 "repro_torch.optim.schedule", "repro_torch.data",
                 "repro_torch.data.pipeline", "repro_torch.train",
                 "repro_torch.train.step", "repro_torch.train.loop",
                 "repro_torch.launch.train",
                 "repro_torch.examples.train_lm",
                 "repro_torch.examples.expert_placement",
                 "repro_torch.distributed", "repro_torch.distributed.mesh",
                 "repro_torch.distributed.world",
                 "repro_torch.distributed.solver_dist",
                 "repro_torch.distributed.solver_sharded",
                 "repro_torch.models.sharding", "repro_torch.launch.mesh"):
        assert name in mods
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {mods!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax")
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print("ok", len({mods!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card paths do not apply")


def test_entry_points_raise_without_a_card():
    _needs_no_card()
    problem = maxcut_to_ising(complete_bipolar(16, seed=0))
    cfg = default_solver(16, 8, mode="rsa")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(problem, 0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.fused_anneal(problem, 0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_backends_and_options_raise():
    problem = maxcut_to_ising(complete_bipolar(16, seed=0))
    cfg = default_solver(16, 8, mode="rsa")
    from repro_torch.distributed import DistSolverConfig
    for backend in ("sharded", "sharded_2d"):
        with pytest.raises(ValueError, match="needs a .*mesh"):
            solve(problem, 0, cfg, backend=backend, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        solve(problem, 0, DistSolverConfig(base=cfg), backend="distributed",
              device="cpu")
    with pytest.raises(TypeError, match="DistSolverConfig"):
        solve(problem, 0, cfg, backend="distributed", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        solve(problem, 0, cfg, backend="magic", device="cpu")
    import dataclasses
    # Colored flips are served by their own backend; the fused path refuses
    # a colored config, as the JAX package's does.
    colored = dataclasses.replace(cfg, flip_mode="colored")
    with pytest.raises(ValueError, match="colored"):
        ops.fused_anneal(problem, 0, colored, device="cpu")
    with pytest.raises(ValueError, match="colored"):
        solve(problem, 0, colored, device="cpu")
    with pytest.raises(ValueError, match="solve_sharded"):
        solve(problem, 0,
              dataclasses.replace(cfg, coupling_format="bitplane_sharded"),
              device="cpu")


def test_cli_runs_on_the_cpu_when_asked():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--instance",
         "k64", "--mode", "rsa", "--steps", "300", "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "best cut =" in out.stdout and "us/step=" in out.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--instance",
         "grid8", "--device", "cpu"], capture_output=True, text=True,
        timeout=120, env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert bad.returncode != 0 and "unknown instance" in bad.stderr


def test_colored_cli_runs_on_the_cpu_when_asked():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--instance",
         "sparse300", "--flip-mode", "colored", "--coupling-format",
         "bitplane", "--steps", "300", "--device", "cpu"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "color_classes=" in out.stdout and "flips/step=" in out.stdout
    assert "best cut =" in out.stdout and "rows_fetched=" in out.stdout
    # The plan's stats come from the supervised run's own plan, and its
    # build time is printed apart from the steps'.
    assert "coupling_format=bitplane color_classes=" in out.stdout
    assert "window=" in out.stdout and "plan_seconds=" in out.stdout
    assert "build_seconds=" in out.stdout
    assert "stop_reason=completed" in out.stdout


def test_chip_smoke_refuses_without_a_card(tmp_path):
    _needs_no_card()
    script = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    for cwd_copy in (False, True):
        path = script
        if cwd_copy:  # alone in a directory, without the package
            path = tmp_path / "chip_smoke.py"
            path.write_text(script.read_text())
        out = subprocess.run([sys.executable, str(path)], capture_output=True,
                             text=True, timeout=120, cwd=path.parent,
                             env={"PATH": "/usr/bin:/bin"})
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_cut_matches_energy_on_a_cpu_solve():
    inst = complete_bipolar(64, seed=1)
    problem = maxcut_to_ising(inst)
    res = solve(problem, 0, default_solver(64, 200, mode="rwa"), device="cpu")
    from repro_torch.graphs import cut_from_energy
    from repro_torch.core import ising
    cuts = cut_from_energy(inst, res.best_energy.numpy())
    s = res.best_spins.numpy().astype(np.float32)
    w = inst.weights
    direct = np.array([np.sum(np.triu(w, 1) * (1 - np.outer(x, x))) / 2
                       for x in s])
    np.testing.assert_array_equal(cuts, direct)
    assert torch.equal(res.best_energy, ising.energy(problem, res.best_spins))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "granite-moe-1b-a400m",
                                  "rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_unported_archs_raise_naming_their_roadmap_item(arch):
    """The four MoE, Mamba and RWKV architectures, which raised naming
    ROADMAP queue 1 item 14 until that item was ported, now resolve and
    run their smoke forward on the CPU; an unknown id still raises."""
    from repro_torch import models
    from repro_torch.configs import ARCH_IDS, get_config
    assert len(ARCH_IDS) == 10 and arch in ARCH_IDS
    cfg = get_config(arch, smoke=True)
    assert get_config(arch).name == arch
    params = models.init_params(models.model_specs(cfg),
                                torch.Generator().manual_seed(1),
                                device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 16),
                         generator=torch.Generator().manual_seed(2))
    out = models.forward(cfg, params, tokens=toks)
    assert out.logits.shape == (1, 16, cfg.vocab_size)
    assert bool(torch.isfinite(out.logits.float()).all())
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")
