"""The port covers the JAX package, checked on the two trees' sources.

Every module of ``src/repro`` has a module of the same path in
``src/repro_torch`` or a stated counterpart (:data:`MODULE_COUNTERPARTS`),
and every public top-level name that a JAX module defines (a function, a
class or an assigned name, not starting with ``_``) is defined at the top
level of some module of the port, unless :data:`JAX_ONLY` lists it with its
reason. The sources are read with ``ast``; neither package is imported, so
the audit needs no device and cannot hang. One case per JAX module, so a
later gap names its module.
"""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
JAX_ROOT = SRC / "repro"
PORT_ROOT = SRC / "repro_torch"

#: JAX modules with no module of the same path in the port: the port's
#: counterpart and the names it must define there.
MODULE_COUNTERPARTS = {
    # A jax-version shim for shard_map and its axis size; the port's meshes
    # are torch.distributed groups.
    "distributed/shmap.py": ("distributed/mesh.py", ("dim_size", "mesh_size")),
    # The HLO walker; the port has no HLO and counts eager ops instead.
    "roofline/hlo_cost.py": ("roofline/op_cost.py", ("count_costs", "OpCost")),
}

#: Public names of JAX modules that the port does not define, by module,
#: each with its one-line reason.
JAX_ONLY = {
    "core/coupling.py": {
        "BITPLANE_VMEM_MAX_N": "TPU VMEM budget; the H100's plane tiers "
                               "split at BITPLANE_L2_MAX_N",
    },
    "core/rng.py": {
        "base_key": "wraps jax.random.key; the port's key is rng.key",
    },
    "core/schedules.py": {
        "ScheduleFn": "a type alias over jax.Array; the port's schedules "
                      "are Schedule values",
    },
    "distributed/shmap.py": {
        "axis_size": "shard_map axis size; the port's is mesh.dim_size",
        "shard_map_compat": "shard_map across jax versions; the port runs "
                            "torch.distributed",
    },
    "distributed/solver_dist.py": {
        "dist_operands": "the shard_map operands; the port's is DistRunner",
        "dist_resilient_fns": "jitted shard_map chunk surfaces; the port's "
                              "is DistRunner",
    },
    "distributed/solver_sharded.py": {
        "sharded_anneal_fn": "jitted shard_map builder; the port's is "
                             "ShardedRunner",
        "sharded_init_fn": "jitted shard_map builder; the port's is "
                           "sharded_init",
        "sharded_sweep_fn": "jitted shard_map builder; the port's is "
                            "sharded_sweep",
    },
    "kernels/common.py": {
        "default_pwl_select": "picks the TPU VPU's select form; the port "
                              "always gathers",
    },
    "kernels/ops.py": {
        "auto_interpret": "Pallas interpret mode; CUDA kernels have none",
        "fused_sweep_chunk": "the host-uniform chunk; the port's is "
                             "keyed_sweep_chunk",
    },
    "kernels/sweep.py": {
        "COUPLING_MODES": "alias of coupling.KERNEL_COUPLING_MODES, which "
                          "the port uses directly",
        "PLANE_MODES": "alias of coupling.KERNEL_PLANE_MODES, which the port "
                       "uses directly",
    },
    "launch/dryrun.py": {
        "DOC": "the docstring as a string, after the XLA_FLAGS line; the "
               "port's is __doc__",
        "build_lowered": "lowers a cell through XLA; the port's is "
                         "build_cell",
    },
    "launch/mesh.py": {
        "xla_performance_flags": "XLA flags; the port's is "
                                 "nccl_performance_env",
    },
    "roofline/analysis.py": {
        "CollectiveStats": "the HLO walker's collective counts",
        "analyze_compiled": "reads a compiled XLA program; the port's is "
                            "analyze",
        "collective_bytes": "the HLO walker's collective bytes",
    },
    "roofline/hlo_cost.py": {
        "Computation": "the HLO walker",
        "Instruction": "the HLO walker",
        "LoopAwareCost": "the HLO walker",
        "parse_module": "the HLO walker",
    },
}


def _modules(root: Path) -> list:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


def _assigned(target) -> set:
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, (ast.Tuple, ast.List)):
        return set().union(*(_assigned(t) for t in target.elts))
    return set()


def _top_level(body) -> set:
    """Names a module body defines, through top-level ``if`` / ``try``."""
    names = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                names |= _assigned(target)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            names |= _assigned(node.target)
        elif isinstance(node, ast.If):
            names |= _top_level(node.body) | _top_level(node.orelse)
        elif isinstance(node, ast.Try):
            names |= _top_level(node.body) | _top_level(node.orelse)
            names |= _top_level(node.finalbody)
            for handler in node.handlers:
                names |= _top_level(handler.body)
    return names


def defined_names(path: Path) -> set:
    return _top_level(ast.parse(path.read_text(), str(path)).body)


def public_names(path: Path) -> set:
    return {n for n in defined_names(path) if not n.startswith("_")}


JAX_MODULES = _modules(JAX_ROOT)
PORT_MODULES = _modules(PORT_ROOT)
PORT_NAMES = set().union(*(defined_names(PORT_ROOT / m)
                           for m in PORT_MODULES))


def test_the_tables_name_only_jax_modules():
    assert len(JAX_MODULES) > 50 and "core/coupling.py" in JAX_MODULES
    assert set(MODULE_COUNTERPARTS) <= set(JAX_MODULES)
    assert set(JAX_ONLY) <= set(JAX_MODULES)
    for mod, names in JAX_ONLY.items():
        for name, reason in names.items():
            assert reason.strip() and "\n" not in reason, (mod, name)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_is_covered(module):
    counterpart, required = MODULE_COUNTERPARTS.get(module, (module, ()))
    if module in MODULE_COUNTERPARTS:
        assert module not in PORT_MODULES, (
            f"{module} now has a port module of its path: drop its entry "
            "from MODULE_COUNTERPARTS")
    assert counterpart in PORT_MODULES, (
        f"src/repro/{module} has no counterpart src/repro_torch/{counterpart}")
    missing = set(required) - defined_names(PORT_ROOT / counterpart)
    assert not missing, f"src/repro_torch/{counterpart} lacks {missing}"
    names = public_names(JAX_ROOT / module)
    exempt = JAX_ONLY.get(module, {})
    missing = sorted(names - PORT_NAMES - set(exempt))
    assert not missing, (
        f"public names of src/repro/{module} defined nowhere in "
        f"src/repro_torch: {missing}")
    stale = sorted(n for n in exempt if n not in names or n in PORT_NAMES)
    assert not stale, (
        f"JAX_ONLY[{module!r}] lists names that are not public in the JAX "
        f"module or that the port now defines: {stale}")
