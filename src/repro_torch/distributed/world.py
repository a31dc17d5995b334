"""An SPMD world of local processes, one per rank: :func:`run_world`.

    results = run_world("package.module:function", 4, args=(...),
                        backend="gloo", device_type="cpu")

Each rank is ``python -m repro_torch.distributed.world`` in a process of
its own: it initialises the default process group at a free localhost port
(:func:`repro_torch.distributed.mesh.init_world`), calls ``function(*args)``
and saves what it returns; the caller gets the list of returns, index =
rank. The parent's ``sys.path`` is the children's, so a function in a
module the caller can import (a test helper, ``chip_smoke``) can be run. A
rank that fails fails the call with the tail of its output, and every
process is stopped before the call returns. Under ``torch.distributed.run``
the entry points need none of this: they call ``init_world()`` themselves.
"""
from __future__ import annotations

import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from .mesh import free_port, init_world


def run_world(target: str, world_size: int, *, args: tuple = (),
              backend: str = "gloo", device_type: str = "cpu",
              timeout: float = 600, threads: int = 1) -> list:
    """Run ``target`` ("module:function") on ``world_size`` ranks and
    return their results. ``threads`` is each rank's intra-op thread
    count (the ranks share the host's cores)."""
    work = Path(tempfile.mkdtemp(prefix="repro_world_"))
    try:
        torch.save({"target": target, "args": args, "sys_path": sys.path,
                    "threads": threads}, work / "call.pt")
        port = free_port()
        # The children start as `python -m` of this module: the directory
        # holding the package goes first on their path.
        env = os.environ.copy()
        env["PYTHONPATH"] = os.pathsep.join(
            [str(Path(__file__).resolve().parents[2])]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        procs = []
        for rank in range(world_size):
            log = open(work / f"rank{rank}.log", "wb")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "repro_torch.distributed.world",
                 str(work), str(rank), str(world_size), str(port), backend,
                 device_type], stdout=log, stderr=subprocess.STDOUT,
                env=env), log))
        _wait(procs, work, timeout)
        return [torch.load(work / f"rank{r}.out.pt", weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _wait(procs, work: Path, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or time.monotonic() > deadline:
                r = failed[0] if failed else None
                tail = ("" if r is None else
                        (work / f"rank{r}.log").read_bytes()[-6000:]
                        .decode(errors="replace"))
                what = (f"rank {r} exited with {codes[r]}" if failed
                        else f"the world did not finish in {timeout} s")
                raise RuntimeError(f"run_world: {what}\n{tail}")
            if all(c == 0 for c in codes):
                return
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()


def _child(work: str, rank: int, world_size: int, port: int, backend: str,
           device_type: str) -> None:
    work = Path(work)
    call = torch.load(work / "call.pt", weights_only=False)
    sys.path[:0] = [p for p in call["sys_path"] if p not in sys.path]
    torch.set_num_threads(call["threads"])
    module, name = call["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    init_world(backend, rank=rank, world_size=world_size,
               init_method=f"tcp://localhost:{port}",
               device_type=device_type)
    try:
        out = fn(*call["args"])
    finally:
        dist.destroy_process_group()
    torch.save(out, work / f"rank{rank}.out.pt")


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
           int(sys.argv[4]), sys.argv[5], sys.argv[6])
