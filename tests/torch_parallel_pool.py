"""The pytest side of the port's 2-process ``gloo`` workers.

:class:`WorkerPool` starts ``tests/torch_parallel_worker.py`` once per rank
as ``subprocess.Popen`` children (as ``tests/test_distributed_2proc.py``
starts its workers), joined in one ``gloo`` group, and hands them tasks:
:meth:`WorkerPool.run` writes the inputs with ``torch.save``, sends every
rank the task, waits for every rank's answer and returns the ranks'
outputs in rank order. A test module keeps one pool (a module-scoped
fixture) and closes it: the workers exit, their pipes close, nothing is
left running.
"""

from __future__ import annotations

import itertools
import json
import os
import select
import socket
import subprocess
import sys

import torch

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class WorkerPool:
    """``world`` worker processes in one ``gloo`` group; files under
    ``tmp``."""

    def __init__(self, tmp, world: int = 2, timeout: float = 240.0):
        self.tmp = str(tmp)
        self.world = world
        self.timeout = timeout
        self._ids = itertools.count()
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = "1"
        port = _free_port()
        self._logs = [open(os.path.join(self.tmp, f"worker{r}.log"), "w") for r in range(world)]
        self.procs = [
            subprocess.Popen([sys.executable, WORKER, str(r), str(world), str(port)],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=self._logs[r], text=True, env=env, cwd=REPO)
            for r in range(world)
        ]

    def _answers(self) -> list[str]:
        """Every rank's answer line; the first ``FAIL`` ends the wait (the
        other ranks may be blocked in a collective the failed one left)."""
        answers: dict[int, str] = {}
        while len(answers) < self.world:
            waiting = {p.stdout: r for r, p in enumerate(self.procs) if r not in answers}
            ready, _, _ = select.select(list(waiting), [], [], self.timeout)
            if not ready:
                raise TimeoutError(f"no answer from ranks {sorted(waiting.values())} in "
                                   f"{self.timeout} s")
            for f in ready:
                line = f.readline().strip()
                if line != "DONE":
                    raise RuntimeError(f"rank {waiting[f]}: {line[:4000] or 'exited'}")
                answers[waiting[f]] = line
        return [answers[r] for r in range(self.world)]

    def run(self, task: str, inputs: dict) -> list:
        """Every rank's outputs of ``task`` on ``inputs``, in rank order."""
        n = next(self._ids)
        src = os.path.join(self.tmp, f"in{n}.pt")
        dst = os.path.join(self.tmp, f"out{n}")
        torch.save(inputs, src)
        line = json.dumps({"task": task, "in": src, "out": dst}) + "\n"
        for p in self.procs:
            p.stdin.write(line)
            p.stdin.flush()
        try:
            self._answers()
        except Exception:
            self.close(kill=True)
            raise
        return [torch.load(f"{dst}.{r}", weights_only=False) for r in range(self.world)]

    def close(self, kill: bool = False) -> None:
        """Stop the workers (``kill``: at once, after a failed task)."""
        for p in self.procs:
            if kill and p.poll() is None:
                p.kill()
            try:
                if p.poll() is None:
                    p.stdin.write(json.dumps({"task": "quit"}) + "\n")
                    p.stdin.flush()
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            for f in (p.stdin, p.stdout):
                if f is not None and not f.closed:
                    try:
                        f.close()
                    except OSError:
                        pass
        for f in self._logs:
            f.close()


__all__ = ["WorkerPool"]
