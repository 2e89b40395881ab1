"""A cell on several cards: its ranks launched, one card each, and joined.

A cell whose ``chips`` is P > 1 runs as P rank processes.  Rank 0 runs in
the run's own process on the first device, so the check against the
reference and the result's line stay there; ranks 1 .. P-1 each run in a
fresh interpreter (``subprocess``: never a fork after CUDA has started),
each in a process group of its own.  Every rank calls its entry's

    run_rank(rank, ranks, coordinator, cfg, mix, seed, seconds, trace,
             device, t_start, start) -> window.Window

``coordinator`` is ``127.0.0.1:<port>``, on a port that was free at the
launch, which the entry hands to the program's own rendezvous: the harness
runs no collective of its own.  ``start()`` is the harness's host barrier.
Each rank calls it once, when its warm-up is done, and it returns one
``time.perf_counter()`` instant, the same on every rank, at which each
opens its window; the window's deadline and its traced stretch follow from
it.  ``perf_counter`` is CLOCK_MONOTONIC on Linux, one clock for every
process of the host, so the ranks' stamps and ``t_start`` (the run's
start, in rank 0's process) lie on one time line.  A rank hands its part
of the window back (its ``Checked`` arrays with it) as a pickle in a
temporary directory that the launcher owns, with what ``isolation.found``
reads at its end; ``window.merge`` joins the parts.

If a rank fails, or the ranks have not all finished ``seconds`` +
``SETUP_ALLOWANCE_S`` after the launch, every rank's process group is
killed and ``RankError`` names the rank, ending with its last output.
Should rank 0 then not come back within ``UNWIND_S`` (it waits inside the
program, say, for a peer that is gone), the process says so and exits 1.
A cell on one card runs its entry's ``run`` in this process, as it always
has: no child, no barrier, no temporary file.
"""

from __future__ import annotations

import os
import pickle
import select
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from benchlib import isolation, spec
from benchlib import window as W

#: Seconds beyond the window's within which every rank has to set up, warm
#: up and hand back its part.  The one-card cell sets up in ~22 s warm and
#: in ~56 s in a checkout's first run, which builds the kernels (ledger,
#: PR 25), and a fresh checkout's ranks build at once: 240 s covers that
#: four times over, and with the window and the reference's check after it
#: still ends a warm run inside the 360 s that a run is given.
SETUP_ALLOWANCE_S = 240.0
#: how long rank 0 may take to come back once the others are killed
UNWIND_S = 10.0
#: the common start lies this far after the last rank is ready, so that
#: every rank has it before it comes
START_MARGIN_S = 0.05
POLL_S = 0.05
#: the end of a failing rank's output that its error carries
TAIL_CHARS = 4000

_CHILD = ("import sys; sys.path[:0] = sys.argv[1:3]; "
          "from benchlib import ranks; sys.exit(ranks.child(*sys.argv[3:]))")


class RankError(RuntimeError):
    """A rank failed, or the ranks outran their allowance."""


def devices(chips: int, device=None) -> list:
    """Each rank's device: ``device`` for every rank where one is given (the
    tests' hook: gloo ranks on the CPU, or a rehearsal on one card), else
    ``cuda:0`` .. ``cuda:<chips - 1>``; LookupError without enough cards."""
    if device is not None:
        return [device] * chips
    import torch
    if not torch.cuda.is_available():
        raise LookupError("no CUDA device: the benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise LookupError(f"needs {chips} cards, "
                          f"{torch.cuda.device_count()} here")
    return [f"cuda:{r}" for r in range(chips)]


def run(entry, cfg: dict, mix: dict, seed: int, seconds: float,
        trace: bool, devs: list, t_start: float, plant=None) -> tuple:
    """The cell's window on ``devs``, one rank each: (window, loaded), where
    ``loaded`` lists the JAX modules ranks 1 .. P-1 held at their end (rank
    0's process checks its own).  ``plant`` names a fault of
    ``benchlib/faults.py`` to plant in ranks 1 .. P-1 (the caller plants its
    own)."""
    if len(devs) == 1:
        return entry.run(cfg, mix, seed, seconds, trace, devs[0],
                         t_start), []
    if not hasattr(entry, "run_rank"):
        raise RankError(f"entry {cfg['entry']} has no run_rank, which a "
                        f"cell on {len(devs)} cards needs")
    job = {"bench": str(Path(entry.__file__).resolve().parent.parent),
           "cfg": cfg, "mix": mix, "seed": seed, "seconds": seconds,
           "trace": trace, "devices": list(devs), "t_start": t_start,
           "coordinator": f"127.0.0.1:{free_port()}", "plant": plant,
           "parent": os.getpid()}
    with _Launch(entry, job) as launch:
        return launch.run()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sleep_until(t: float) -> None:
    while (left := t - time.perf_counter()) > 0:
        time.sleep(left)


class _Launch:
    """Ranks 1 .. P-1 as child processes, rank 0 here, and a watchdog that
    kills them all on a failure or at the deadline."""

    def __init__(self, entry, job: dict):
        self.entry, self.job = entry, job
        self.n = len(job["devices"])
        self.dir = Path(tempfile.mkdtemp(prefix="bench-ranks-"))
        self.t_launch = time.perf_counter()
        self.deadline = self.t_launch + job["seconds"] + SETUP_ALLOWANCE_S
        self.procs: dict = {}
        self.ready: dict = {}       # rank -> read end: the rank is ready
        self.go: dict = {}          # rank -> write end: the common start
        self.t0 = None
        self.error = None
        self.back = threading.Event()       # rank 0 came back

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.back.set()
        self._kill()
        for fd in [*self.ready.values(), *self.go.values()]:
            os.close(fd)
        shutil.rmtree(self.dir, ignore_errors=True)

    def run(self) -> tuple:
        job = self.job
        with open(self.dir / "job.pkl", "wb") as f:
            pickle.dump(job, f)
        for r in range(1, self.n):
            self._spawn(r)
        threading.Thread(target=self._watch, daemon=True).start()
        try:
            part = self.entry.run_rank(
                0, self.n, job["coordinator"], job["cfg"], job["mix"],
                job["seed"], job["seconds"], job["trace"], job["devices"][0],
                job["t_start"], self.start)
            if self.t0 is None:
                raise RankError("rank 0 returned without calling start()")
            got = [{"window": part, "loaded": []}]
            got += [self._collect(r) for r in range(1, self.n)]
        except RankError:
            raise
        except BaseException as e:
            if self.error is not None:
                raise RankError(self.error) from e
            raise
        finally:
            self.back.set()
        for r in range(1, self.n):
            for line in (self.dir / f"rank{r}.log").read_text(
                    errors="replace").splitlines():
                print(f"rank {r}| {line}", file=sys.stderr)
        loaded = [f"rank {r}: {name}" for r, g in enumerate(got)
                  for name in g["loaded"]]
        return W.merge([g["window"] for g in got],
                       self.t0 - job["t_start"]), loaded

    def _spawn(self, r: int) -> None:
        ready_r, ready_w = os.pipe()
        go_r, go_w = os.pipe()
        self.ready[r], self.go[r] = ready_r, go_w
        bench = Path(self.job["bench"])
        try:
            with open(self.dir / f"rank{r}.log", "wb") as log:
                self.procs[r] = subprocess.Popen(
                    [sys.executable, "-c", _CHILD, str(bench),
                     str(bench.parent), str(self.dir), str(r), str(ready_w),
                     str(go_r)],
                    stdin=subprocess.DEVNULL, stdout=log,
                    stderr=subprocess.STDOUT, pass_fds=(ready_w, go_r),
                    start_new_session=True)
        finally:
            os.close(ready_w)
            os.close(go_r)

    def start(self) -> float:
        """Rank 0's side of the barrier: wait for every other rank's word,
        then hand each the common start."""
        if self.t0 is not None:
            raise RankError("start() called twice")
        waiting = {fd: r for r, fd in self.ready.items()}
        while waiting:
            if self.error is not None:
                raise RankError(self.error)
            ready, _, _ = select.select(list(waiting), [], [], POLL_S)
            for fd in ready:
                r = waiting.pop(fd)
                if not os.read(fd, 1):
                    raise RankError(self._failed(r, "ended before its "
                                                    "window"))
        t_ready = time.perf_counter()
        self.t0 = t_ready + START_MARGIN_S
        for fd in self.go.values():
            try:
                os.write(fd, f"{self.t0!r}\n".encode())
            except BrokenPipeError:         # that rank is gone: _collect
                pass
        print(f"ranks: {self.n} on {', '.join(self.job['devices'])}; all "
              f"ready {t_ready - self.t_launch:.3f} s after the launch, "
              f"{t_ready - self.job['t_start']:.3f} s after the run's "
              "start", file=sys.stderr, flush=True)
        _sleep_until(self.t0)
        return self.t0

    def _collect(self, r: int) -> dict:
        p = self.procs[r]
        try:
            rc = p.wait(timeout=max(0.0, self.deadline - time.perf_counter())
                        + UNWIND_S)
        except subprocess.TimeoutExpired:
            raise RankError(self.error or f"rank {r} outran the deadline")
        if rc != 0:
            raise RankError(self.error or self._failed(r, "failed"))
        path = self.dir / f"rank{r}.pkl"
        if not path.is_file():
            raise RankError(self._failed(r, "handed back no window"))
        with open(path, "rb") as f:
            return pickle.load(f)

    def _watch(self) -> None:
        while not self.back.wait(POLL_S):
            failed = [r for r, p in self.procs.items()
                      if p.poll() not in (None, 0)]
            if failed:
                self._abort(self._failed(failed[0], "failed"))
                return
            if time.perf_counter() > self.deadline:
                late = [r for r, p in self.procs.items() if p.poll() is None]
                self._abort(
                    f"the ranks outran {self.job['seconds']} s + "
                    f"{SETUP_ALLOWANCE_S} s of set-up (still running: rank "
                    f"{', '.join(map(str, late or [0]))})")
                return

    def _abort(self, message: str) -> None:
        self.error = message
        self._kill()
        if not self.back.wait(UNWIND_S):
            print(f"{message}\nrank 0 did not come back within {UNWIND_S} "
                  "s of the others' end: exiting", file=sys.stderr,
                  flush=True)
            os._exit(1)

    def _failed(self, r: int, what: str) -> str:
        try:
            rc = self.procs[r].wait(timeout=UNWIND_S)
        except subprocess.TimeoutExpired:
            rc = None
        tail = (self.dir / f"rank{r}.log").read_bytes()[-TAIL_CHARS:]
        return (f"rank {r} {what} (exit {rc}); its last output:\n"
                + tail.decode(errors="replace"))

    def _kill(self) -> None:
        for p in self.procs.values():
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for p in self.procs.values():
            p.wait()


def child(job_dir: str, rank: str, ready_fd: str, go_fd: str) -> int:
    """Rank ``rank``'s process: its entry's ``run_rank``, its part of the
    window written back into ``job_dir``."""
    job_dir, rank = Path(job_dir), int(rank)
    ready_fd, go_fd = int(ready_fd), int(go_fd)
    with open(job_dir / "job.pkl", "rb") as f:
        job = pickle.load(f)
    threading.Thread(target=_exit_if_orphaned, args=(job["parent"],),
                     daemon=True).start()
    if job["plant"]:
        from benchlib import faults
        faults.plant(job["plant"])
    entry = spec.module("entries", job["cfg"]["entry"], Path(job["bench"]))
    started = []

    def start() -> float:
        if started:
            raise RankError("start() called twice")
        started.append(True)
        os.write(ready_fd, b"r")
        line = b""
        while not line.endswith(b"\n"):
            chunk = os.read(go_fd, 64)
            if not chunk:
                raise RankError("the launcher went away before the window")
            line += chunk
        t0 = float(line)
        _sleep_until(t0)
        return t0

    part = entry.run_rank(rank, len(job["devices"]), job["coordinator"],
                          job["cfg"], job["mix"], job["seed"],
                          job["seconds"], job["trace"], job["devices"][rank],
                          job["t_start"], start)
    if not started:
        raise RankError(f"rank {rank} returned without calling start()")
    tmp = job_dir / f"rank{rank}.pkl.part"
    with open(tmp, "wb") as f:
        pickle.dump({"window": part, "loaded": isolation.found()}, f)
    os.replace(tmp, job_dir / f"rank{rank}.pkl")
    return 0


def _exit_if_orphaned(parent: int) -> None:
    """A rank whose launcher is gone ends too."""
    while True:
        time.sleep(0.5)
        if os.getppid() != parent:
            os._exit(1)
