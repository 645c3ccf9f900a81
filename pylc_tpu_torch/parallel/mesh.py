"""Device meshes, ranks and the rank launcher.

Port of ``pylc_tpu/parallel/mesh.py``.  The JAX package has two kinds of
parallelism, and the port keeps both in PyTorch's own idiom:

  - one process drives several devices (JAX: a ``Mesh`` of chips, used by
    ``tester.test`` and ``Segmenter(mesh=...)``).  Here a :class:`Mesh` is
    an ordered list of torch devices: row bands go to devices, and halos
    move by ``Tensor.to(device, non_blocking=True)``, a peer copy between
    two cards and a plain copy where a mesh names one device twice.  No
    process group is involved.
  - data-parallel training (JAX: the mesh's 'data' axis, across hosts
    through ``jax.distributed``).  Here each rank is a process of its own
    under ``torch.distributed``, NCCL for CUDA and gloo for the CPU,
    started by :func:`spawn` on one host or by ``torchrun`` on several
    (:func:`init_distributed` reads its environment).
"""

from __future__ import annotations

import multiprocessing.connection
import os
import pickle
import signal
import tempfile
import time
import warnings
from datetime import timedelta
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"

#: seconds ``spawn`` waits for its ranks to finish; None waits as long as
#: they run (a training job takes hours)
JOIN_TIMEOUT_S: Optional[float] = None
#: seconds ``init_process_group`` and every collective may take
PG_TIMEOUT_S = 1800.0
#: seconds ``spawn`` lets the other ranks end by themselves once one has
#: failed, before it ends them
FAIL_GRACE_S = 10.0

#: the environment ``torchrun`` sets for each rank
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


class Mesh:
    """An ordered list of torch devices; band d of a row-banded program
    lives on ``devices[d]``.  A device may appear more than once (two
    bands on one card)."""

    def __init__(self, devices: Iterable):
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a Mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> List[torch.device]:
        """The mesh's devices without repeats, in order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def _indexed(device: torch.device) -> torch.device:
    """A bare ``cuda`` as the current CUDA device, so that two names of
    one card compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def get_mesh(n_devices: Optional[int] = None, device: str = "cuda") -> Mesh:
    """``cuda:0 .. n-1`` (every visible card for ``None``); raises when
    fewer cards are visible, never shrinking the request.  ``device="cpu"``
    gives ``n_devices`` (default 1) entries of the CPU."""
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    if kind != "cuda":
        raise ValueError(f"unsupported device '{device}' (cuda or cpu)")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n_devices is None else n_devices
    if visible == 0 or not 1 <= n <= visible:
        raise RuntimeError(
            f"a mesh of {n_devices if n_devices is not None else 'every'} "
            f"CUDA devices requested but {visible} are visible (pass "
            "--device cpu to run on the CPU)")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def batch_sharding(mesh: Mesh, n_rows: int) -> List[slice]:
    """The rows of an ``n_rows`` batch that each device of the mesh takes:
    contiguous, in mesh order, sizes differing by at most one (the first
    ``n_rows % size`` devices take one more)."""
    per, extra = divmod(n_rows, mesh.size)
    out, lo = [], 0
    for d in range(mesh.size):
        hi = lo + per + (1 if d < extra else 0)
        out.append(slice(lo, hi))
        lo = hi
    return out


def shard_batch(mesh: Mesh, *arrays):
    """Split each array's leading axis over the mesh
    (:func:`batch_sharding`) and put each part on its device.  Returns a
    list of per-device tensors for each array (the list alone for one)."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        out.append([t[s].to(dev, non_blocking=True) for s, dev in
                    zip(batch_sharding(mesh, t.shape[0]), mesh.devices)])
    return tuple(out) if len(out) > 1 else out[0]


# --------------------------------------------------------------------- #
# ranks
# --------------------------------------------------------------------- #

def in_group() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    if in_group():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    if in_group():
        return dist.get_rank()
    return 0


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable: its backward sums
    the ranks' gradients, so each rank's gradient is the whole world's
    derivative of one rank's copy of the result."""
    from torch.distributed.nn.functional import all_reduce
    with warnings.catch_warnings():
        # deprecated in favour of _functional_collectives.all_reduce,
        # which has no backward
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(t)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device: str = "cuda") -> bool:
    """Join this process to the ranks of a multi-host job: the
    counterpart of ``jax.distributed.initialize``.

    ``coordinator`` is rank 0's ``host:port``; with the arguments left
    out, each is read from the environment ``torchrun`` gives a rank
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), and
    without that environment this raises.  NCCL for ``device="cuda"``,
    whose rank takes card ``LOCAL_RANK``; gloo for the CPU.  Idempotent;
    returns whether the world holds more than one rank."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    world = num_processes if num_processes is not None \
        else _env_int("WORLD_SIZE")
    me = process_id if process_id is not None else _env_int("RANK")
    if coordinator is None or world is None or me is None:
        missing = [n for n in TORCHRUN_ENV if n != "LOCAL_RANK"
                   and not os.environ.get(n)]
        raise RuntimeError(
            "multi-host training needs each rank's place in the job, and "
            f"{', '.join(missing)} is not set: start every host's ranks "
            "with torchrun (e.g. torchrun --nnodes 2 --nproc_per_node 8 "
            "--rdzv_endpoint HOST:PORT -m pylc_tpu_torch train --multihost "
            "...), which sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and "
            "MASTER_PORT")
    kind = torch.device(device).type
    if kind == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else me % torch.cuda.device_count())
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}", rank=me,
                            world_size=world,
                            timeout=timedelta(seconds=PG_TIMEOUT_S))
    return world > 1


class RanksFailed(RuntimeError):
    """Ranks of :func:`spawn` failed.  ``errors`` maps each failed rank to
    its own error (its traceback, or how it exited); the message holds
    them all, rank by rank."""

    def __init__(self, what: str, errors: Dict[int, str]):
        self.errors = dict(sorted(errors.items()))
        super().__init__(
            f"{len(self.errors)} of the ranks of {what} failed:\n" +
            "\n".join(f"-- rank {r}:\n{e}" for r, e in self.errors.items()))


def _rank_main(r: int, fn: Callable, args: tuple, kwargs: Dict[str, Any],
               nprocs: int, init_file: str, backend: str,
               devices: Sequence[torch.device], result: str,
               pg_timeout_s: float) -> None:
    """One rank of :func:`spawn`: join the group, run ``fn``, keep rank
    0's result, leave the group."""
    torch.set_num_threads(1)
    if devices[r].type == "cuda":
        torch.cuda.set_device(devices[r])
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=r, world_size=nprocs,
                            timeout=timedelta(seconds=pg_timeout_s))
    try:
        out = fn(*args, **kwargs)
        if r == 0:
            torch.save(out, result)
    finally:
        dist.destroy_process_group()


def _rank_error(process, error_file: str) -> str:
    """A finished rank's own error: the traceback it left, or how it
    exited."""
    if os.path.exists(error_file):
        with open(error_file, "rb") as f:
            return pickle.load(f)
    code = process.exitcode
    if code is not None and code < 0:
        try:
            return f"terminated by signal {signal.Signals(-code).name}"
        except ValueError:
            return f"terminated by signal {-code}"
    return f"exited with code {code}"


def spawn(fn: Callable, nprocs: int, args: tuple = (),
          kwargs: Optional[Dict[str, Any]] = None, *,
          devices: Optional[Sequence] = None, backend: Optional[str] = None,
          timeout_s: Optional[float] = None) -> Any:
    """Run ``fn(*args, **kwargs)`` in ``nprocs`` new processes (start
    method spawn), each a rank of a process group of their own that meets
    through a file in a temporary directory of this call (no port is
    chosen ahead of time); returns rank 0's return value.

    ``fn`` must be importable by module and name.  ``devices[r]`` is rank
    r's device, made current there (default ``nprocs`` entries of the
    CPU); ``backend`` defaults to NCCL when every device is a card and
    gloo otherwise.  NCCL takes one rank per card; gloo also moves CUDA
    tensors for all-reduce and broadcast, so two ranks may share a card
    under it.  Each rank runs with one CPU thread.  ``timeout_s`` (default
    ``JOIN_TIMEOUT_S``) bounds the wait for the ranks and, with
    ``PG_TIMEOUT_S``, the group's set-up and collectives; the time running
    out ends every rank and raises ``TimeoutError``.  When a rank fails,
    the others get ``FAIL_GRACE_S`` to end by themselves (a rank whose
    peer died fails soon after it), then every rank still running is
    ended, and :class:`RanksFailed` carries each failed rank's own
    error."""
    devices = [torch.device(d) for d in
               (devices or [torch.device("cpu")] * nprocs)]
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    if backend is None:
        backend = "nccl" if all(d.type == "cuda" for d in devices) \
            else "gloo"
    if backend == "nccl" and len({str(_indexed(d)) for d in devices}) \
            != nprocs:
        raise ValueError(f"NCCL takes one rank per card, got {devices}; "
                         "use backend='gloo' to share a card")
    timeout_s = JOIN_TIMEOUT_S if timeout_s is None else timeout_s
    pg_timeout = PG_TIMEOUT_S if timeout_s is None else min(PG_TIMEOUT_S,
                                                            timeout_s)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="pylc_ranks_") as tmp:
        result = os.path.join(tmp, "rank0.pt")
        ctx = mp.start_processes(
            _rank_main, nprocs=nprocs, join=False, start_method="spawn",
            args=(fn, tuple(args), dict(kwargs or {}), nprocs,
                  os.path.join(tmp, "rendezvous"), backend, devices,
                  result, pg_timeout))
        procs = ctx.processes
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s

        def wait(until: Optional[float]) -> None:
            """Until every rank has ended, one has failed, or ``until``."""
            while any(p.is_alive() for p in procs) and not any(
                    p.exitcode not in (None, 0) for p in procs):
                left = None if until is None else until - time.monotonic()
                if left is not None and left <= 0:
                    return
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs if p.is_alive()], left)

        try:
            wait(deadline)
            if any(p.exitcode not in (None, 0) for p in procs):
                grace = time.monotonic() + FAIL_GRACE_S
                for p in procs:
                    p.join(max(0.0, grace - time.monotonic()))
                errors = {r: _rank_error(p, ctx.error_files[r])
                          for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)}
                raise RanksFailed(f"{fn.__qualname__} ({nprocs} ranks)",
                                  errors)
            if any(p.is_alive() for p in procs):
                raise TimeoutError(
                    f"{nprocs} ranks of {fn.__qualname__} did not finish "
                    f"within {timeout_s} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
            for f in ctx.error_files:  # torch's, in the temporary directory
                if os.path.exists(f):
                    os.remove(f)
        return torch.load(result, weights_only=False)
