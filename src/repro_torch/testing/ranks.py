"""Run one function on several ``torch.distributed`` ranks, each its own
process (the port's stand-in for the JAX package's multi-device CPU
subprocesses).

    results = run_ranks(fn, 3, backend="gloo", device="cpu",
                        store_dir=tmp_path, args=(...))

``device`` is where every rank computes; it defaults to the card
(``cuda:0`` unless another index is given) and raises on a host without
one, so the CPU runs only when asked, as above.

Each rank is a process started with the **spawn** method (a fork after
CUDA has started is broken), joins a default process group through a
``FileStore`` under ``store_dir`` (no TCP port, so concurrent runs never
collide), calls ``fn(*args)`` and writes what it returns (tensors moved to
the CPU) under ``store_dir``.  :func:`run_ranks` returns the list of the
ranks' results in rank order, or raises :class:`RankFailed` with the
traceback of the rank that failed first; the other ranks are then ended, so a
rank that waits in a collective for a failed peer never hangs the caller.
"""
from __future__ import annotations

import pathlib
import time
import traceback

import torch

from ..core.config import resolve_device


class RankFailed(RuntimeError):
    """A rank of :func:`run_ranks` raised (or died); ``rank`` is the rank
    that failed first and the message holds its traceback."""

    def __init__(self, rank: int, message: str):
        super().__init__(f"rank {rank} failed:\n{message}")
        self.rank = rank


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_cpu(v) for v in x)
    if isinstance(x, tuple):                 # NamedTuple
        return type(x)(*(_to_cpu(v) for v in x))
    return x


def _rank_main(fn, rank: int, world: int, backend: str, device: str,
               store_dir: str, args: tuple) -> None:
    import torch.distributed as dist
    out = pathlib.Path(store_dir)

    def failed():
        # written before the group is torn down, so this rank's time stamp
        # precedes the errors its peers then see
        (out / f"error_{rank}.txt").write_text(
            f"{time.time()!r}\n{traceback.format_exc()}")
    try:
        # ranks share the host's cores: one intra-op thread each
        torch.set_num_threads(1)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        store = dist.FileStore(str(out / "filestore"), world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
    except BaseException:
        failed()
        raise SystemExit(1)
    try:
        result = fn(*args)
    except BaseException:
        failed()
        dist.destroy_process_group()
        raise SystemExit(1)
    dist.destroy_process_group()
    torch.save(_to_cpu(result), out / f"result_{rank}.pt")


def run_ranks(fn, world: int, *, backend: str = "gloo", device="cuda",
              store_dir, args: tuple = (), timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world`` ranks (see module docstring), each
    with one intra-op thread.  ``fn`` must be importable by name (a
    module-level function); ``store_dir`` must be empty or new."""
    import torch.multiprocessing as mp
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    out = pathlib.Path(store_dir)
    out.mkdir(parents=True, exist_ok=True)
    if any(out.iterdir()):
        raise ValueError(f"store_dir {out} is not empty")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, str(device), str(out),
                               tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            alive = [p for p in procs if p.exitcode is None]
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                failed = bad[0]
                # a peer may wait in a collective for the failed rank
                grace = time.monotonic() + 5.0
                while any(p.exitcode is None for p in procs) \
                        and time.monotonic() < grace:
                    time.sleep(0.05)
                break
            if not alive:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"run_ranks: {len(alive)} of {world} ranks still "
                    f"running after {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.exitcode is None:
                p.terminate()
            p.join(10)
            if p.exitcode is None:
                p.kill()
                p.join()
    # The rank that failed first in time: its peers' errors are usually
    # the broken collective that followed.
    errors = sorted((float(text.split("\n", 1)[0]),
                     int(f.stem.split("_")[1]), text.split("\n", 1)[1])
                    for f in out.glob("error_*")
                    for text in [f.read_text()])
    if errors:
        _, rank, msg = errors[0]
        raise RankFailed(rank, msg)
    if failed is not None:
        raise RankFailed(failed, f"exit code {procs[failed].exitcode}")
    return [torch.load(out / f"result_{r}.pt", weights_only=False)
            for r in range(world)]
