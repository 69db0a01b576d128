"""Rank groups: the port's counterpart of a named mesh axis.

Counterpart of ``apex_tpu/parallel/mesh.py``. Under JAX every device of
an axis runs one program (``shard_map``), and ``jax.lax.axis_index`` /
``axis_size`` name a device's place on it. Here every rank is a process
with its own shard, and a :class:`RankGroup` over a ``torch.distributed``
process group plays the axis: :meth:`RankGroup.axis_index`,
:meth:`RankGroup.axis_size` and the device the rank computes on. The
process group is gloo: it serves the rendezvous, the exchange of CUDA IPC
handles and host barriers, and the plain (CPU) versions of the
exchanges. It never carries a CUDA tensor's data: the ranks' CUDA
tensors move through the peer-put kernels of
:mod:`apex_tpu_torch.ops.remote_copy`, which work between processes that
share one card as between cards.

:func:`spawn_ranks` runs a function on ``world`` such processes and
returns what each rank returned, or raises when a rank fails or hangs.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from apex_tpu_torch.utils.device import DeviceLike, resolve_device

# a bounded wait of the peer-put kernels (csrc/remote_copy.cu): past it a
# missing signal traps on the device
DEFAULT_WAIT_TIMEOUT_S = 60.0


class RankGroup:
    """One axis of ranks. ``pg`` is a gloo process group (default: the
    world group once ``torch.distributed`` is initialised, else a group of
    this one process). ``device`` is where the rank's tensors live:
    ``cuda:<current>`` unless the caller asks for the CPU. A peer-put wait
    that sees no signal for ``wait_timeout_s`` seconds (an attribute,
    ``DEFAULT_WAIT_TIMEOUT_S`` unless set) traps on the device.

    :meth:`close` is collective: every rank calls it, after which the
    arenas that the group's exchanges and pools mapped are unmapped and
    freed."""

    def __init__(self, pg=None, device: DeviceLike = None):
        if pg is None and dist.is_available() and dist.is_initialized():
            pg = dist.group.WORLD
        self.pg = pg
        if pg is None:
            self.rank, self.world = 0, 1
        else:
            self.rank = dist.get_rank(pg)
            self.world = dist.get_world_size(pg)
        self.device = resolve_device(device)
        self.wait_timeout_s = DEFAULT_WAIT_TIMEOUT_S
        # IPC arenas mapped for this group (ops.remote_copy.IpcArena),
        # freed by close(); `remote` holds the exchanges' own state
        self.arenas: list = []
        self.remote = None

    def axis_index(self) -> int:
        return self.rank

    def axis_size(self) -> int:
        return self.world

    def global_rank(self, rank: int) -> int:
        """The ``torch.distributed`` rank of this group's rank ``rank``."""
        if self.pg is None or self.pg is dist.group.WORLD:
            return rank
        return dist.get_global_rank(self.pg, rank)

    def barrier(self) -> None:
        if self.pg is not None:
            dist.barrier(group=self.pg)

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj`` in rank order (host data only)."""
        if self.pg is None:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.pg)
        return out

    def close(self) -> None:
        """Unmap and free the group's arenas (collective). The device is
        synchronised first and every rank waits for every other, so no
        kernel still writes into an arena when its peers unmap it and its
        owner frees it."""
        if not self.arenas:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.barrier()
        for arena in self.arenas:
            arena.unmap_peers()
        self.barrier()
        for arena in self.arenas:
            arena.free()
        self.arenas = []
        self.remote = None


def _rank_main(rank, world, tmp, device, timeout_s):
    """One spawned rank: join the gloo group through the file store,
    build its :class:`RankGroup`, run ``fn(group, *args)`` (both read from
    the directory), write the result (or the traceback) for the parent."""
    out = Path(tmp) / f"rank{rank}.pkl"
    try:
        with open(Path(tmp) / "call.pkl", "rb") as f:
            fn, args = pickle.load(f)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index)
        # the ranks share the host's cores: no rank oversubscribes them
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/store", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        group = RankGroup(device=dev)
        value = fn(group, *args)
        group.close()
        result = {"ok": True, "value": value}
    except BaseException:  # noqa: BLE001 - reported to the parent
        result = {"ok": False, "error": traceback.format_exc()}
    tmp_out = out.with_suffix(".tmp")
    with open(tmp_out, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp_out, out)
    if result["ok"] and dist.is_initialized():
        # the value is delivered: a teardown that raises (a peer still
        # running, a loaded host) must not turn this rank into a failed
        # one, whose peers the parent would then stop early
        try:
            dist.destroy_process_group()
        except Exception:  # noqa: BLE001 - the process exits next
            pass
    # a failed rank's peers may wait in a collective: leave at once and
    # let the parent stop them
    os._exit(0 if result["ok"] else 1)


def spawn_ranks(fn: Callable, world: int, args: Sequence[Any] = (), *,
                device: DeviceLike = None, timeout_s: float = 300.0
                ) -> List[Any]:
    """Run ``fn(group, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method), one :class:`RankGroup` rank each, joined
    through a ``file://`` store in a temporary directory (no TCP port).
    Returns the values in rank order; they must pickle (numpy arrays, not
    CUDA tensors). ``fn`` must be importable by the children without JAX.
    Every rank runs on the current card (several processes share one card
    through CUDA IPC) unless the caller asks for the CPU
    (``device="cpu"``). Build the kernels first (``_build.build()``) so
    the ranks do not each run nvcc.

    Raises ``RuntimeError`` when a rank raises, dies, or has not finished
    within ``timeout_s`` seconds; the ranks still running are killed."""
    device = str(resolve_device(device))
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="apex_ranks_") as tmp:
        # the call goes through a file: a large argument written down a
        # child's pipe would hold each start() until that child has
        # imported everything, so the ranks would start one by one
        with open(Path(tmp) / "call.pkl", "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, tmp, device, timeout_s),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed_at, timed_out = None, False
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            # the deadline first: a rank still running past it is hung,
            # whatever its peers did meanwhile
            if now > deadline:
                timed_out = True
                break
            if failed_at is None and any(
                    p.exitcode not in (None, 0) for p in procs):
                failed_at = now
            # a failed rank leaves its peers waiting: give them a moment
            # to fail on their own, then stop them
            if failed_at is not None and now > failed_at + 2.0:
                break
            time.sleep(0.05)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results, errors = [], []
        for r, p in enumerate(procs):
            path = Path(tmp) / f"rank{r}.pkl"
            res = None
            if path.exists():
                with open(path, "rb") as f:
                    res = pickle.load(f)
            if res is not None and res["ok"] and p.exitcode == 0:
                results.append(res["value"])
            elif res is not None and not res["ok"]:
                errors.append(f"rank {r} raised:\n{res['error']}")
            elif r in hung and not timed_out:
                errors.append(f"rank {r} was stopped after another rank "
                              f"failed")
            elif r in hung:
                errors.append(f"rank {r} did not finish within "
                              f"{timeout_s} s and was killed")
            else:
                errors.append(f"rank {r} died (exit code {p.exitcode})")
        if errors:
            raise RuntimeError(f"spawn_ranks({getattr(fn, '__name__', fn)},"
                               f" world={world}) failed:\n"
                               + "\n".join(errors))
        return results
