"""Meshes across OS processes: ``torch.distributed`` under the mesh.

Port of ``seldon_core_tpu/parallel/mesh.py::initialize_distributed`` and of
what ``jax.distributed`` gives a JAX mesh whose devices live in several
processes. ``initialize_distributed`` reads the JAX package's three
variables (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``), so a manifest written for the reference boots the
port too, and joins the processes into one ``torch.distributed`` world.

The processes meet through a TCP store at the coordinator (what
``init_method="tcp://..."`` makes; process 0 serves it), and each reports
its host name and card count there before the backend is chosen. The
backend is decided once, logged and returned: ``backend=`` wins; otherwise
``nccl`` where every host has a card for each of its processes, and
``gloo`` otherwise (the CPU, or several processes on one card). Under NCCL
a process takes card ``LOCAL_RANK`` where a launcher sets it, else its
index among the processes of its host. A failed NCCL set-up raises: it is
never retried on gloo.

The collectives below are the only places where data crosses a process
boundary (``parallel/collectives.py`` calls them for the part of a mesh
axis that spans processes). Each is a ``torch.autograd.Function`` whose
backward is the transposed collective: an all-reduce's is an all-reduce,
an all-gather's an all-reduce of the gradient and its own slice, an
all-to-all's the all-to-all back, a send/receive's the receive/send back.
Under NCCL a card's tensors stay on the card. Gloo does not take CUDA
tensors for every collective, so under gloo a card's tensor goes through
pinned host memory, in ``_to_wire`` and ``_from_wire`` alone, and the
bytes it moves each way are counted by collective in ``STAGED_BYTES``
(``CROSS_CALLS`` counts the collectives).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import socket
from typing import Sequence

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

COORDINATOR_VAR = "JAX_COORDINATOR_ADDRESS"
NUM_PROCESSES_VAR = "JAX_NUM_PROCESSES"
PROCESS_ID_VAR = "JAX_PROCESS_ID"
BACKENDS = ("gloo", "nccl")
DEFAULT_TIMEOUT_S = 300.0
HOSTS_PREFIX = "seldon_hosts"  # the store's keys of the host reports

KINDS = ("all_reduce", "all_gather", "all_to_all", "send_recv")
# bytes copied between a card and pinned host memory for gloo, both ways
STAGED_BYTES: dict[str, int] = dict.fromkeys(KINDS, 0)
# collectives across processes, by kind (a backward's included)
CROSS_CALLS: dict[str, int] = dict.fromkeys(KINDS, 0)


def reset_counters() -> None:
    for counts in (STAGED_BYTES, CROSS_CALLS):
        for k in counts:
            counts[k] = 0


def counters() -> dict:
    return {"staged_bytes": dict(STAGED_BYTES), "cross_process_calls": dict(CROSS_CALLS)}


def host_report() -> tuple[str, int]:
    """This process's host name and the cards it sees."""
    return socket.gethostname(), torch.cuda.device_count() if torch.cuda.is_available() else 0


def exchange_hosts(store, rank: int, num_processes: int) -> list[tuple[str, int]]:
    """Every process's ``host_report()``, in rank order, through ``store``
    (each process sets its own and waits for the others')."""
    store.set(str(rank), json.dumps(host_report()))
    return [tuple(json.loads(store.get(str(r)))) for r in range(num_processes)]


def choose_backend(hosts: Sequence[tuple[str, int]]) -> str:
    """``nccl`` where every host has a card for each of its processes
    (``hosts``: each process's host name and card count), ``gloo``
    otherwise."""
    procs: dict[str, int] = {}
    for name, _ in hosts:
        procs[name] = procs.get(name, 0) + 1
    cards = dict(hosts)
    return "nccl" if all(0 < n <= cards[name] for name, n in procs.items()) else "gloo"


def card_index(hosts: Sequence[tuple[str, int]], rank: int) -> int:
    """The card process ``rank`` drives under NCCL: ``LOCAL_RANK`` where a
    launcher sets it, else the process's index among its host's processes;
    raises where the host has no such card."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    name, cards = hosts[rank]
    index = sum(1 for h, _ in hosts[:rank] if h == name)
    if index >= cards:
        raise ValueError(f"process {rank} is process {index} of host {name!r}, which has {cards} cards: "
                         "NCCL needs a card for each process (LOCAL_RANK chooses one)")
    return index


def _rendezvous(coordinator: str, rank: int, num_processes: int, timeout: datetime.timedelta):
    """The TCP store at ``coordinator`` that ``init_method="tcp://..."``
    would make."""
    store, _, _ = next(dist.rendezvous(f"tcp://{coordinator}", rank, num_processes, timeout=timeout))
    store.set_timeout(timeout)
    return store


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> str | None:
    """Join this process to the world of ``num_processes`` processes that
    meet at ``coordinator`` (``host:port``), as process ``process_id``.
    Arguments default from the JAX package's variables and override them;
    without a coordinator it does nothing and returns None. Returns the
    backend. Under NCCL the communicator is made here, so a refusal (two
    processes on one card) raises now."""
    coordinator = coordinator or os.environ.get(COORDINATOR_VAR)
    if not coordinator:
        return None
    n = int(num_processes if num_processes is not None else os.environ.get(NUM_PROCESSES_VAR, "1"))
    rank = int(process_id if process_id is not None else os.environ.get(PROCESS_ID_VAR, "0"))
    if not 0 <= rank < n:
        raise ValueError(f"process id {rank} is not one of {n} processes")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dist.is_initialized():
        if (backend or dist.get_backend(), n, rank) != (dist.get_backend(), dist.get_world_size(), dist.get_rank()):
            raise RuntimeError(f"torch.distributed is already initialized as process {dist.get_rank()} of "
                               f"{dist.get_world_size()} on {dist.get_backend()}")
        return dist.get_backend()
    timeout = datetime.timedelta(seconds=timeout_s)
    store = _rendezvous(coordinator, rank, n, timeout)
    hosts = exchange_hosts(dist.PrefixStore(HOSTS_PREFIX, store), rank, n)
    backend = backend or choose_backend(hosts)
    kwargs = {}
    if backend == "nccl":
        card = torch.device("cuda", card_index(hosts, rank))
        torch.cuda.set_device(card)
        kwargs["device_id"] = card  # the communicator is made now, not at the first collective
    log.info("torch.distributed: process %d of %d, backend %s, coordinator %s, hosts %s", rank, n, backend,
             coordinator, hosts)
    # what init_method="tcp://<coordinator>" does, on the store made above
    dist.init_process_group(backend=backend, store=dist.PrefixStore("default_pg", store), rank=rank, world_size=n,
                            timeout=timeout, **kwargs)
    if backend == "nccl":
        dist.barrier()
    return backend


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


_GROUPS: dict[tuple, object] = {}


def process_group(ranks: Sequence[int]):
    """The process group of ``ranks``, made once. ``new_group`` must be
    called by every process, members or not, in one order: meshes call it
    at build, in the order of their axes, and look their groups up there."""
    key = tuple(sorted(int(r) for r in ranks))
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key))
    return _GROUPS[key]


def _staging(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _to_wire(t: torch.Tensor, group, kind: str) -> torch.Tensor:
    """The tensor a collective sends: contiguous, and on pinned host memory
    for gloo when it lies on a card (counted)."""
    t = t.detach().contiguous()
    if t.is_cuda and _staging(group):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        STAGED_BYTES[kind] += t.numel() * t.element_size()
        return host
    return t


def _wire_like(shape, dtype, device: torch.device, group) -> torch.Tensor:
    """A receive buffer for a tensor that will live on ``device``."""
    if device.type == "cuda" and _staging(group):
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=device)


def _from_wire(t: torch.Tensor, device: torch.device, kind: str) -> torch.Tensor:
    if t.device != device:
        STAGED_BYTES[kind] += t.numel() * t.element_size()
        return t.to(device)
    return t


def reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group's processes, outside autograd: for
    gradients and values read out."""
    buf = _to_wire(t, group, "all_reduce")
    if buf is t or buf.data_ptr() == t.data_ptr():
        buf = buf.clone()
    dist.all_reduce(buf, group=group)
    CROSS_CALLS["all_reduce"] += 1
    return _from_wire(buf, t.device, "all_reduce")


def _all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    buf = _to_wire(t, group, "all_gather")
    parts = [_wire_like(buf.shape, buf.dtype, t.device, group) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    CROSS_CALLS["all_gather"] += 1
    return [_from_wire(p, t.device, "all_gather") for p in parts]


def _all_to_all(sends: Sequence[torch.Tensor], group) -> list[torch.Tensor]:
    """``sends[i]`` goes to member i of the group; entry i of the result
    came from member i, of the shape ``sends[i]`` has."""
    device = sends[0].device
    bufs = [_to_wire(t, group, "all_to_all") for t in sends]
    got = [_wire_like(b.shape, b.dtype, device, group) for b in bufs]
    dist.all_to_all(got, bufs, group=group)
    CROSS_CALLS["all_to_all"] += 1
    return [_from_wire(g, device, "all_to_all") for g in got]


def _spec(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


def _exchange(sends: Sequence[tuple[int, torch.Tensor]], recvs: Sequence[tuple[int, tuple]], group,
              ) -> list[torch.Tensor]:
    """Point to point: each (global rank, tensor) of ``sends`` goes to that
    rank; each (global rank, (shape, dtype, device)) of ``recvs`` receives
    such a tensor from it. Messages between one pair of processes match in
    list order."""
    ops, got = [], []
    for peer, t in sends:
        ops.append(dist.P2POp(dist.isend, _to_wire(t, group, "send_recv"), peer, group))
    for peer, (shape, dtype, device) in recvs:
        buf = _wire_like(shape, dtype, device, group)
        got.append((buf, device))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        CROSS_CALLS["send_recv"] += 1
    return [_from_wire(buf, dev, "send_recv") for buf, dev in got]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.index = group, dist.get_rank(group)
        return torch.stack(_all_gather(t, group))

    @staticmethod
    def backward(ctx, g):
        return reduce_sum(g, ctx.group)[ctx.index], None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *sends):
        ctx.group = group
        return tuple(_all_to_all(sends, group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_all_to_all(grads, ctx.group))


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, send_peers, recvs, *sends):
        ctx.group, ctx.recv_peers = group, [peer for peer, _ in recvs]
        ctx.send_specs = list(zip(send_peers, (_spec(t) for t in sends)))
        return tuple(_exchange(list(zip(send_peers, sends)), recvs, group))

    @staticmethod
    def backward(ctx, *grads):
        # the received tensors' gradients go back to their senders, the sent
        # ones' come back from their receivers
        back = _exchange(list(zip(ctx.recv_peers, grads)), ctx.send_specs, ctx.group)
        return (None, None, None, *back)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group's processes, differentiable."""
    return _AllReduce.apply(t, group)


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every process's ``t`` (one shape for all), in group order,
    differentiable."""
    return list(_AllGather.apply(t, group).unbind(0))


def all_to_all(sends: Sequence[torch.Tensor], group) -> list[torch.Tensor]:
    """``sends[i]`` to member i; the tensors received from each member, in
    group order (each of the shape of the one sent there), differentiable."""
    return list(_AllToAll.apply(group, *sends))


def exchange(sends: Sequence[tuple[int, torch.Tensor]], recvs: Sequence[tuple[int, torch.Tensor]], group,
             ) -> list[torch.Tensor]:
    """Each (global rank, tensor) of ``sends`` to that rank; from each
    (global rank, template) of ``recvs`` a tensor of the template's shape,
    dtype and device. Differentiable in the tensors sent."""
    if not sends and not recvs:
        return []
    return list(_Exchange.apply(group, tuple(p for p, _ in sends), tuple((p, _spec(t)) for p, t in recvs),
                                *(t for _, t in sends)))


def all_gather_object(obj) -> list:
    """Every process's picklable ``obj``, in rank order (the world)."""
    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
