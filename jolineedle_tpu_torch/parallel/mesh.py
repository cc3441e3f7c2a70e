"""Data-parallel training, one process ("rank") per device: the counterpart
of ``jolineedle_tpu/parallel/mesh.py``.

The JAX package runs one program over a mesh of the ``--devices`` with the
batch sharded on its ``data`` axis (``mesh.py:22-68``); under ``jit`` every
reduction over the batch is global and XLA inserts the gradient all-reduce.
Here rank r of W runs the train step on rows [r B, (r + 1) B) of a global
batch of W B rows, and the step computes what the mesh computes:

- every rank draws the random numbers of the whole global batch from one
  identically seeded generator and keeps its own rows (:func:`draw`);
- the denominators that the JAX step takes over the whole batch (the
  REINFORCE mask sum, SimOTA's foreground count, the CE mask sum) are summed
  over ranks (:func:`global_count`): rank r's loss is its share of the global
  loss, and the global loss is the sum of the ranks';
- train-mode BatchNorm normalises by the global batch's statistics: its sums
  go through :class:`AllReduceSum`, whose backward is an all-reduce sum too,
  the gradient of a loss that is the sum of the ranks' losses;
- after each iteration's backward passes the fresh gradients are summed over
  ranks in one flattened all-reduce and only then added to what the
  optimizer has accumulated (:func:`data_parallel`); the step's metrics are
  reduced in one more (:func:`reduce_metrics`).

So parameters, buffers, optimizer state and generator are bit-equal on every
rank after every iteration, and rank 0's checkpoint resumes every rank.

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used, the collectives
that gloo and NCCL both take on CUDA tensors: one code path serves gloo on
the CPU, gloo with several ranks sharing one card (NCCL refuses that), and
NCCL with one rank per card. The backend is NCCL for CUDA devices and gloo
for the CPU unless :func:`launch` is told otherwise.

The BatchNorm and denominator syncs and the global-shape draws act only
inside ``with data_parallel(world, ...)``, which the trainers' train step
enters: a test on rank 0 alone never reaches a collective.

Ranks start from :func:`launch` (``torch.multiprocessing`` spawn with a
``file://`` rendezvous: the train CLI's ``--devices 0 1 ...``) or join the
group that torchrun's environment describes (:func:`join_from_env`, for
several hosts), the counterpart of root ``main.py``'s ``jax.distributed``
gate.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import os
import sys
import tempfile
from collections import Counter, defaultdict
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

#: How long a collective waits for the other ranks. It outlasts rank 0's
#: test cycle, through which the others wait at a barrier (NCCL's default
#: is 10 minutes).
TIMEOUT = timedelta(minutes=60)

#: The collectives issued inside train steps, by kind ("bn", "count",
#: "gradients", "metrics"), and the bytes of the gradient all-reduces
#: ("gradient_bytes"). Nothing resets it; a reader takes differences.
counts: Counter = Counter()


@dataclass(frozen=True)
class World:
    """This process's place among the ranks: rank ``rank`` of ``size`` on
    ``device``, in a process group of ``backend`` (None: no group)."""

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None

    @property
    def grouped(self) -> bool:
        return self.backend is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def local(self, x):
        """This rank's rows of ``x``, whose leading dimension holds every
        rank's rows in rank order: [r n, (r + 1) n) of W n."""
        if self.size == 1:
            return x
        n, left = divmod(x.shape[0], self.size)
        if left:
            raise ValueError(f"{x.shape[0]} rows do not split over {self.size} ranks")
        return x[self.rank * n : (self.rank + 1) * n]

    def local_batch(self, batch: Dict[str, object]) -> Dict[str, object]:
        """This rank's rows of every entry of a global ``batch``."""
        return {k: self.local(v) for k, v in batch.items()}

    def barrier(self) -> None:
        if self.grouped:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()


def single(device) -> World:
    """The world of a run on one device, with no group."""
    return World(0, 1, torch.device(device))


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_devices(gpu_ids: Sequence[int], device=None) -> List[torch.device]:
    """The device of each rank of ``--devices gpu_ids``: ``cuda:i`` for
    each index ``i``, or, when ``device`` is the CPU, the CPU for each (a
    CUDA ``device`` with an index stands for a one-device run). Raises on a
    repeated index, an index the host does not have, or no card."""
    gpu_ids = [int(i) for i in gpu_ids]
    if len(set(gpu_ids)) != len(gpu_ids):
        raise ValueError(f"--devices {gpu_ids} repeats an index: one rank runs on each device")
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return [device] * len(gpu_ids)
        if device.index is not None and len(gpu_ids) == 1:
            return [resolve_device(device)]
    resolve_device("cuda")  # raises when there is no card
    n = torch.cuda.device_count()
    bad = sorted({i for i in gpu_ids if not 0 <= i < n})
    if bad:
        raise ValueError(f"--devices {bad} out of range: {n} device(s) visible")
    return [torch.device("cuda", i) for i in gpu_ids]


def init_world(rank: int, size: int, device, init_method: str,
               backend: Optional[str] = None) -> World:
    """Join the process group as rank ``rank`` of ``size`` on ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or default_backend(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size,
                            timeout=TIMEOUT)
    return World(rank, size, device, backend)


def close_world(world: World) -> None:
    if world.grouped and dist.is_initialized():
        dist.destroy_process_group()


def join_from_env(gpu_ids: Sequence[int], device=None) -> Optional[World]:
    """Join the group that torchrun's environment describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), even
    of size 1; None when the environment names no group. Local rank ``l``
    runs on the ``l``-th device of :func:`rank_devices` (``--devices``
    lists this host's devices, one per local rank), or on the CPU when
    ``device`` is the CPU."""
    if "WORLD_SIZE" not in os.environ:
        return None
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    devices = rank_devices(gpu_ids, device)
    if devices[0].type == "cuda" and local >= len(devices):
        raise ValueError(f"local rank {local} has no device: --devices {list(gpu_ids)} names"
                         f" {len(devices)} on this host")
    return init_world(rank, size, devices[min(local, len(devices) - 1)], "env://")


def launch(fn: Callable, args: tuple, devices: Sequence, backend: Optional[str] = None,
           rendezvous_dir=None) -> list:
    """Run ``fn(world, *args)`` in one spawned process per entry of
    ``devices`` (rank r on ``devices[r]``), the ranks joined in one group
    of ``backend`` (default: :func:`default_backend`); returns what each
    rank returned, in rank order.

    ``fn`` is pickled by name, and a spawned process starts from a fresh
    interpreter: it must be a module-level function of this package. What
    it returns goes back through ``torch.save``. Each rank takes the
    caller's intra-op thread count. The rendezvous file and the results
    lie in ``rendezvous_dir`` (default: a temporary directory, removed
    after). If a rank raises, the others are stopped and this raises."""
    devices = [torch.device(d) for d in devices]
    with contextlib.ExitStack() as stack:
        if rendezvous_dir is None:
            rendezvous_dir = stack.enter_context(tempfile.TemporaryDirectory(prefix="ranks-"))
        rendezvous_dir = Path(rendezvous_dir)
        rendezvous = rendezvous_dir / "rendezvous"
        if rendezvous.exists():
            rendezvous.unlink()
        torch.multiprocessing.start_processes(
            _rank_main, nprocs=len(devices), join=True, start_method="spawn",
            args=(fn, args, devices, backend, str(rendezvous_dir), torch.get_num_threads()))
        return [torch.load(rendezvous_dir / f"rank{r}.pt", weights_only=False)
                for r in range(len(devices))]


def _rank_main(rank, fn, args, devices, backend, rendezvous_dir, threads):
    torch.set_num_threads(threads)
    world = init_world(rank, len(devices), devices[rank],
                       f"file://{rendezvous_dir}/rendezvous", backend)
    try:
        result = fn(world, *args)
    finally:
        close_world(world)
    torch.save(result, Path(rendezvous_dir) / f"rank{rank}.pt")


def quiet_unless_main(world: World) -> None:
    """Only rank 0 prints: the other ranks' standard output goes to the null
    device (their errors still reach standard error)."""
    if not world.is_main:
        sys.stdout = open(os.devnull, "w")


# --- inside a train step ----------------------------------------------------------------
_ACTIVE: contextvars.ContextVar[Optional[World]] = contextvars.ContextVar(
    "data_parallel_world", default=None)


@contextlib.contextmanager
def data_parallel(world: World, params: Iterable[torch.nn.Parameter] = ()):
    """The body of a train step over ``world``'s ranks. Inside it the draws,
    the train-mode BatchNorm statistics and the loss denominators are those
    of the global batch; on leaving it normally, the gradients that the body
    gave ``params`` are summed over ranks and added to the gradients those
    held on entry. Without a group it changes nothing."""
    if not world.grouped:
        yield
        return
    params = list(params)
    held = [p.grad for p in params]
    for p in params:
        p.grad = None
    token = _ACTIVE.set(world)
    try:
        yield
    finally:
        _ACTIVE.reset(token)
    sum_gradients(params, held)


def active_size() -> int:
    """The number of ranks whose rows make up the global batch here: the
    world's size inside :func:`data_parallel`, else 1."""
    world = _ACTIVE.get()
    return 1 if world is None else world.size


class AllReduceSum(torch.autograd.Function):
    """The sum over ranks; its backward is the sum over ranks of the
    gradient, since the loss differentiated is the sum of the ranks'."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (BatchNorm's sums) summed over ranks, differentiably, inside
    :func:`data_parallel`; ``x`` itself outside."""
    if _ACTIVE.get() is None:
        return x
    counts["bn"] += 1
    return AllReduceSum.apply(x)


def global_count(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a count, not differentiated) summed over ranks inside
    :func:`data_parallel`; ``x`` itself outside."""
    if _ACTIVE.get() is None:
        return x
    counts["count"] += 1
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


def draw(sample: Callable, shape) -> torch.Tensor:
    """``sample(shape)``, a draw from a generator, for this rank's rows.
    Inside :func:`data_parallel` it is drawn at the global shape (the
    leading dimension times the world's size) and cut to this rank's rows,
    so every rank's generator advances as a one-device run's at the global
    batch does, and the rows are that run's."""
    world = _ACTIVE.get()
    shape = tuple(shape)
    if world is None:
        return sample(shape)
    return world.local(sample((shape[0] * world.size,) + shape[1:]))


def _by_dtype(tensors: List[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    groups = defaultdict(list)
    for i, t in enumerate(tensors):
        groups[t.dtype].append(i)
    return groups


@torch.no_grad()
def sum_gradients(params: Sequence[torch.nn.Parameter],
                  held: Optional[Sequence[Optional[torch.Tensor]]] = None) -> None:
    """Replace each parameter's gradient (zeros where it has none) by its
    sum over ranks, one flattened all-reduce per dtype, plus its entry of
    ``held`` (gradients already equal on every rank; None: nothing)."""
    params = list(params)
    held = list(held) if held is not None else [None] * len(params)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    for ids in _by_dtype(grads).values():
        flat = torch.cat([grads[i].reshape(-1) for i in ids])
        dist.all_reduce(flat)
        counts["gradients"] += 1
        counts["gradient_bytes"] += flat.numel() * flat.element_size()
        for i, g in zip(ids, flat.split([grads[i].numel() for i in ids])):
            g = g.view_as(params[i])
            params[i].grad = g if held[i] is None else held[i].add_(g)


def reduce_metrics(metrics: Dict[str, torch.Tensor], world: World, mean: Sequence[str] = (),
                   same: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """A step's metrics over the global batch, in one all-reduce: summed
    over ranks (a rank's share of a global loss, a count), averaged (the
    names in ``mean``: a mean over the rank's own rows) or kept (the names
    in ``same``: already global)."""
    if not world.grouped:
        return metrics
    names = [k for k in metrics if k not in same]
    flat = torch.stack([metrics[k].float() for k in names])
    dist.all_reduce(flat)
    counts["metrics"] += 1
    out = dict(metrics)
    for k, v in zip(names, flat.unbind()):
        out[k] = v / world.size if k in mean else v
    return out


@torch.no_grad()
def broadcast_tensors(tensors: Iterable[torch.Tensor], world: World) -> None:
    """Overwrite ``tensors`` on every rank with rank 0's, one broadcast per
    dtype."""
    if not world.grouped:
        return
    tensors = list(tensors)
    for ids in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in ids])
        dist.broadcast(flat, 0)
        for i, v in zip(ids, flat.split([tensors[i].numel() for i in ids])):
            tensors[i].copy_(v.view_as(tensors[i]))


# --- rank agreement ------------------------------------------------------------------------
def digest(obj) -> str:
    """SHA-256 of a nest of dicts, lists, tensors, arrays and scalars: the
    tensors' dtypes, shapes and bytes, in a fixed order."""
    h = hashlib.sha256()
    _feed(h, obj)
    return h.hexdigest()


def _feed(h, obj) -> None:
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous().reshape(-1)
        h.update(f"{t.dtype}{tuple(obj.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    elif isinstance(obj, np.ndarray):
        h.update(f"{obj.dtype}{obj.shape}".encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, dict):
        for k in sorted(obj, key=repr):
            h.update(repr(k).encode())
            _feed(h, obj[k])
    elif isinstance(obj, (list, tuple)):
        h.update(b"[")
        for v in obj:
            _feed(h, v)
        h.update(b"]")
    else:
        h.update(repr(obj).encode())


def check_agree(world: World, hexdigest: str) -> None:
    """Raise on every rank unless every rank's ``hexdigest`` equals rank
    0's (one broadcast and one all-reduce)."""
    if not world.grouped:
        return
    mine = torch.tensor(list(bytes.fromhex(hexdigest)), dtype=torch.uint8, device=world.device)
    ref = mine.clone()
    dist.broadcast(ref, 0)
    differ = torch.tensor([float(not torch.equal(mine, ref))], device=world.device)
    dist.all_reduce(differ)
    if differ.item():
        raise RuntimeError(f"the ranks disagree: the state of {int(differ.item())} of"
                           f" {world.size} ranks differs from rank 0's")
