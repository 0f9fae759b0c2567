"""Marker sharding over torch.distributed ranks (port of vampomi_tpu/sharding.py).

The reference splits the marker dimension M over MPI ranks with
`divide_work` (src/utilities.cpp:207-239); the JAX package splits it over a
device mesh and lets XLA insert the psums.  Here each rank is one process
that holds one contiguous slab of markers [lo, hi) — no padding rows, the
first Mt % P ranks one marker more — and every reduction over markers is
written out as a local sum followed by one `all_reduce` through this module.
N-length vectors and O(1) scalars are replicated: after an all_reduce every
rank holds the same bits (NCCL's and gloo's ring algorithms hand each rank
the same result), so every branch taken on them goes the same way on every
rank.  A design with `shard=None` is one process, and every helper here is
then the identity: no collective, no copy, the arithmetic unchanged.

Bring-up (`init_from_env`, under VAMPOMI_DISTRIBUTED=1) reads the
environment of `torch.distributed.run`.  The backend follows one rule:
`--device cpu` → gloo; cuda with a card per local rank → nccl; cuda with
ranks sharing a card → gloo (NCCL refuses two ranks on one device; gloo
reduces CUDA tensors through the host).

    VAMPOMI_DISTRIBUTED=1 python -m torch.distributed.run --nproc-per-node P \\
        -m vampomi_tpu_torch.cli ...

Nothing here runs at import time.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


def divide_work(Mt: int, nranks: int) -> list[tuple[int, int]]:
    """Block-partition Mt markers over `nranks` workers: (local count, global
    start) per worker, the remainder going to the first Mt % nranks
    (reference src/utilities.cpp:207-239; vampomi_tpu/sharding.py:45-62)."""
    size = Mt // nranks
    modu = Mt % nranks
    out = []
    cum = 0
    for i in range(nranks):
        m = size + 1 if i < modu else size
        out.append((m, cum))
        cum += m
    return out


@dataclasses.dataclass(eq=False)
class Shard:
    """This rank's slab of the Mt markers, [lo, hi), and its process group.
    `counts` tallies the collectives this module ran for it, by kind."""

    rank: int
    world: int
    lo: int
    hi: int
    mt: int
    device: torch.device
    group: object = None  # None: the default process group
    counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(("all_reduce", "all_gather", "broadcast"), 0))

    @property
    def slabs(self) -> list[tuple[int, int]]:
        """(lo, hi) of every rank's slab."""
        return [(s, s + m) for m, s in divide_work(self.mt, self.world)]

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def collectives(self) -> int:
        return sum(self.counts.values())


def choose_backend(device_type: str, local_world: int, device_count: int) -> str:
    """gloo on the CPU; nccl when every local rank has a card of its own;
    gloo when ranks share a card (NCCL refuses two ranks on one device)."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if local_world <= device_count else "gloo"


def init_from_env(device: str) -> torch.device:
    """Start this rank's process group from torch.distributed.run's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR/PORT) and return its device: the CPU, or
    cuda:(LOCAL_RANK % device_count).  Must run before anything touches the
    device.  A failure raises: nothing retries under another backend or on
    the CPU."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    kind = torch.device(device).type
    if kind == "cpu":
        dev, count = torch.device("cpu"), 0
    else:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                f"rank {rank}: device {device!r} requested but no CUDA card is visible")
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    backend = choose_backend(kind, local_world, count)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    if rank == 0:
        print(f"torch.distributed: {world} rank(s), backend {backend} ({local_world} local "
              f"rank(s), {count} card(s) visible), rank 0 on {dev}", flush=True)
    return dev


def shard_for(mt: int, device: torch.device, group=None) -> Shard | None:
    """This rank's Shard of Mt markers in the initialized process group, or
    None when there is none (one process)."""
    if not dist.is_initialized():
        return None
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    m, lo = divide_work(mt, world)[rank]
    return Shard(rank=rank, world=world, lo=lo, hi=lo + m, mt=mt,
                 device=torch.device(device), group=group)


def is_writer() -> bool:
    """True on rank 0, or without a process group: the one process that
    writes the CSVs, the trace, checkpoints and the eigen cache, and
    narrates."""
    return not dist.is_initialized() or dist.get_rank() == 0


def span(mt: int, shard: Shard | None) -> tuple[int, int]:
    """This rank's markers [lo, hi) of Mt: [0, Mt) without a shard."""
    return (0, mt) if shard is None else (shard.lo, shard.hi)


def local_rows(vec, shard: Shard | None):
    """This rank's rows [lo, hi) of a global M-length array (the array
    itself without a shard)."""
    return vec if shard is None else vec[shard.lo:shard.hi]


def all_reduce_(t: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    """Sum `t` (a rank's partial sum over its markers) over the ranks, in
    place, and return it; the identity without a shard."""
    if shard is not None:
        dist.all_reduce(t, group=shard.group)
        shard.counts["all_reduce"] += 1
    return t


def all_reduce_many(parts: list[torch.Tensor], shard: Shard | None) -> list[torch.Tensor]:
    """Several partial sums of one dtype and device summed over the ranks in
    ONE all_reduce (packed flat, then cut apart); the tensors themselves
    without a shard."""
    if shard is None:
        return parts
    flat = all_reduce_(torch.cat([p.reshape(-1) for p in parts]), shard)
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    return out


def gather_m(vec: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    """The global (Mt, ...) array of every rank's slab, on the host.  Values
    are gathered, never summed (a sum of zero-padded buffers turns -0.0 into
    +0.0): each slab is padded to the longest, all-gathered —
    `all_gather_into_tensor` on the device under NCCL, `all_gather` of host
    tensors under gloo, which takes no CUDA tensors there — and the padding
    cut off.  A collective: every rank calls it, on its main thread."""
    vec = vec.detach()
    if shard is None:
        return vec.cpu()
    sizes = [hi - lo for lo, hi in shard.slabs]
    longest = max(sizes)
    nccl = shard.backend == "nccl"
    src = vec.to(shard.device) if nccl else vec.cpu()
    buf = src.new_zeros((longest,) + tuple(src.shape[1:]))
    buf[:src.shape[0]] = src
    if nccl:
        flat = src.new_empty((shard.world * longest,) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(flat, buf, group=shard.group)
        parts = list(flat.split(longest))
    else:
        parts = [torch.empty_like(buf) for _ in range(shard.world)]
        dist.all_gather(parts, buf, group=shard.group)
    shard.counts["all_gather"] += 1
    return torch.cat([p[:m] for p, m in zip(parts, sizes)]).cpu()


def broadcast_(t: torch.Tensor, shard: Shard | None) -> torch.Tensor:
    """Rank 0's `t` on every rank, in place (t on shard.device); the
    identity without a shard."""
    if shard is not None:
        dist.broadcast(t, src=0, group=shard.group)
        shard.counts["broadcast"] += 1
    return t


def broadcast_from0(values, shard: Shard | None) -> list[float]:
    """Rank 0's O(1) host values (floats or bools) on every rank, as f64
    floats: the decisions every rank must take alike (the eigen cache's hit
    or miss, auto's solver, a budget's verdict)."""
    if shard is None:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=shard.device)
    return broadcast_(t, shard).tolist()


def barrier(shard: Shard | None) -> None:
    """Wait until every rank got here (an all_reduce of one element, which
    every backend runs on the rank's device); nothing without a shard."""
    if shard is not None:
        all_reduce_(torch.zeros(1, device=shard.device), shard)
