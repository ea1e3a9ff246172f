"""Process groups and device meshes (counterpart of
audio_style_transfer_tpu/parallel/mesh.py).

The two runtimes differ. JAX runs one controller that sees every device: a
``Mesh`` names them, and ``shard_map`` splits an array over them and runs one
program per device. torch.distributed runs one process per device (a rank),
each with its own copy of the program, joined by a process group. The port's
mesh is PyTorch's own ``torch.distributed.device_mesh.DeviceMesh``, whose
``mesh_dim_names`` take the place of JAX's ``axis_names``; a rank reads its
place with ``mesh.get_local_rank(axis)`` and its group with
``mesh.get_group(axis)``.

Backends: NCCL between CUDA ranks, one card per rank; gloo between CPU
processes. gloo also carries CUDA tensors (broadcast and all-reduce only), so
several ranks can share one card over gloo: the two-rank checks on a machine
with one GPU run that way. NCCL refuses two ranks on one card.

``spawn`` starts N local workers that form one group through a ``file://``
store (no TCP port to collide), each group with a timeout and the whole run
with a deadline after which the workers are terminated: a hung collective
becomes an error, never a stuck run.

The differentiable collectives of the sharded paths (parallel/halo.py,
parallel/tensor.py) are here too: ``neighbour_exchange`` (JAX's
``ppermute`` to both neighbours), ``psum`` (an all-reduce whose backward is
the identity: the loss it feeds is replicated, so every rank's cotangent is
already the whole one), ``copy_to_ranks`` (its mirror: identity forward,
all-reduce backward) and ``take_shard`` (a rank's slice of a replicated
tensor, whose backward all-gathers the slices).
"""

from __future__ import annotations

import datetime
import functools
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# A collective that waits longer than this fails instead of hanging.
GROUP_TIMEOUT_S = 300.0
LAUNCHER_VARS = ("RANK", "WORLD_SIZE")


def _set_rank_device(device: str, backend: str, local_rank: int) -> None:
    """Point the rank's current CUDA device at its card: LOCAL_RANK's, or,
    when gloo shares fewer cards among more ranks, LOCAL_RANK modulo the
    count (0 on one card)."""
    if device != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda'): CUDA is not available")
    count = torch.cuda.device_count()
    if local_rank >= count and backend != "gloo":
        raise RuntimeError(
            f"rank {local_rank} has no card of its own ({count} visible): NCCL needs one "
            "card per rank; pass backend='gloo' to share cards")
    torch.cuda.set_device(local_rank % count)


def _default_backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


def _init_world(device: str, backend: str | None) -> None:
    """Form the default process group unless one exists: from a launcher's
    environment (torchrun: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT), else a world of this process alone."""
    if dist.is_initialized():
        return
    backend = backend or _default_backend(device)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if all(v in os.environ for v in LAUNCHER_VARS):
        _set_rank_device(device, backend, int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        _set_rank_device(device, backend, 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)


def make_mesh(n_devices: int | None = None, axis_name: str = "data", device: str = "cuda",
              backend: str | None = None) -> DeviceMesh:
    """A 1-D mesh named ``axis_name`` over every rank of the world.

    Forms the default process group if none exists (see ``_init_world``):
    NCCL for ``cuda``, gloo for ``cpu``; ``backend="gloo"`` on ``cuda`` only
    when asked for. Each rank's current CUDA device is set to its card.
    ``n_devices`` (default: the world size) must equal the world size: a rank
    outside the mesh would have nothing to do.
    """
    _init_world(device, backend)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"make_mesh({n_devices}): the world has {world} rank(s); start {n_devices} "
            "processes (torchrun --nproc_per_node, or parallel.mesh.spawn)")
    return init_device_mesh(device, (world,), mesh_dim_names=(axis_name,))


def rank_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``: its current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def replicate(mesh: DeviceMesh, tensors, axis_name: str = "data") -> None:
    """Overwrite ``tensors`` on every rank of the axis with the axis' first
    rank's (a broadcast, in place): JAX's replicated spec ``P()``."""
    group = mesh.get_group(axis_name)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src, group=group)


def shard_rows(mesh: DeviceMesh, batch, axis_name: str = "data", dim: int = 0):
    """The rank's contiguous block of ``batch`` along ``dim`` (numpy or
    tensor): rows ``[r * b / n, (r + 1) * b / n)``, as JAX's ``P(axis)`` cuts
    a global batch."""
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    b = batch.shape[dim]
    if b % n:
        raise ValueError(f"a batch of {b} does not split over the {n} ranks of {axis_name!r}")
    per = b // n
    lo = mesh.get_local_rank(axis_name) * per
    return batch[(slice(None),) * dim + (slice(lo, lo + per),)]


def data_parallel_specs(axis_name: str = "data"):
    """(replicate, shard) for data-parallel training, JAX's ``(P(), P(axis))``
    as functions: ``replicate(mesh, tensors)`` broadcasts from the axis' first
    rank, ``shard(mesh, batch, dim=0)`` takes the rank's row block."""
    return (functools.partial(replicate, axis_name=axis_name),
            functools.partial(shard_rows, axis_name=axis_name))


def gather_rows(mesh: DeviceMesh, local: np.ndarray, axis_name: str | None = None) -> np.ndarray:
    """Every rank's block of rows, concatenated in rank order, on every rank
    (JAX's ``out_specs=P(axis)`` read back to the host). The blocks must have
    the same shape."""
    axis_name = axis_name or mesh.mesh_dim_names[0]
    group = mesh.get_group(axis_name)
    t = torch.from_numpy(np.ascontiguousarray(local))
    if dist.get_backend(group) == "nccl":
        t = t.to(rank_device(mesh))
    return all_gather_along(t, 0, group).cpu().numpy()


def _is_gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_gather_along(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks), concatenated along ``dim``
    in rank order, on ``t``'s device. NCCL gathers on the card; gloo on host
    tensors, because it gathers no CUDA tensor."""
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    if _is_gloo(group):
        host = src.cpu()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        out = torch.cat(parts).to(t.device)
    else:
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _exchange(group, to_prev, to_next):
    """(from_prev, from_next): send ``to_prev`` to rank - 1 and ``to_next`` to
    rank + 1 of ``group`` and receive what those neighbours send this way, as
    one ``batch_isend_irecv`` (both sends and both receives posted at once,
    so no pair of ranks can deadlock). Either may be None: nothing moves that
    way on any rank, and None comes back from the other side. A neighbour
    past the group's ends sends zeros; at world size 1 nothing is sent.
    gloo moves host copies of CUDA tensors."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    dev = (to_prev if to_prev is not None else to_next).device
    staged = _is_gloo(group) and dev.type != "cpu"

    def out(t):
        return None if t is None else t.to("cpu") if staged else t.contiguous()

    send_prev, send_next = out(to_prev), out(to_next)
    from_prev = None if to_next is None else torch.zeros_like(send_next)
    from_next = None if to_prev is None else torch.zeros_like(send_prev)
    ops = []
    for neighbour, send, recv in ((rank - 1, send_prev, from_prev),
                                  (rank + 1, send_next, from_next)):
        if 0 <= neighbour < n:
            peer = dist.get_global_rank(group, neighbour)
            ops += [dist.P2POp(op, t, peer, group)
                    for op, t in ((dist.isend, send), (dist.irecv, recv)) if t is not None]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        from_prev, from_next = (None if t is None else t.to(dev) for t in (from_prev, from_next))
    return from_prev, from_next


class _NeighbourExchange(torch.autograd.Function):
    """``_exchange`` with its transpose as the backward: the cotangent of
    what came from rank - 1 goes back to rank - 1, where it is the gradient
    of what that rank sent, and so for rank + 1."""

    @staticmethod
    def forward(ctx, group, to_prev, to_next):
        ctx.group = group
        return _exchange(group, to_prev, to_next)

    @staticmethod
    def backward(ctx, g_from_prev, g_from_next):
        g_prev, g_next = _exchange(ctx.group, g_from_prev, g_from_next)
        return None, g_prev, g_next


def neighbour_exchange(group, to_prev: torch.Tensor | None, to_next: torch.Tensor | None):
    """(from_prev, from_next), differentiable: ``to_prev`` goes to rank - 1
    and ``to_next`` to rank + 1 of ``group``; the first rank receives zeros
    from before it and the last zeros from after it (the clip's SAME
    padding). Either argument may be None (then nothing moves that way).
    Every rank of ``group`` must call it with the same shapes."""
    return _NeighbourExchange.apply(group, to_prev, to_next)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)  # NCCL reduces contiguous tensors
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (JAX's ``psum``), with the
    identity as its backward. Right where what it feeds is replicated: every
    rank then backpropagates the same loss, and the cotangent each receives
    is already the whole dL/dsum. ``torch.distributed.nn.functional
    .all_reduce`` all-reduces the cotangent as well, which would count it n
    times."""
    return _Psum.apply(x, group)


class _CopyToRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (replicated) as it enters rank-local work: the identity, whose
    backward sums the ranks' partial cotangents (Megatron's f; ``psum`` is
    its g)."""
    return _CopyToRanks.apply(x, group)


class _TakeShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, full, dim, group):
        n = dist.get_world_size(group)
        size = full.shape[dim] // n
        ctx.dim, ctx.group = dim, group
        return full.narrow(dim, dist.get_rank(group) * size, size).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather_along(g, ctx.dim, ctx.group), None, None


def take_shard(full: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous 1/n of a replicated tensor along ``dim``. Its
    backward all-gathers the ranks' cotangents, so the replicated tensor
    gets its whole gradient on every rank. ``full.shape[dim]`` must split
    over the ranks."""
    return _TakeShard.apply(full, dim, group)


def make_hybrid_mesh(ici_axis: str = "data", dcn_axis: str = "slice",
                     dcn_size: int | None = None, device: str = "cuda",
                     backend: str | None = None) -> DeviceMesh:
    """2-D mesh (nodes, ranks per node) named ``(dcn_axis, ici_axis)``: the
    fast axis within a node (NVLink), the slow one across nodes. ``dcn_size``
    defaults to the node count, WORLD_SIZE / LOCAL_WORLD_SIZE as torchrun
    sets them; with one node the mesh is 1 x world, as JAX's is with one
    slice."""
    _init_world(device, backend)
    world = dist.get_world_size()
    if dcn_size is None:
        dcn_size = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if dcn_size < 1 or world % dcn_size:
        raise ValueError(f"{dcn_size} nodes do not divide a world of {world} ranks")
    return init_device_mesh(device, (dcn_size, world // dcn_size),
                            mesh_dim_names=(dcn_axis, ici_axis))


def _spawned(rank: int, fn, nprocs: int, store: str, device: str, backend: str,
             timeout_s: float, args: tuple) -> None:
    """A worker of ``spawn``: join the group, run ``fn(rank, *args)``, leave."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_WORLD_SIZE=str(nprocs))
    _set_rank_device(device, backend, rank)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=nprocs,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = (), device: str = "cpu", backend: str | None = None,
          timeout_s: float = GROUP_TIMEOUT_S, deadline_s: float | None = None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes (the spawn start
    method) that form the default process group: NCCL on ``cuda`` unless
    ``backend`` says otherwise, gloo on ``cpu``. ``fn`` must be importable by
    name (a module-level function). A collective that waits ``timeout_s``
    raises. A worker that raises fails the call, and the others are
    terminated; so are all of them, with TimeoutError, once ``deadline_s``
    has passed (None: no deadline)."""
    import torch.multiprocessing as mp

    backend = backend or _default_backend(device)
    deadline = None if deadline_s is None else time.monotonic() + deadline_s
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _spawned, args=(fn, nprocs, os.path.join(tmp, "store"), device, backend,
                            timeout_s, tuple(args)),
            nprocs=nprocs, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: {nprocs} workers still running after "
                                       f"{deadline_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
