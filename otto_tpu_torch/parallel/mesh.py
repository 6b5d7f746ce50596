"""Process meshes and the sharding helpers of the sharded paths.

Port of ``otto_tpu/parallel/mesh.py``.  JAX runs one controller over a
``Mesh`` of devices; PyTorch runs one process a device.  So a mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the initialized process
group, its dims named ``(data, model)``; a function that JAX runs through
``shard_map`` runs in every rank on that rank's block, and its collectives
run on ``mesh.get_group(axis)``.  The collectives used are ``all_reduce``
(SUM on float and int64 tensors, MAX), ``all_gather`` (the list form and
``all_gather_into_tensor``), ``reduce_scatter_tensor`` and ``broadcast``:
``gloo`` runs each of them on CPU and CUDA tensors (CUDA ones staged through
host memory) and NCCL on CUDA tensors, so the same code runs under both.

Rank ``r`` of a ``dp x mp`` mesh sits at ``(r // mp, r % mp)``, the layout
of ``np.asarray(devices).reshape(dp, mp)`` in the JAX package; a 3-D mesh
(:func:`make_mesh3d`) has dims ``(data, pipe, model)``.  A mesh may cover
the first ranks of the group only (``make_mesh(ranks=)``).  A layout is a
list of ``Shard``/``Replicate`` placements, one a mesh dim (:func:`sharded`);
:func:`take_block` and :func:`gather_block` cut a tensor into a rank's block
and join the blocks again.  A rank's
device is ``cuda:<LOCAL_RANK modulo the card count>`` on a CUDA mesh (ranks
beyond the card count share cards; two ranks on one card must use ``gloo``:
NCCL refuses them) and the CPU on a CPU mesh.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from otto_tpu_torch.config import MeshConfig

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(backend: str = "nccl", timeout_s: float = 300.0) -> bool:
    """Initialize the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  Without it, does nothing and returns False; with it,
    returns True or raises (a failed initialization is an error, never a
    quiet single-process run).  NCCL needs a card; ``gloo`` is taken only
    when named.  ``timeout_s`` bounds every collective, so a hung rank fails
    its peers."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in _ENV):
        return False
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: backend 'nccl' needs a CUDA card and "
                           "torch.cuda.is_available() is False; pass backend='gloo' "
                           "for CPU ranks")
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://",
                            timeout=timedelta(seconds=timeout_s))
    return True


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call init_distributed() "
                           "(or torch.distributed.init_process_group) first")
    return dist.get_world_size()


def _checked_device_type(device_type: str) -> str:
    """``device_type`` ("cuda", the default of the mesh builders, or "cpu"),
    raising for "cuda" without a card: a CPU mesh is taken only when asked
    for."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"make_mesh: device_type {device_type!r} is neither 'cuda' nor 'cpu'")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: a CUDA mesh was asked for but "
                           "torch.cuda.is_available() is False; pass device_type='cpu' "
                           "for CPU ranks")
    return device_type


def make_mesh(config: MeshConfig = MeshConfig(), device_type: str = "cuda",
              ranks: int | None = None) -> DeviceMesh:
    """A ``data x model`` mesh over every rank of the process group, or over
    its first ``ranks`` ranks (the JAX ``devices=`` argument: one launch of 8
    ranks serves a 4-device mesh); ``data_parallel=-1`` takes that count
    over ``model_parallel``.  Every rank of the group calls this (the mesh's
    groups are made by all of them); a rank outside the mesh gets a mesh in
    which :func:`in_mesh` is False and calls nothing on it.  A CUDA mesh
    without a card raises; CPU ranks pass ``device_type="cpu"``."""
    device_type = _checked_device_type(device_type)
    world = _world_size()
    n = world if ranks is None else ranks
    if not 0 < n <= world:
        raise ValueError(f"make_mesh: ranks={ranks} is not in 1..{world}")
    mp = max(config.model_parallel, 1)
    dp = config.data_parallel if config.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} does not match {n} devices")
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, mp),
                      mesh_dim_names=(config.data_axis, config.model_axis))


def make_mesh3d(data_parallel: int, pipeline_parallel: int, tensor_parallel: int,
                device_type: str = "cuda",
                axes: tuple[str, str, str] = ("data", "pipe", "model")) -> DeviceMesh:
    """A ``data x pipe x model`` mesh over the first ranks of the group
    (tensor parallelism innermost: neighbouring ranks); CUDA unless
    ``device_type="cpu"``.  Every rank of the group calls it, as
    :func:`make_mesh`."""
    device_type = _checked_device_type(device_type)
    n = data_parallel * pipeline_parallel * tensor_parallel
    have = _world_size()
    if n > have:
        raise ValueError(f"mesh {data_parallel}x{pipeline_parallel}x{tensor_parallel} "
                         f"needs {n} devices, have {have}")
    ranks = torch.arange(n).reshape(data_parallel, pipeline_parallel, tensor_parallel)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of ``mesh``'s."""
    return mesh.get_coordinate() is not None


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, local_rank() % torch.cuda.device_count())


def rank_device(mesh: DeviceMesh, device) -> torch.device:
    """The rank's device; raises if ``mesh`` is not a mesh or ``device``
    names another device."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (make_mesh), got {type(mesh).__name__}")
    own = mesh_device(mesh)
    if device is not None:
        asked = torch.device(device)
        if asked.type == "cuda" and asked.index is None and own.type == "cuda":
            asked = torch.device("cuda", torch.cuda.current_device())
        if asked != own:
            raise ValueError(f"device {str(asked)!r} is not this rank's device {str(own)!r} "
                             "on the mesh")
    return own


def replicated(mesh: DeviceMesh) -> list:
    """The layout of an array every rank holds whole (DTensor placements)."""
    return [Replicate()] * mesh.ndim


def _sharded_on(mesh: DeviceMesh, axis: str) -> list:
    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def sharded(mesh: DeviceMesh, dims: dict[str, int]) -> list:
    """The layout of a tensor whose dim ``dims[axis]`` splits in equal
    blocks over each named ``axis`` (for instance ``{"pipe": 0, "model": 3}``
    for a stacked pipeline stage's heads), replicated over the others."""
    unknown = set(dims) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"sharded: axes {sorted(unknown)} are not the mesh's "
                         f"{mesh.mesh_dim_names}")
    return [Shard(dims[name]) if name in dims else Replicate() for name in mesh.mesh_dim_names]


def row_sharded(mesh: DeviceMesh, axis: str = "model") -> list:
    """The layout of a table whose rows split in blocks over ``axis``."""
    return _sharded_on(mesh, axis)


def batch_sharded(mesh: DeviceMesh, axis: str = "data") -> list:
    """The layout of a batch whose leading dim splits over ``axis``."""
    return _sharded_on(mesh, axis)


def shard_rows(mesh: DeviceMesh, array, axis: str = "model"):
    """This rank's block of ``array``'s rows, padded with zero rows to a
    multiple of the ``axis`` size (callers keep the true row count),
    as a new tensor on the rank's device (the steps update it in place).
    Only the block is copied."""
    parts = axis_size(mesh, axis)
    n = array.shape[0]
    per = -(-n // parts)
    lo = axis_index(mesh, axis) * per
    dev = mesh_device(mesh)
    block = array[lo:min(lo + per, n)]
    t = (torch.tensor(np.asarray(block), device=dev) if isinstance(block, np.ndarray)
         else block.to(dev, copy=True))
    if t.shape[0] < per:
        t = torch.cat([t, t.new_zeros((per - t.shape[0], *t.shape[1:]))])
    return t.contiguous()


def _split_dims(mesh: DeviceMesh, placements) -> list[tuple[str, int]]:
    """(axis, tensor dim) of each ``Shard`` in a layout; one axis a dim."""
    out = [(name, pl.dim) for name, pl in zip(mesh.mesh_dim_names, placements)
           if isinstance(pl, Shard)]
    dims = [d for _, d in out]
    if len(set(dims)) != len(dims):
        raise ValueError(f"a tensor dim split over two mesh axes is not supported: "
                         f"{list(placements)}")
    return out


def take_block(mesh: DeviceMesh, whole, placements) -> torch.Tensor:
    """This rank's block of ``whole`` (numpy or a tensor) under a layout
    (:func:`sharded`), as a new contiguous tensor on the rank's device; each
    split dim must divide by its axis size."""
    t = torch.from_numpy(np.asarray(whole)) if not torch.is_tensor(whole) else whole
    for axis, dim in _split_dims(mesh, placements):
        parts = axis_size(mesh, axis)
        if t.shape[dim] % parts:
            raise ValueError(f"dim {dim} of a {tuple(t.shape)} tensor does not split over "
                             f"the {parts} ranks of {axis!r}")
        per = t.shape[dim] // parts
        t = t.narrow(dim, axis_index(mesh, axis) * per, per)
    return t.to(mesh_device(mesh), copy=True).contiguous()


def gather_block(mesh: DeviceMesh, block: torch.Tensor, placements) -> torch.Tensor:
    """The whole tensor from every rank's :func:`take_block` block (one
    ``all_gather`` an axis it is split over); every rank of the mesh calls
    it and gets the whole."""
    t = block.detach()
    for axis, dim in _split_dims(mesh, placements):
        t = torch.cat(all_gather(mesh, t.contiguous(), axis), dim=dim)
    return t


def host_shard_sessions(n_sessions: int, process_index: int | None = None,
                        process_count: int | None = None) -> np.ndarray:
    """The contiguous session range this process feeds."""
    ready = dist.is_initialized()
    pi = (dist.get_rank() if ready else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if ready else 1) if process_count is None else process_count
    per = -(-n_sessions // pc)
    lo = pi * per
    hi = min(lo + per, n_sessions)
    return np.arange(lo, hi)


# ---------------------------------------------------------------------------
# collectives over one mesh axis
# ---------------------------------------------------------------------------


def all_reduce_sum(mesh: DeviceMesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """``psum``: ``x`` summed over ``axis``, in place."""
    if axis_size(mesh, axis) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return x


def all_reduce_max(mesh: DeviceMesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """``pmax``: the elementwise largest ``x`` over ``axis``, in place."""
    if axis_size(mesh, axis) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return x


def all_reduce_mean(mesh: DeviceMesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """``pmean``: ``x`` summed over ``axis``, then divided by its size, in
    place (a float tensor; at size 1 ``x`` is returned untouched)."""
    n = axis_size(mesh, axis)
    if n > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
        x.div_(n)
    return x


def reduce_scatter_mean(mesh: DeviceMesh, flat: torch.Tensor, axis: str) -> torch.Tensor:
    """``psum_scatter / n``: of a flat tensor of ``n * per`` entries (``n``
    the size of ``axis``), this rank's ``per`` entries of the sum over
    ``axis``, divided by ``n``.  One ``reduce_scatter_tensor``: each rank
    sends and receives (n - 1) / n of ``flat``'s bytes in a ring, half of an
    all-reduce."""
    n = axis_size(mesh, axis)
    if flat.ndim != 1 or flat.shape[0] % n:
        raise ValueError(f"reduce_scatter_mean: a flat tensor of a multiple of {n} entries "
                         f"expected, got {tuple(flat.shape)}")
    if n == 1:
        return flat.clone()
    out = flat.new_empty(flat.shape[0] // n)
    dist.reduce_scatter_tensor(out, flat.contiguous(), op=dist.ReduceOp.SUM,
                               group=mesh.get_group(axis))
    return out.div_(n)


def all_gather_flat(mesh: DeviceMesh, shard: torch.Tensor, axis: str) -> torch.Tensor:
    """Every rank's flat ``shard`` (equal sizes) along ``axis``, joined in
    axis order into one flat tensor (``all_gather(tiled=True)``; one
    ``all_gather_into_tensor``)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return shard.reshape(-1).clone()
    out = shard.new_empty(n * shard.numel())
    dist.all_gather_into_tensor(out, shard.reshape(-1).contiguous(), group=mesh.get_group(axis))
    return out


def all_gather(mesh: DeviceMesh, x: torch.Tensor, axis: str) -> list[torch.Tensor]:
    """Every rank's ``x`` along ``axis`` (equal shapes), in axis order."""
    if axis_size(mesh, axis) == 1:
        return [x]
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(out, x, group=mesh.get_group(axis))
    return out


def all_gather_rows(mesh: DeviceMesh, x: torch.Tensor, axis: str) -> list[torch.Tensor]:
    """Every rank's ``x`` along ``axis`` whose leading dims differ: the
    sizes go first, then the blocks padded to the largest."""
    if axis_size(mesh, axis) == 1:
        return [x]
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    sizes = [int(s) for s in torch.cat(all_gather(mesh, n, axis)).tolist()]
    pad = max(sizes) - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
    return [g[:s] for g, s in zip(all_gather(mesh, x, axis), sizes)]


def data_slice(mesh: DeviceMesh, n: int, axis: str = "data") -> tuple[slice, int]:
    """This rank's rows of an ``n``-row batch split over ``axis`` (the batch
    padded to a multiple of the axis size), and the padded size."""
    parts = axis_size(mesh, axis)
    per = -(-n // parts)
    lo = axis_index(mesh, axis) * per
    return slice(lo, lo + per), per * parts


def data_block(mesh: DeviceMesh, a, axis: str = "data") -> torch.Tensor:
    """This rank's block of a batch split over ``axis``, on the rank's
    device.  ``a`` is a ``DTensor`` sharded over ``axis`` (what
    ``BatchLoader(mesh=)`` yields: its local block is taken as it is), or the
    whole batch (numpy or a tensor, the same on every rank), whose rows must
    divide by the axis size (as under ``shard_map``: anything else raises)."""
    from torch.distributed.tensor import DTensor

    if isinstance(a, DTensor):
        if a.device_mesh != mesh or a.placements != tuple(batch_sharded(mesh, axis)):
            raise ValueError(f"data_block: a DTensor sharded over {axis!r} of this mesh "
                             f"expected, got placements {a.placements}")
        return a.to_local()
    n, parts = a.shape[0], axis_size(mesh, axis)
    if n % parts:
        raise ValueError(f"data_block: a batch of {n} rows does not split over the {parts} "
                         f"ranks of {axis!r}")
    sl, _ = data_slice(mesh, n, axis)
    block = a[sl]
    dev = mesh_device(mesh)
    if isinstance(block, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(block)).to(dev)
    return block.to(dev)


def pad_rows_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with its first row repeated up to ``n`` rows (padding sessions
    that are scored and dropped)."""
    if x.shape[0] >= n:
        return x
    return torch.cat([x, x[:1].expand(n - x.shape[0], *x.shape[1:])])


def gather_batch(mesh: DeviceMesh, x: torch.Tensor, n: int, axis: str = "data") -> torch.Tensor:
    """The slices of :func:`data_slice` gathered over ``axis``, padding
    dropped: the whole ``n``-row result on every rank."""
    return torch.cat(all_gather(mesh, x, axis))[:n]


# ---------------------------------------------------------------------------
# local launches
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(argv: list[str], world: int, timeout_s: float = 120.0,
                 env: dict | None = None, cwd=None) -> list[str]:
    """Run ``argv`` as ``world`` ranks on this host with torchrun's
    environment (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
    127.0.0.1, a free ``MASTER_PORT``) and wait for all of them.  Returns
    each rank's standard output.  A rank that exits non-zero, or a launch
    that outlives ``timeout_s``, kills the others and raises with the
    ranks' standard error."""
    import subprocess
    import tempfile
    import time

    base = {**os.environ, **(env or {}), "WORLD_SIZE": str(world),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(2 * world)]
    procs = [subprocess.Popen(argv, env={**base, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=logs[2 * r], stderr=logs[2 * r + 1], text=True, cwd=cwd)
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}" if bad else \
                    f"timed out after {timeout_s:.0f} s"
                break
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
        if failed is None and bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    if failed is not None:
        errs = "\n".join(f"--- rank {r} stderr ---\n{outs[2 * r + 1][-4000:]}"
                         for r in range(world))
        raise RuntimeError(f"launch_local {argv}: {failed}\n{errs}")
    return outs[0::2]
