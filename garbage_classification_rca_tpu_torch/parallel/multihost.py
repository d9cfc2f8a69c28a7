"""Multi-process runs: the port of the JAX package's
``parallel/multihost.py`` to ``torch.distributed``, one process per GPU.

  * ``initialize_from_env()`` forms the process group from torchrun's
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` or from
    the JAX package's ``GC_RCA_MULTIHOST=1`` with ``GC_RCA_COORDINATOR`` /
    ``GC_RCA_PROCESS_ID`` / ``GC_RCA_NUM_PROCESSES``, and returns the
    rank's ``DataMesh``; a plain one-process run forms no group. Each rank
    takes ``cuda:LOCAL_RANK``; the backend is NCCL on the card and gloo
    on the CPU. ``GC_RCA_DIST_BACKEND`` names another (two ranks sharing
    one card need gloo); ``GC_RCA_INIT_METHOD`` another rendezvous (the
    ``file://`` one ``launch`` gives its ranks); ``GC_RCA_DIST_TIMEOUT``
    the seconds after which a collective that waits on a dead peer fails.
    Each rank of a train run decodes only its rows of the seed's global
    batch plan (``train/engine.stacked_batches(rows=mesh.local_rows(b))``),
    so the global microbatch stacks are those of the one-process stream,
    tail padding and the trailing-window repeat included.
  * ``run_eval_multiprocess``: each rank evaluates its rows; predictions
    are gathered in the one-process order, so accuracy, labels,
    predictions and the report CSV equal a one-process run.
  * ``make_mesh``: the named axes of ``--mesh_shape`` laid over the
    ranks, with the process group of each axis (every rank calls
    ``dist.new_group`` for every group, in the same order).
  * ``all_reduce_sum_`` / ``gather_rows`` / ``all_gather_dim`` /
    ``broadcast_`` / ``agree`` / ``barrier``: the collectives the train
    step, BatchNorm, tensor and sequence parallelism, the server and the
    engine use, each over a group (the world, or one axis of the mesh).
    gloo takes CUDA tensors only in broadcast and all-reduce, so under
    gloo a CUDA tensor goes through host memory and an all-gather is an
    all-reduce of a zero buffer that holds the rank's block; NCCL gathers
    with ``all_gather_into_tensor``.
  * ``ring_step`` / ``wait_all``: the point-to-point step of a ring over
    one axis (a pipeline's stages): a tensor to the member `shift` places
    on and one from the member `shift` places back, posted together
    (``batch_isend_irecv``: NCCL runs a pair's sends and receives in
    order, so two stages that send each other first would wait on each
    other), host-staged under gloo, which sends CPU tensors only;
    ``broadcast_from_`` sends one member's tensor (the last stage's) to
    its group, ``gather_objects`` every member's picklable object (a
    stage's adapters and optimizer state, for the checkpoints).
  * ``launch``: spawns N ranks of a command on this host with a
    ``file://`` rendezvous in a temporary directory (the tests, and
    ``chip_smoke.py``'s two ranks on one card); any rank's failure kills
    the others.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import DATA_AXIS, DataMesh

ENV_BACKEND = "GC_RCA_DIST_BACKEND"
ENV_INIT = "GC_RCA_INIT_METHOD"
ENV_TIMEOUT = "GC_RCA_DIST_TIMEOUT"
DEFAULT_TIMEOUT_S = 600

_MESH: Optional[DataMesh] = None
_MESHES: Dict[Tuple[Tuple[str, int], ...], DataMesh] = {}
_RENDEZVOUS_DIR: Optional[str] = None


def _env_world() -> Optional[Tuple[int, int, int, str]]:
    """(rank, world, local rank, init method) from the environment, or
    None for a plain one-process run."""
    env = os.environ
    if env.get("GC_RCA_MULTIHOST", "") in ("1", "true"):
        missing = [k for k in ("GC_RCA_COORDINATOR", "GC_RCA_PROCESS_ID",
                               "GC_RCA_NUM_PROCESSES") if not env.get(k)]
        if missing:
            raise SystemExit(f"GC_RCA_MULTIHOST=1 needs {', '.join(missing)}"
                             " (the port has no cluster auto-detection)")
        return (int(env["GC_RCA_PROCESS_ID"]),
                int(env["GC_RCA_NUM_PROCESSES"]),
                int(env.get("LOCAL_RANK", "0")),
                "tcp://" + env["GC_RCA_COORDINATOR"])
    if "RANK" in env and "WORLD_SIZE" in env:
        return (int(env["RANK"]), int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", "0")), "env://")
    return None


def env_world_size() -> int:
    """The world size the environment describes (1 for a plain run)."""
    world = _env_world()
    return 1 if world is None else world[1]


def initialize_from_env(device_type: str = "cuda", *,
                        force_group: bool = False) -> DataMesh:
    """This rank's ``DataMesh``, forming the process group on the first
    call when the environment describes one (or, with `force_group`, a
    group of one process: ``--fsdp`` needs one). Raises without CUDA when
    `device_type` is "cuda", as ``device.resolve_device`` does."""
    global _MESH, _RENDEZVOUS_DIR
    import torch.distributed as dist

    from ..device import resolve_device

    base = resolve_device(device_type)
    if _MESH is not None and dist.is_initialized():
        return _MESH
    world = _env_world()
    if world is None and not force_group:
        return DataMesh(0, 1, base, None)
    if world is None:
        _RENDEZVOUS_DIR = tempfile.mkdtemp(prefix="gc_rca_rdv_")
        world = (0, 1, 0, "file://" + os.path.join(_RENDEZVOUS_DIR, "rdv"))
    rank, size, local, init = world
    init = os.environ.get(ENV_INIT) or init
    if base.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    else:
        device = base
    backend = os.environ.get(ENV_BACKEND) or (
        "nccl" if device.type == "cuda" else "gloo")
    timeout = float(os.environ.get(ENV_TIMEOUT, DEFAULT_TIMEOUT_S))
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=timeout))
        atexit.register(shutdown)
    _MESH = DataMesh(rank, size, device, backend)
    if rank == 0:
        print(f"process group: {size} rank(s), backend {backend}, rank 0 "
              f"on {device}", flush=True)
    return _MESH


def shutdown() -> None:
    """Destroy the process group (a peer waiting in a collective then
    fails instead of waiting out its timeout)."""
    global _MESH, _RENDEZVOUS_DIR
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _MESH = None
    _MESHES.clear()
    if _RENDEZVOUS_DIR is not None:
        shutil.rmtree(_RENDEZVOUS_DIR, ignore_errors=True)
        _RENDEZVOUS_DIR = None


def is_primary() -> bool:
    """True on the rank that owns side effects (checkpoints, reports,
    logs, prints); always true in a one-process run."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(base: DataMesh, axes: Dict[str, int]) -> DataMesh:
    """`base` (``initialize_from_env``'s view of the world) with the named
    `axes` (name -> size, spec order, sizes multiplying to the world) and
    the process group of each axis of more than one rank and fewer than
    the world: the ranks that differ from this one only along the axis,
    in JAX's row-major device order. Every rank must call it with the
    same axes: ``dist.new_group`` is collective. Meshes are kept by their
    axes, so a second call forms no new groups."""
    import torch.distributed as dist

    sizes = [int(n) for n in axes.values()]
    if int(np.prod(sizes)) != base.world:
        raise ValueError(f"mesh axes {axes} do not make the world of "
                         f"{base.world} ranks")
    key = tuple((name, int(n)) for name, n in axes.items())
    if key in _MESHES and _MESHES[key].rank == base.rank:
        return _MESHES[key]
    groups = {}
    if base.world > 1:
        ranks = np.arange(base.world).reshape(sizes)
        for i, (name, n) in enumerate(key):
            if n in (1, base.world):
                continue
            for row in np.moveaxis(ranks, i, -1).reshape(-1, n).tolist():
                g = dist.new_group(row)
                if base.rank in row:
                    groups[name] = g
    mesh = dataclasses.replace(base, axes=key, groups=groups)
    _MESHES[key] = mesh
    return mesh


def _via_host(group=None) -> bool:
    import torch.distributed as dist

    return dist.get_backend(group) == "gloo"


def _all_reduce(flat: torch.Tensor, group=None) -> None:
    import torch.distributed as dist

    if flat.is_cuda and _via_host(group):
        host = flat.cpu()
        dist.all_reduce(host, group=group)
        flat.copy_(host)
    else:
        dist.all_reduce(flat, group=group)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor over the ranks of `group` (None: the world), in
    place: one collective for each dtype, the tensors flattened into one
    buffer."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        _all_reduce(flat, group)
        off = 0
        for t in same:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def _axis(mesh: DataMesh, axis: Optional[str]):
    """(size, this rank's index, group) of `axis`; None is the world."""
    if axis is None:
        return mesh.world, mesh.rank, None
    return mesh.size(axis), mesh.coord(axis), mesh.group(axis)


def _stack(x: torch.Tensor, mesh: DataMesh, axis: Optional[str]
           ) -> torch.Tensor:
    """[n, ...]: every rank's `x` along `axis`, in axis order."""
    import torch.distributed as dist

    n, i, group = _axis(mesh, axis)
    if n == 1:
        return x[None].clone()
    x = x.contiguous()
    if _via_host(group):
        buf = x.new_zeros((n,) + tuple(x.shape))
        buf[i] = x
        _all_reduce(buf, group)
        return buf
    buf = x.new_empty((n,) + tuple(x.shape))
    dist.all_gather_into_tensor(buf, x, group=group)
    return buf


def gather_rows(x: torch.Tensor, mesh: DataMesh,
                axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """[n * r, ...]: every rank's `x` [r, ...] along `axis` (None: the
    world), stacked in axis order (an all-gather; every rank must pass
    the same shape)."""
    every = _stack(x, mesh, axis)
    return every.reshape((every.shape[0] * x.shape[0],)
                         + tuple(x.shape[1:]))


def all_gather_dim(x: torch.Tensor, dim: int, mesh: DataMesh,
                   axis: str) -> torch.Tensor:
    """Every rank's `x` along `axis` concatenated on `dim` in axis order
    (JAX's ``all_gather(..., tiled=True)``)."""
    every = _stack(x, mesh, axis)
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= every.shape[0]
    return every.movedim(0, dim).reshape(shape)


def broadcast_(t: torch.Tensor, group=None, src: int = 0) -> torch.Tensor:
    """`t` from global rank `src` to every rank of `group` (None: the
    world), in place."""
    import torch.distributed as dist

    if t.is_cuda and _via_host(group):
        host = t.cpu()
        dist.broadcast(host, src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src, group=group)
    return t


def broadcast_from_(t: torch.Tensor, mesh: DataMesh, axis: str,
                    index: int = -1) -> torch.Tensor:
    """`t` from the member at `index` along `axis` (-1: the last) to
    every rank of the axis's group, in place."""
    if mesh.size(axis) > 1:
        broadcast_(t, group=mesh.group(axis), src=mesh.peer(axis, index))
    return t


def gather_objects(obj, mesh: DataMesh, axis: str) -> list:
    """Every member's `obj` along `axis`, in axis order (pickled: CPU
    tensors, dicts)."""
    import torch.distributed as dist

    if mesh.size(axis) == 1:
        return [obj]
    out = [None] * mesh.size(axis)
    dist.all_gather_object(out, obj, group=mesh.group(axis))
    return out


def ring_step(mesh: DataMesh, axis: str, send: Optional[torch.Tensor] = None,
              recv_like=None, *, shift: int = 1,
              pending: Optional[list] = None) -> Optional[torch.Tensor]:
    """One step of the ring along `axis`: `send` to the member `shift`
    places on, and a tensor shaped like `recv_like` (a tensor, or (shape,
    dtype, device)) from the member `shift` places back, the two posted
    in one ``batch_isend_irecv``. Each pair of ranks must post its sends
    and receives in the same order on both (NCCL runs a pair's ops in
    order), and a send and a receive that cross (a ring of two) go in one
    step. Under gloo a CUDA tensor is
    staged through host memory both ways. Waits for the receive; a step
    that only sends leaves its send in flight in `pending` (the work and
    its buffer: ``wait_all``) when a list is given. On an axis of one
    rank the tensor sent is the one received. Returns the received
    tensor on `recv_like`'s device, or None."""
    import torch.distributed as dist

    if recv_like is not None and not isinstance(recv_like, torch.Tensor):
        shape, dtype, device = recv_like
    elif recv_like is not None:
        shape, dtype, device = recv_like.shape, recv_like.dtype, \
            recv_like.device
    n, i, group = _axis(mesh, axis)
    if n == 1:
        return None if recv_like is None else send.detach().clone()
    host = _via_host(group)
    ops, keep, buf = [], [], None
    if send is not None:
        t = send.detach().contiguous()
        t = t.cpu() if host and t.is_cuda else t
        keep.append(t)
        ops.append(dist.P2POp(dist.isend, t, mesh.peer(axis, i + shift),
                              group))
    if recv_like is not None:
        buf = torch.empty(tuple(shape), dtype=dtype,
                          device="cpu" if host else device)
        ops.append(dist.P2POp(dist.irecv, buf, mesh.peer(axis, i - shift),
                              group))
    if not ops:
        return None
    works = dist.batch_isend_irecv(ops)
    if buf is None and pending is not None:
        pending.append((works, keep))
        return None
    for w in works:
        w.wait()
    return None if buf is None else buf.to(device)


def wait_all(pending: list) -> None:
    """Wait for the sends ``ring_step`` left in flight, then forget
    them."""
    for works, _ in pending:
        for w in works:
            w.wait()
    pending.clear()


def barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        if _MESH is not None and _MESH.device.type == "cuda" \
                and not _via_host():
            dist.barrier(device_ids=[_MESH.device.index])
        else:
            dist.barrier()


def agree(values: Sequence[int], what: str, mesh: DataMesh) -> None:
    """Fail fast, on every rank, when the ranks disagree on `values` (e.g.
    the resume point: a RESUME file seen by some ranks and not others
    would train them on different plans and hang the last collective)."""
    if not mesh.distributed:
        return
    mine = torch.tensor(list(values), dtype=torch.int64, device=mesh.device)
    every = gather_rows(mine[None], mesh, axis=None).tolist()
    if any(v != every[0] for v in every):
        raise SystemExit(
            f"multi-process {what} mismatch: per-rank values {every}; "
            "every rank must see the same RESUME file (a shared "
            "filesystem, or a copy of rank 0's on every host) or none")


def run_eval_multiprocess(step, batcher, batch_size: int, mesh: DataMesh,
                          keys=("image", "label", "valid"),
                          progress: bool = True, prefetch_depth: int = 2
                          ) -> Tuple[float, np.ndarray, np.ndarray, Dict]:
    """The multi-process twin of ``eval/harness.run_eval``: global batch s
    holds samples [s * B, min((s + 1) * B, n)) in manifest order, each
    rank decodes and evaluates its rows, and one collective a batch
    gathers the predictions and the correct counts. Returns (acc %,
    labels, preds, stats) equal to a one-process run's on every rank."""
    from ..data.pipeline import to_device

    n_total = len(batcher.m)
    rows = mesh.local_rows(batch_size)
    n_steps = (n_total + batch_size - 1) // batch_size
    keep = set(keys)
    host = ({k: v for k, v in b.items() if k in keep}
            for b in batcher.iter_batches(batch_size, shuffle=False,
                                          rows=rows))
    all_preds, correct = [], 0
    t0 = time.perf_counter()
    for s, batch in enumerate(to_device(host, mesh.device,
                                        depth=prefetch_depth)):
        with torch.inference_mode():
            preds, c = step(batch)
        mine = torch.cat([preds.reshape(-1).to(torch.int64),
                          c.reshape(1).to(torch.int64)])
        every = gather_rows(mine[None], mesh)
        n_valid = min(batch_size, n_total - s * batch_size)
        all_preds.append(every[:, :-1].reshape(-1)[:n_valid].cpu().numpy()
                         .astype(np.int32))
        correct += int(every[:, -1].sum())
        if progress and mesh.is_primary:
            print(f"Test batches {s}/{n_steps} ", end="\r")
    wall = time.perf_counter() - t0
    labels = np.asarray([smp.label for smp in batcher.m.samples], np.int32)
    stats = {"wall_s": wall,
             "pipeline_samples_per_s": n_total / wall if wall > 0 else 0.0,
             "samples_per_s": n_total / wall if wall > 0 else 0.0,
             "p50_step_s": 0.0, "p50_includes_host_readback": True,
             "n": n_total}
    return (100.0 * correct / n_total, labels, np.concatenate(all_preds),
            stats)


def launch(cmd: Sequence[str], nproc: int, *, backend: Optional[str] = None,
           share_device: bool = False, timeout: float = 600.0,
           env: Optional[Dict[str, str]] = None,
           cwd: Optional[str] = None) -> List[Tuple[int, str]]:
    """Run ``python <cmd>`` as `nproc` ranks on this host, each with
    torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` and a ``file://``
    rendezvous in a temporary directory; returns [(exit code, output)] by
    rank. `backend` is passed on as ``GC_RCA_DIST_BACKEND`` (gloo for two
    ranks on one card), `share_device` gives every rank local rank 0 (card
    0). When a rank fails, or `timeout` seconds pass, the others are
    killed (their code is then negative)."""
    rdv = tempfile.mkdtemp(prefix="gc_rca_rdv_")
    base = dict(os.environ if env is None else env)
    base.update(WORLD_SIZE=str(nproc), LOCAL_WORLD_SIZE=str(nproc))
    base[ENV_INIT] = "file://" + os.path.join(rdv, "rdv")
    base[ENV_TIMEOUT] = str(int(timeout))
    if backend:
        base[ENV_BACKEND] = backend
    procs, logs = [], []
    for r in range(nproc):
        e = dict(base, RANK=str(r), LOCAL_RANK="0" if share_device else str(r))
        log = tempfile.TemporaryFile()
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, *cmd], env=e, cwd=cwd,
                                      stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes) \
                    or any(c not in (None, 0) for c in codes) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        shutil.rmtree(rdv, ignore_errors=True)
    out = []
    for p, log in zip(procs, logs):
        log.seek(0)
        out.append((p.returncode, log.read().decode(errors="replace")))
        log.close()
    return out
