"""Multi-process runtime on torch.distributed (PyTorch port of
`kdip_tpu/parallel/dist.py`; ref: guided_diffusion/dist_util.py:21-95).

- ``setup_dist`` -- `init_process_group` when the launcher's environment
  (torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT, or explicit
  arguments) says there is a process group to join; a no-op otherwise.
  On the card the group runs NCCL for CUDA tensors and gloo for CPU ones
  (`cpu:gloo,cuda:nccl`), on the CPU gloo alone.
- ``dev`` -- this rank's card, cuda:LOCAL_RANK; never the CPU.
- ``barrier`` / ``warmup_collectives`` -- a named barrier on the group's
  store with a timeout of its own, and a first collective made while the
  ranks are in lockstep.
- ``load_state_dict`` -- rank 0 reads the file, its bytes are broadcast
  (the length first, then a uint8 tensor), every rank parses them.
- ``sync_params`` -- parameters and buffers broadcast from rank 0.

A helper that takes `group` is a local operation for group=None (no
group): callers pass `torch.distributed.group.WORLD` for the default
group, which is None itself until `setup_dist` has joined one. So the
same code runs in one process and across ranks.
"""

from __future__ import annotations

import datetime
import io
import os
import pickle
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

__all__ = ["setup_dist", "dev", "load_state_dict", "read_if_present",
           "sync_params", "barrier", "all_reduce", "mean_over_ranks",
           "stage", "warmup_collectives", "is_active", "get_rank",
           "get_world_size", "broadcast_object"]

TIMEOUT = datetime.timedelta(minutes=10)


def is_active(group=None) -> bool:
    """Whether `group` names a process group (None: no group)."""
    return group is not None


def _initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def get_rank(group=None) -> int:
    """This process's rank in `group`, 0 without one."""
    return tdist.get_rank(group) if is_active(group) else 0


def get_world_size(group=None) -> int:
    """The ranks in `group`, 1 without one."""
    return tdist.get_world_size(group) if is_active(group) else 1


def _src(group) -> int:
    """The global rank of `group`'s rank 0, the source of broadcasts."""
    return tdist.get_global_rank(group, 0)


def stage(t: torch.Tensor, group=None) -> bool:
    """Whether a collective on `t` goes through the host: a CUDA tensor
    in a group whose backend is gloo alone (two ranks on one card, where
    NCCL refuses to run)."""
    return t.is_cuda and "nccl" not in str(tdist.get_backend(group))


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sums `t` over the group's ranks in place and returns it; a CUDA
    tensor under gloo alone is summed through a host copy. `t` itself
    without a group."""
    if not is_active(group):
        return t
    if not stage(t, group):
        tdist.all_reduce(t, group=group)
        return t
    host = t.cpu()
    tdist.all_reduce(host, group=group)
    return t.copy_(host)


@torch.no_grad()
def mean_over_ranks(tensors: Sequence[torch.Tensor], group=None
                    ) -> List[torch.Tensor]:
    """Each tensor averaged over the group's ranks, in one all_reduce of
    their concatenation (DDP's arithmetic: a sum, then a division by the
    world size), each returned in its own shape in the concatenation's
    dtype. The tensors themselves without a group."""
    if not is_active(group):
        return list(tensors)
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    flat /= tdist.get_world_size(group)
    return [o.view_as(t) for o, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v not in (None, ""):
            return int(v)
    return None


def _launcher_world() -> Optional[int]:
    """The process count a launcher's environment announces, if any:
    torchrun's WORLD_SIZE, Open MPI's OMPI_COMM_WORLD_SIZE or Slurm's
    SLURM_NTASKS (a bare SLURM_JOB_ID counts as one task)."""
    world = _env_int("WORLD_SIZE", "OMPI_COMM_WORLD_SIZE", "SLURM_NTASKS")
    if world is None and os.environ.get("SLURM_JOB_ID"):
        return 1
    return world


def setup_dist(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device: str = "cuda",
               backend: Optional[str] = None) -> bool:
    """Joins the process group once per process (ref: dist_util.py:21-42;
    `kdip_tpu` parallel/dist.py:33-103). Returns whether a group is active.

    With `init_method` (e.g. "tcp://localhost:29500"), `world_size` and
    `rank` it joins that rendezvous. Otherwise it reads the launcher's
    environment: torchrun's RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT;
    Open MPI's and Slurm's rank and size beside a MASTER_ADDR and
    MASTER_PORT. With none of those markers it does nothing (one
    process). When the markers announce more than one process but give no
    address to meet at, it raises: degrading to independent
    single-process runs would train or sample W copies of one shard.

    The backend is `cpu:gloo,cuda:nccl` for `device` "cuda" (and the
    process's card becomes cuda:LOCAL_RANK), gloo for "cpu"; `backend`
    overrides it (two ranks on one card need gloo: NCCL refuses two ranks
    on one device)."""
    if tdist.is_initialized():
        return True
    env = os.environ
    launcher_world = _launcher_world()
    if init_method is None and launcher_world is None and world_size is None:
        return False  # one process, nothing to set up
    world = world_size if world_size is not None else (launcher_world or 1)
    if rank is None:
        rank = _env_int("RANK", "OMPI_COMM_WORLD_RANK", "SLURM_PROCID") or 0
    if init_method is None:
        if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            init_method = "env://"
        elif world > 1:
            raise RuntimeError(
                f"multi-worker launch detected (the environment announces "
                f"{world} processes) but there is no rendezvous address "
                "(MASTER_ADDR / MASTER_PORT, or setup_dist(init_method=)) "
                "-- refusing to fall back to independent single-process "
                "runs")
        else:
            print("setup_dist: a launcher marker is present but no "
                  "rendezvous address; continuing single-process",
                  flush=True)
            return False
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if device == "cuda" else "gloo"
    if "nccl" in backend:
        torch.cuda.set_device(dev())
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=world, rank=rank, timeout=TIMEOUT)
    return True


def dev() -> torch.device:
    """This rank's card, cuda:LOCAL_RANK (ref: dist_util.py:45-51). A
    LOCAL_RANK with no card behind it exits with a message: there is no
    CPU fallback."""
    local = _env_int("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK",
                     "SLURM_LOCALID") or 0
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local >= n:
        raise SystemExit(f"LOCAL_RANK {local} has no CUDA card ({n} "
                         "visible); launch at most one rank per card")
    return torch.device("cuda", local)


_barrier_seq = [0]


def barrier(name: str, timeout_ms: int = 600_000) -> None:
    """Aligns every rank at a named point on the default group's store (no
    collective, and a timeout of its own). A sequence number is appended,
    so one call site can be reached again without reusing a finished
    barrier's keys. No-op when no process group is initialized."""
    if not _initialized():
        return
    from torch.distributed.distributed_c10d import _get_default_store
    store = _get_default_store()
    _barrier_seq[0] += 1
    key = f"kdip_{name}_{_barrier_seq[0]}"
    store.set(f"{key}/{tdist.get_rank()}", "1")
    store.wait([f"{key}/{r}" for r in range(tdist.get_world_size())],
               datetime.timedelta(milliseconds=timeout_ms))


def warmup_collectives(device: Optional[torch.device] = None) -> None:
    """A barrier, then a first all_reduce while the ranks are in lockstep,
    so the backends' connections are made at one moment and not inside a
    first collective the ranks reach minutes apart (gloo's connect has a
    fixed timeout). On CPU tensors, and on `device` too when it is a card
    (NCCL makes its communicator there). No-op when no process group is
    initialized."""
    if not _initialized():
        return
    barrier("warmup_enter")
    devices = [torch.device("cpu")]
    if device is not None and torch.device(device).type == "cuda":
        devices.append(torch.device(device))
    for d in devices:
        tdist.all_reduce(torch.ones(1, device=d))


def _broadcast_bytes(data: Optional[bytes], group=None) -> Optional[bytes]:
    """Rank 0's byte blob on every rank, on the CPU: its length (an int64,
    -1 where rank 0 has none to send, and then None everywhere), then a
    uint8 tensor of that length (`kdip_tpu` parallel/dist.py:147-158)."""
    is_src = get_rank(group) == 0
    n = torch.tensor([len(data) if is_src and data is not None else -1],
                     dtype=torch.int64)
    tdist.broadcast(n, src=_src(group), group=group)
    n = int(n)
    if n < 0:
        return None
    buf = (torch.from_numpy(np.frombuffer(data, np.uint8).copy()) if is_src
           else torch.empty(n, dtype=torch.uint8))
    tdist.broadcast(buf, src=_src(group), group=group)
    return buf.numpy().tobytes()


def broadcast_object(obj: Any, group=None) -> Any:
    """Rank 0's picklable `obj` on every rank (as bytes on the CPU, so it
    rides gloo under either backend). Identity without a group."""
    if not is_active(group):
        return obj
    return pickle.loads(_broadcast_bytes(pickle.dumps(obj), group))


def _parse_default(path: str, f) -> Any:
    """A numpy .npz as a dict; anything else through the port's torch
    checkpoint reader (a Lightning file's state_dict unwrapped)."""
    from .. import ckpt
    if path.endswith(".npz"):
        with np.load(f, allow_pickle=True) as z:
            return dict(z)
    return ckpt.load_torch_checkpoint(f)


def load_state_dict(path: str, convert: Optional[Callable] = None,
                    parse: Optional[Callable] = None, group=None) -> Any:
    """A checkpoint that only rank 0 reads from storage: its bytes are
    broadcast and every rank parses them (ref: dist_util.py:54-74;
    `kdip_tpu` parallel/dist.py:167-203). `parse(file_like)` overrides the
    parser (by default numpy for .npz, else `ckpt.load_torch_checkpoint`);
    `convert(path)` bypasses the byte path with a local load on every
    rank. Without a group it is a local read. A path rank 0 cannot read
    raises on every rank."""
    from .. import ckpt
    parse = parse or (lambda f: _parse_default(path, f))
    if convert is not None:
        return convert(path)
    if not is_active(group):
        ckpt.refuse_orbax(path)
        with open(path, "rb") as f:
            return parse(f)
    data, why = None, None
    if get_rank(group) == 0:
        try:
            ckpt.refuse_orbax(path)
            with open(path, "rb") as f:
                data = f.read()
        except (OSError, SystemExit) as e:
            why = str(e)
    data = _broadcast_bytes(data, group)
    if data is None:
        raise SystemExit(why or f"{path}: rank 0 could not read it")
    return parse(io.BytesIO(data))


def read_if_present(path: str, parse: Callable, group=None) -> Any:
    """`parse(path)` where rank 0 finds a file at `path`, else None, on
    every rank: rank 0 looks and reads, and broadcasts (a local read
    without a group)."""
    if not is_active(group):
        return parse(path) if os.path.exists(path) else None
    if not broadcast_object(os.path.exists(path), group):
        return None
    return load_state_dict(path, parse=parse, group=group)


@torch.no_grad()
def sync_params(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Broadcasts every parameter and buffer of `module` from rank 0, in
    place (ref: dist_util.py:77-82). Identity without a group."""
    if not is_active(group):
        return module
    for t in list(module.parameters()) + list(module.buffers()):
        tdist.broadcast(t.data, src=_src(group), group=group)
    return module
