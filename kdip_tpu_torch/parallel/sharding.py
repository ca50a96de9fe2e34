"""Data-parallel training and batch-sharded sampling over torch.distributed
ranks (PyTorch port of `kdip_tpu/parallel/sharding.py`; ref:
guided_diffusion/dist_util.py, Lightning DDP in train_openai.py:69-74,
accelerate's gather in k_diffusion/evaluation.py:53-63).

`kdip_tpu` lays one global array over a device mesh. The port's ranks are
processes, each holding its contiguous block of the leading (batch)
dimension: with W ranks and a batch of B, rank r holds rows
[r B / W, (r + 1) B / W), `kdip_tpu`'s `P("dp")` layout. The collectives
XLA inserts there are explicit here: the gradients' all_reduce (or FSDP2's
reduce-scatter), the features' all_gather, the parameters' broadcast.

A "mesh" is a `DeviceMesh` (`make_mesh`, axis "dp") or a process group;
`group_of` gives the process group of either. Under gloo alone (two ranks
on one card, where NCCL refuses to run) the all_gather and all_reduce of
CUDA tensors go through host copies (`dist.stage`); broadcast runs on
them as they are.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from . import dist as pdist


def _device_type() -> str:
    return ("cuda" if "nccl" in str(tdist.get_backend()) else "cpu")


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("dp",),
              shape: Optional[Tuple[int, ...]] = None,
              device_type: Optional[str] = None):
    """A DeviceMesh over the default group's ranks (`kdip_tpu`'s make_mesh
    over the first n devices; a rank cannot sit out of its group, so n,
    when given, must be the world size). The device type follows the
    backend: "cuda" under NCCL, else "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh
    world = tdist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh over {n_devices} of {world} ranks: every "
                         "rank of the group must take part")
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_hybrid_mesh(n_slices: int, per_slice: Optional[int] = None,
                     axis_names: Tuple[str, str] = ("dcn", "dp"),
                     device_type: Optional[str] = None):
    """A 2-D DeviceMesh, the outer axis over hosts (`kdip_tpu`'s slices over
    DCN) and the inner over each host's cards."""
    world = tdist.get_world_size()
    if per_slice is None:
        if world % n_slices:
            raise ValueError(f"{world} ranks do not split into {n_slices} "
                             "slices")
        per_slice = world // n_slices
    return make_mesh(axis_names=axis_names, shape=(n_slices, per_slice),
                     device_type=device_type)


def group_of(mesh, axis: str = "dp"):
    """The process group of a DeviceMesh's `axis`, or `mesh` itself when it
    is a process group. Needs an initialized process group."""
    if not tdist.is_initialized():
        raise SystemExit("a mesh needs an initialized process group: call "
                         "parallel.dist.setup_dist (or launch with "
                         "torchrun) first")
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        return mesh.get_group(axis) if mesh.ndim > 1 else mesh.get_group()
    if isinstance(mesh, tdist.ProcessGroup):
        return mesh
    raise TypeError(f"not a DeviceMesh or a ProcessGroup: {mesh!r}")


def fsdp_spec(param, axis_size: int, axis: str = "fsdp") -> Tuple:
    """The partition spec `kdip_tpu` gives a parameter: its largest
    dimension that `axis_size` divides sharded over `axis` (the first of
    equal ones), every other None; () (replicated) if none divides."""
    shape = tuple(getattr(param, "shape", ()))
    best, best_dim = None, -1
    for i, d in enumerate(shape):
        if d % axis_size == 0 and d > best_dim:
            best, best_dim = i, d
    if best is None:
        return ()
    return tuple(axis if i == best else None for i in range(len(shape)))


def shard_params_fsdp(module: torch.nn.Module, mesh, axis: str = "fsdp"):
    """Fully-sharded data parallelism with FSDP2 (`fully_shard`): each
    parameter sharded along the dimension `fsdp_spec` picks (all-gathered
    where it is used, its gradient reduce-scattered and averaged over the
    axis). A parameter that no dimension divides stays with FSDP2's
    default, dim 0 padded, since FSDP2 keeps no replicated parameter.
    `mesh` is a DeviceMesh; `axis` names its sharded axis (a 1-D mesh of
    any name serves). Returns the module."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    sub = mesh[axis] if mesh.ndim > 1 else mesh
    size = sub.size()

    def placement(p):
        spec = fsdp_spec(p, size, axis)
        return Shard(spec.index(axis)) if spec else None
    fully_shard(module, mesh=sub, shard_placement_fn=placement)
    return module


def batch_sharding():
    """The leading dimension split over the axis (`kdip_tpu`'s P("dp"))."""
    from torch.distributed.tensor import Shard
    return (Shard(0),)


def replicated():
    """Every rank holds all of it (`kdip_tpu`'s P())."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),)


def block(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank `rank`'s contiguous block of x's leading dimension, which
    `world` must divide."""
    n = x.shape[0]
    if n % world:
        raise ValueError(f"a leading dimension of {n} does not split over "
                         f"{world} ranks")
    k = n // world
    return x[rank * k:(rank + 1) * k]


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree: Any, group=None) -> Any:
    """This rank's block of every tensor in the tree (the per-rank dataset
    shard of guided_diffusion/image_datasets.py:53-54)."""
    r, w = pdist.get_rank(group), pdist.get_world_size(group)
    return _tree_map(lambda x: block(torch.as_tensor(x), r, w), tree)


def replicate(tree: Any, group=None) -> Any:
    """Rank 0's tensors (a module's parameters and buffers, or a tree of
    tensors) on every rank, broadcast in place."""
    if isinstance(tree, torch.nn.Module):
        return pdist.sync_params(tree, group)
    if pdist.is_active(group):
        _tree_map(lambda t: tdist.broadcast(t, src=pdist._src(group),
                                            group=group), tree)
    return tree


def data_parallel(fn: Callable, group=None,
                  batch_argnums: Sequence[int] = (1,)) -> Callable:
    """`fn(params, batch, ...)` with params (argument 0) broadcast from rank
    0 and the `batch_argnums` arguments cut to this rank's block; what fn
    reduces over the batch it reduces across ranks itself."""
    def wrapper(*args, **kwargs):
        placed = [shard_batch(a, group) if i in batch_argnums
                  else replicate(a, group) if i == 0 else a
                  for i, a in enumerate(args)]
        return fn(*placed, **kwargs)
    return wrapper


def all_gather_blocks(x: torch.Tensor, group=None):
    """Every rank's x, a list in rank order; the blocks may differ in
    leading size (each padded to the largest for the collective, then
    trimmed, as guided-diffusion's resample.py:83-104 gathers). CUDA
    tensors go through the host where the group's backend is gloo. One
    rank's list without a group."""
    if not pdist.is_active(group):
        return [x]
    world = tdist.get_world_size(group)
    staged = x.cpu() if pdist.stage(x, group) else x
    n = torch.tensor([staged.shape[0]], device=staged.device)
    sizes = [torch.zeros_like(n) for _ in range(world)]
    tdist.all_gather(sizes, n, group=group)
    sizes = [int(s) for s in sizes]
    top = max(sizes)
    if staged.shape[0] < top:
        staged = torch.cat([staged, staged.new_zeros(
            (top - staged.shape[0],) + staged.shape[1:])])
    out = [torch.empty_like(staged) for _ in range(world)]
    tdist.all_gather(out, staged.contiguous(), group=group)
    return [o[:k].to(x.device) for o, k in zip(out, sizes)]


def gather_to_host(x, group=None) -> np.ndarray:
    """The whole array on every rank's host, the ranks' blocks in rank
    order (`kdip_tpu`'s process_allgather, tiled; the reference's
    accelerate.gather). Without a group, x itself."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    return torch.cat(all_gather_blocks(x.detach(), group)).cpu().numpy()


def make_sharded_sampler(sample_fn: Callable, group=None) -> Callable:
    """Batch-parallel posterior sampling over the group's ranks
    (`kdip_tpu`'s make_sharded_sampler: the batched sampler on a sharded
    batch). `sample_fn` is a `sampling_api.build_posterior_sampler`
    sampler, built with per_sample_map=False.

    `sharded(measurement, n, **kw)` takes the global measurement (n rows,
    one a sample) and returns this rank's block of the n samples. The
    keywords are the sampler's (generator, init_noise, noise_fn, probe_fn,
    return_info), of the global batch: every rank makes the global batch's
    draws and keeps its own block (the sampler's `shard`); the sampler's
    reductions over the batch (the joint CG's inner products, the iso
    means, dps's and stsl's norms and sums) sum across the ranks
    (`guidance.batch_group`). So rank r's block is rows
    [r n / W, (r + 1) n / W) of the unsharded batched run, and every rank
    takes the same CG iterations. Without a group it is `sample_fn`."""
    from .. import guidance
    from ..operators import Measurement

    def sharded(measurement, n: int, **kw):
        r, w = pdist.get_rank(group), pdist.get_world_size(group)
        if measurement.y.shape[0] != n:
            raise ValueError(f"the sharded sampler pairs each of the n={n} "
                             f"samples with its own measurement row, got "
                             f"{measurement.y.shape[0]}")
        with guidance.batch_group(group):
            return sample_fn(Measurement(y=block(measurement.y, r, w)),
                             n=n // w, shard=(r, w), **kw)

    return sharded
