"""The (data, model) mesh: one process per device, ranks on a grid.

Counterpart of vision_kit_tpu/parallel/mesh.py. The JAX mesh is a grid of
devices with a "data" and a "model" axis, and XLA inserts the collectives;
here a Mesh names this process's rank in the torch.distributed group, its
device, its place on the (n_data, n_model) grid (rank = d * n_model + m, as
JAX reshapes the device list) and the process groups of its row and column,
and the training and eval steps, the predictor and the server call the
collectives below themselves (train/step.py, train/losses.py,
models/layers.py, predictor.py, serve.py).

The data axis shards the batch: the ranks of one column (this model index)
hold different rows. The model axis shards the image height
(parallel/spatial.py): the ranks of one row (this data index) hold the
bands of the same images.

Only all_reduce (a sum) and broadcast are used on tensors: gloo carries
both on CUDA tensors, so two processes can share one card over gloo, where
NCCL refuses two ranks on one GPU.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from vision_kit_tpu_torch.utils.general import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """A mesh of n_data x n_model processes: this one's rank, its device and
    the process groups (None: the default group, the world).

    group spans the whole mesh; data_group the ranks with this model index
    (the data axis: the batch's shards), model_group the ranks with this
    data index (the model axis: one image's height bands). With n_model 1
    data_group is the whole mesh and model_group is unused."""

    n_data: int
    rank: int
    device: torch.device
    group: object = None
    n_model: int = 1
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """The (data, model) mesh over the initialised process group
    (parallel/distributed.py:init_distributed): its world size must equal
    n_data * n_model (n_data, when not given, is the world over n_model).
    device: this process's device ("cuda" is the current CUDA device, which
    init_distributed set to cuda:LOCAL_RANK). With n_model > 1 every rank
    creates every row's and column's process group, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel/distributed.py:init_distributed)")
    world = dist.get_world_size()
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model {n_model} does not divide the world size {world}")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh differs from the world size {world}: "
                         "one process per device")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    data_group = model_group = None
    if n_model > 1:
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == rank // n_model:
                model_group = g
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == rank % n_model:
                data_group = g
    return Mesh(n_data=n_data, rank=rank, device=device, n_model=n_model,
                data_group=data_group, model_group=model_group)


def check_mesh(mesh) -> Mesh | None:
    """`mesh` if it is a Mesh or None; anything else raises TypeError."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), not "
                        f"{type(mesh).__name__}")
    return mesh


def axis_group(mesh: Mesh, axis: str | None):
    """The process group of a mesh axis: None is the whole mesh, DATA_AXIS
    the ranks with this model index, MODEL_AXIS those with this data
    index."""
    if axis is None or (axis == DATA_AXIS and mesh.n_model == 1):
        return mesh.group
    if axis == DATA_AXIS:
        return mesh.data_group
    if axis == MODEL_AXIS:
        return mesh.model_group
    raise ValueError(f"mesh axis {axis!r}")


def shard_rows(mesh: Mesh, n: int, accum_steps: int = 1) -> torch.Tensor:
    """The row indices this rank holds of an n-row global batch: of each of
    accum_steps consecutive microbatches, the data shard's contiguous share,
    in microbatch order. So chunk k of the local rows is the shard's share
    of microbatch k, as the JAX step splits a global batch into microbatches
    and then shards each over the data axis. The ranks of one data index
    (the model axis) hold the same rows."""
    if n % (accum_steps * mesh.n_data):
        raise ValueError(f"batch {n} does not split into {accum_steps} microbatches "
                         f"over {mesh.n_data} ranks")
    micro, share = n // accum_steps, n // (accum_steps * mesh.n_data)
    d = mesh.data_index
    return torch.cat([torch.arange(k * micro + d * share, k * micro + (d + 1) * share)
                      for k in range(accum_steps)])


def shard_batch(mesh: Mesh, batch: dict, accum_steps: int = 1) -> dict:
    """This rank's rows (shard_rows) of a global batch, a dict of arrays or
    tensors with the batch first; tensors go to the mesh's device, numpy
    arrays stay numpy."""
    out = {}
    for k, v in batch.items():
        rows = shard_rows(mesh, len(v), accum_steps)
        if isinstance(v, torch.Tensor):
            out[k] = v[rows.to(v.device)].to(mesh.device)
        else:
            out[k] = v[rows.numpy()]
    return out


def all_reduce(mesh: Mesh, x: torch.Tensor, axis: str | None = None) -> torch.Tensor:
    """The sum of x over the mesh's ranks (over one axis's, see axis_group),
    with its gradient: that of each rank's input is the sum of the ranks'
    output gradients, as each rank's loss is its share of the whole.
    torch.distributed.nn.functional's all_reduce, whose deprecation notice
    is silenced: the functional collectives it points to carry no gradient
    of an all-reduce."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return dist_nn.all_reduce(x, group=axis_group(mesh, axis))


def all_reduce_(mesh: Mesh, tensors: list[torch.Tensor], axis: str | None = None) -> None:
    """Sum each tensor over the ranks (of `axis`, see axis_group) in place,
    one collective per dtype through a flat bucket."""
    for group in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=axis_group(mesh, axis))
        _unflatten_into(flat, group)


def broadcast_(mesh: Mesh, tensors: list[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank src's, in place, one collective per
    dtype through a flat bucket."""
    for group in _by_dtype(tensors):
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src, group=mesh.group)
        _unflatten_into(flat, group)


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The data shards' (n, ...) tensors stacked in data-index order into
    (n_data * n, ...): a zero buffer that each rank fills at its shard's
    slot, summed over the data axis (gloo has no all-gather of CUDA
    tensors). Every rank's x has the same shape and dtype; bool travels as
    uint8."""
    dtype = torch.uint8 if x.dtype == torch.bool else x.dtype
    n = x.shape[0]
    d = mesh.data_index
    buf = torch.zeros((mesh.n_data * n, *x.shape[1:]), dtype=dtype, device=x.device)
    buf[d * n:(d + 1) * n] = x
    dist.all_reduce(buf, group=axis_group(mesh, DATA_AXIS))
    return buf.bool() if x.dtype == torch.bool else buf


def broadcast_object(mesh: Mesh, obj, src: int = 0):
    """Rank src's picklable object, on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src, group=mesh.group)
    return box[0]


def barrier(mesh: Mesh) -> None:
    dist.barrier(group=mesh.group)


def _by_dtype(tensors):
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


def _unflatten_into(flat: torch.Tensor, tensors) -> None:
    off = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n
