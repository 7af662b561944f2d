"""Spatial partitioning: one image's height cut into bands over the mesh's
model axis, with halo exchange.

Counterpart of what XLA's SPMD partitioner inserts for the JAX package's
spatial_sharding (vision_kit_tpu/parallel/mesh.py): there the images'
height is sharded over the "model" axis, and XLA exchanges the rows a conv
or pool window needs across a shard edge and re-gathers the head maps.
Here the training and eval steps and the predictor open `banded(mesh,
height)` around the model's forward (and its backward), hand the model
this rank's band of image rows (Bands.rows), and the model does the rest:
every conv and pool whose window crosses a band edge first takes its halo
rows (Bands.window, models/layers.py), and the head stacks its raw maps'
bands into the whole maps on every rank (Bands.gather, models/heads.py).
The result is the unsharded program's, as in JAX.

The band plan: each model index holds a contiguous band of the input rows
that starts at a multiple of 32, the network's total stride, so every
strided conv and 2x2 pool maps band to band; the bands are as even as
whole multiples of 32 allow (640 over 3 ranks: 224, 224, 192), and the last
takes any tail. A band keeps at least 2 rows of the stride-32 map, JAX's
size check (check_height).

Only all_reduce (a sum) moves data, as gloo carries no other collective on
CUDA tensors (parallel/mesh.py). A halo moves only boundary rows: each rank
fills its own slot of a small (n_model, 2, B, C, h, W) buffer with its
first and last rows and the buffer is summed over the model axis with the
gradient-carrying all_reduce, whose backward adds each reader's halo
gradient into the owner's rows (the VJP XLA builds). The gather's backward
is the slice of the incoming gradient: every model rank computes the same
loss on the same gathered maps, so each takes only its band's share.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from vision_kit_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, all_reduce, axis_group

TOTAL_STRIDE = 32   # the networks' deepest map is the input's height / 32
MIN_ROWS = 2        # rows of a band at the stride-32 map


def check_height(height: int, n_model: int) -> None:
    """JAX's size check (vision_kit_tpu/predictor.py): a height below
    64 * n_model raises ValueError."""
    if height < MIN_ROWS * TOTAL_STRIDE * n_model:
        raise ValueError(
            f"spatial=True needs img_size H >= {MIN_ROWS * TOTAL_STRIDE * n_model} for "
            f"{n_model} model shards (>= {MIN_ROWS} rows/shard on the stride-32 map); "
            f"got {height}")


def band_plan(height: int, n_model: int) -> list[tuple[int, int]]:
    """Each model index's (start, stop) input rows: starts on multiples of
    32, as even as whole multiples of 32 allow (the first bands take the
    extra ones), the last band taking the tail below the last multiple."""
    check_height(height, n_model)
    base, extra = divmod(height // TOTAL_STRIDE, n_model)
    spans, start = [], 0
    for m in range(n_model):
        stop = start + (base + (m < extra)) * TOTAL_STRIDE
        spans.append((start, stop))
        start = stop
    spans[-1] = (spans[-1][0], height)
    return spans


class Bands:
    """The band plan of one forward on this rank of `mesh`, for inputs of
    `height` rows. Bands.active is the plan of the forward now running in
    this process (None: no forward is banded); `banded` sets it, and the
    layers read it, as BatchNorm2d reads the mesh the step gives it."""

    active: Bands | None = None

    def __init__(self, mesh: Mesh, height: int):
        self.mesh = mesh
        self.height = height
        self.spans = band_plan(height, mesh.n_model)
        self.index = mesh.model_index

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's band of NHWC images."""
        start, stop = self.spans[self.index]
        return x[:, start:stop]

    def sizes(self, n: int) -> list[int]:
        """Every band's height at the map where this rank's band is n rows:
        the input rows over the map's stride (a power of two)."""
        start, stop = self.spans[self.index]
        stride = 2 ** round(math.log2((stop - start) / n))
        out = [-(-(b - a) // stride) for a, b in self.spans]
        out[self.index] = n
        return out

    def window(self, x: torch.Tensor, kernel: int, stride: int, padding: int,
               fill: float) -> torch.Tensor:
        """x, this rank's band (B, C, n, W) of a map, ready for an op whose
        window is `kernel` rows at `stride` with `padding` rows of `fill`
        around the whole map: returned with `padding` rows of the bands
        above and kernel - padding - stride rows of those below (the rows
        the band's outputs read), and `fill` rows past the map's border.
        The op then runs unpadded in H."""
        return self.halo(x, padding, max(kernel - padding - stride, 0), fill, padding)

    def halo(self, x: torch.Tensor, top: int, bottom: int, fill: float,
             edge: int) -> torch.Tensor:
        """x with `top` rows of the bands above and `bottom` rows of the
        bands below, taken from as many bands away as they span; rows past
        the map's top are `fill`, and so are those past its bottom: the
        rest of `bottom` for a band with bands below, `edge` rows (the op's
        own padding) for the last band."""
        nm, m = self.mesh.n_model, self.index
        if top == 0 and bottom == 0 and edge == 0:
            return x
        above, below = [], []
        need_top, need_bottom = top, bottom
        h = max(top, bottom)
        if nm > 1 and h > 0:
            sizes = self.sizes(x.shape[2])
            n = x.shape[2]
            k_first, k_last = min(bottom, n), min(top, n)
            # slot 0: the first rows (what the bands above read), slot 1:
            # the last rows, right-aligned (what the bands below read)
            slot = torch.stack([F.pad(x[:, :, :k_first], (0, 0, 0, h - k_first)),
                                F.pad(x[:, :, n - k_last:], (0, 0, h - k_last, 0))])
            zeros = torch.zeros_like(slot)
            buf = all_reduce(self.mesh, torch.stack([slot if j == m else zeros
                                                     for j in range(nm)]), MODEL_AXIS)
            # a rank that reads none of it still sends its rows' gradient
            # back through the sum's backward, a collective every rank of
            # the model axis must join: an empty slice keeps the sum in its
            # graph
            below.append(buf[m, 0, :, :, :0])
            j = m - 1
            while need_top > 0 and j >= 0:
                k = min(need_top, sizes[j])
                above.insert(0, buf[j, 1, :, :, h - k:])
                need_top -= k
                j -= 1
            j = m + 1
            while need_bottom > 0 and j < nm:
                k = min(need_bottom, sizes[j])
                below.append(buf[j, 0, :, :, :k])
                need_bottom -= k
                j += 1
        if m == nm - 1:
            need_bottom = edge
        b, c, _, w = x.shape
        if need_top:
            above.insert(0, x.new_full((b, c, need_top, w), fill))
        if need_bottom:
            below.append(x.new_full((b, c, need_bottom, w), fill))
        return torch.cat([*above, x, *below], dim=2)

    def gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each (B, C, n, W) band stacked along H with the model axis's
        bands into the whole map, on every rank (one collective); the
        gradient of a band is the slice of the whole map's."""
        if self.mesh.n_model == 1:
            return list(xs)
        return list(_GatherBands.apply(self, *xs))


class _GatherBands(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bands: Bands, *xs):
        dtype = xs[0].dtype
        if any(x.dtype != dtype for x in xs):
            raise TypeError("gather_bands takes maps of one dtype")
        offsets, bufs = [], []
        for x in xs:
            b, c, n, w = x.shape
            sizes = bands.sizes(n)
            off = sum(sizes[:bands.index])
            # NHWC buffers: the head's (B, ny, nx, na, no) view of the whole
            # map is then a view, as of the band's channels_last conv output
            buf = x.new_zeros((b, sum(sizes), w, c))
            buf[:, off:off + n] = x.permute(0, 2, 3, 1)
            offsets.append((off, n))
            bufs.append(buf)
        flat = torch.cat([buf.reshape(-1) for buf in bufs])
        dist.all_reduce(flat, group=axis_group(bands.mesh, MODEL_AXIS))
        ctx.offsets = offsets
        out, pos = [], 0
        for buf in bufs:
            out.append(flat[pos:pos + buf.numel()].view(buf.shape).permute(0, 3, 1, 2))
            pos += buf.numel()
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *[g[:, :, off:off + n] for g, (off, n) in zip(grads, ctx.offsets)])


@contextlib.contextmanager
def banded(mesh: Mesh, height: int):
    """Band the model's forwards (and backwards) over `mesh`'s model axis
    while the context is open, for inputs of `height` rows; yields the
    Bands, whose rows() is the input this rank hands the model."""
    bands = Bands(mesh, height)
    previous, Bands.active = Bands.active, bands
    try:
        yield bands
    finally:
        Bands.active = previous
