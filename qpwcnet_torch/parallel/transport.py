"""The two transports of the H-sharded (spatial) path, and the active mesh.

XLA partitions every conv, resize and reduction of the JAX package's
H-sharded model by itself (``qpwcnet_tpu/parallel/spatial.py``); PyTorch
has no partitioner, so the port's ops ask the active mesh
(:func:`active_mesh`, set by :func:`use_mesh`) for the rows their
neighbours hold. A transport moves those rows between the H shards of the
mesh's 'model' axis, through one small interface:

  * ``exchange(x, dim, before, after, edge)``: the ``before`` last rows of
    the previous shard and the ``after`` first rows of the next one, along
    ``dim``; zeros at the global ends (the conv's and the cost volume's
    zero padding), or the edge row replicated under ``edge`` (the 2x
    upsampling's and the window warp's border clamp). Differentiable: the
    halo rows' gradients go back to the shards that own them (the
    transpose of JAX's ``ppermute``).
  * ``gather(x, dim)`` / ``keep(x, dim)``: the whole level from every
    shard, and this shard's rows of a whole level (the fallback of the
    levels too coarse for a one-hop halo).
  * ``procs``: the processes the shards span, and ``n``: the shards.

:class:`LocalShards` holds all n shards in one process: the shard index is
folded into the batch, shard-minor (row ``b * n + s`` of a (B·n, ...)
tensor is shard s of image b), so an exchange is a slice along that axis,
the whole level is a view, one kernel launch covers every shard, and a
reduction over the batch already covers every shard. The siamese 2B stack
(``cat([prv, nxt])`` and ``e[:b]`` in ``PWCFlowNet.forward``) keeps each
image's shards together. :class:`GroupShards` holds one shard a process
of a ``torch.distributed`` group: exchanges by ``batch_isend_irecv``,
gathers and reductions by collectives (NCCL on cards, gloo on the CPU).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

_ACTIVE: list = []


def active_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the block with ``mesh`` active: the model's ops then exchange
    halo rows over its 'model' axis and reduce over its processes."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_shards():
    """The active mesh's H-shard transport when it has two or more shards,
    else None (the unsharded ops)."""
    mesh = active_mesh()
    if mesh is None or mesh.model.n == 1:
        return None
    return mesh.model


def n_shards() -> int:
    """The H shards of the active mesh (1 without one): a shard's rows
    times this are the image's (OptFlow's scale, the loss's)."""
    mesh = active_mesh()
    return 1 if mesh is None else mesh.model.n


def halo_rows(x: torch.Tensor, dim: int, before: int, after: int,
              edge: bool = False) -> torch.Tensor:
    """x with ``before`` rows of the previous shard above it and ``after``
    rows of the next shard below it along ``dim`` (the active mesh's
    exchange)."""
    top, bot = active_mesh().model.exchange(x, dim, before, after, edge)
    # in x's memory format (the model's channels_last), so that the convs
    # and kernels downstream keep it
    fmt = (torch.channels_last if x.dim() == 4 and x.is_contiguous(
        memory_format=torch.channels_last) else torch.contiguous_format)
    parts = [t.contiguous(memory_format=fmt) for t in (top, bot)
             if t is not None]
    if top is not None:
        parts.insert(1, x)
    else:
        parts.insert(0, x)
    return torch.cat(parts, dim)


class LocalShards:
    """n H shards in this process, folded into the batch shard-minor."""

    procs = 1

    def __init__(self, n: int):
        self.n = n

    def exchange(self, x: torch.Tensor, dim: int, before: int, after: int,
                 edge: bool = False):
        v = x.unflatten(0, (-1, self.n))  # (B, n, ...): dim moves to d
        d, h = dim + 1, x.shape[dim]
        top = bot = None
        if before:
            last = v.narrow(d, h - before, before)
            end = (v[:, :1].narrow(d, 0, 1).expand_as(last[:, :1]) if edge
                   else torch.zeros_like(last[:, :1]))
            top = torch.cat([end, last[:, :-1]], 1).flatten(0, 1)
        if after:
            first = v.narrow(d, 0, after)
            end = (v[:, -1:].narrow(d, h - 1, 1).expand_as(first[:, :1])
                   if edge else torch.zeros_like(first[:, :1]))
            bot = torch.cat([first[:, 1:], end], 1).flatten(0, 1)
        return top, bot

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """(B·n, ..., h, ...) -> (B, ..., n·h, ...): a view of x."""
        return x.unflatten(0, (-1, self.n)).movedim(1, dim).flatten(
            dim, dim + 1)

    def keep(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """(B, ..., n·h, ...) -> (B·n, ..., h, ...): a view of x."""
        return x.unflatten(dim, (self.n, -1)).movedim(dim, 1).flatten(0, 1)


class GroupShards:
    """One H shard a process of ``group`` (``ranks``: its global ranks in
    shard order; ``index``: this process's shard)."""

    def __init__(self, group, ranks: list, index: int):
        self.group = group
        self.ranks = list(ranks)
        self.n = len(self.ranks)
        self.procs = self.n
        self.index = index

    def exchange(self, x: torch.Tensor, dim: int, before: int, after: int,
                 edge: bool = False):
        top, bot = _Exchange.apply(x, dim, before, after, self)
        if edge and before and self.index == 0:
            top = x.narrow(dim, 0, 1).expand_as(top)
        if edge and after and self.index == self.n - 1:
            bot = x.narrow(dim, x.shape[dim] - 1, 1).expand_as(bot)
        return (top if before else None), (bot if after else None)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _AllGather.apply(x, dim, self)

    def keep(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        h = x.shape[dim] // self.n
        return x.narrow(dim, self.index * h, h)

    def swap(self, up: Optional[torch.Tensor], down: Optional[torch.Tensor],
             from_prev, from_next):
        """Send ``up`` to the previous shard and ``down`` to the next;
        receive tensors shaped like ``from_prev`` (a template, or None for
        nothing) from the previous shard and ``from_next`` from the next.
        The ends send and receive nothing: their receives stay zero."""
        def buffer(like):
            return None if like is None else torch.zeros(
                like.shape, dtype=like.dtype, device=like.device)

        recv_prev, recv_next = buffer(from_prev), buffer(from_next)
        ops = []
        i = self.index
        if i > 0:
            if up is not None:
                ops.append(dist.P2POp(dist.isend, up.contiguous(),
                                      self.ranks[i - 1], self.group))
            if recv_prev is not None:
                ops.append(dist.P2POp(dist.irecv, recv_prev,
                                      self.ranks[i - 1], self.group))
        if i < self.n - 1:
            if down is not None:
                ops.append(dist.P2POp(dist.isend, down.contiguous(),
                                      self.ranks[i + 1], self.group))
            if recv_next is not None:
                ops.append(dist.P2POp(dist.irecv, recv_next,
                                      self.ranks[i + 1], self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return recv_prev, recv_next


class _Exchange(torch.autograd.Function):
    """(top, bot) of :meth:`GroupShards.exchange`: this shard's last
    ``before`` rows go to the next shard (its top), its first ``after``
    rows to the previous one (its bot). The backward sends each halo's
    gradient back to its owner and adds what comes back onto the rows
    that were sent."""

    @staticmethod
    def forward(ctx, x, dim, before, after, shards):
        h = x.shape[dim]
        ctx.meta = (dim, before, after, shards, x.shape)
        last = x.narrow(dim, h - before, before) if before else None
        first = x.narrow(dim, 0, after) if after else None
        top, bot = shards.swap(first, last, last, first)
        empty = x.new_zeros(())
        return (empty if top is None else top), (empty if bot is None
                                                 else bot)

    @staticmethod
    def backward(ctx, g_top, g_bot):
        dim, before, after, shards, shape = ctx.meta
        h = shape[dim]
        g_top = g_top.contiguous() if before else None
        g_bot = g_bot.contiguous() if after else None
        # the previous shard's last rows made my top; the next shard's
        # first rows my bot: their gradients go back there
        from_prev, from_next = shards.swap(g_top, g_bot, g_bot, g_top)
        dx = torch.zeros(shape, dtype=(g_top if before else g_bot).dtype,
                         device=(g_top if before else g_bot).device)
        if before:
            dx.narrow(dim, h - before, before).add_(from_next)
        if after:
            dx.narrow(dim, 0, after).add_(from_prev)
        return dx, None, None, None, None


class _AllGather(torch.autograd.Function):
    """The whole level along ``dim`` from every shard of the group. Every
    process then computes from all of it and keeps its own rows, so a
    shard's gradient is the sum of every process's gradient of its rows."""

    @staticmethod
    def forward(ctx, x, dim, shards):
        ctx.meta = (dim, shards)
        parts = [torch.empty_like(x) for _ in range(shards.n)]
        dist.all_gather(parts, x.contiguous(), group=shards.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        dim, shards = ctx.meta
        g = g.contiguous().clone()
        dist.all_reduce(g, group=shards.group)
        return shards.keep(g, dim), None, None


class AllSum(torch.autograd.Function):
    """Sum over the processes of ``group`` whose gradient is the sum of
    theirs: each process's result feeds its own downstream work, as
    BatchNorm's batch statistics do."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.contiguous().clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class SumValue(torch.autograd.Function):
    """Sum over the processes of ``group`` whose gradient is the identity:
    every process computes the same scalar (the loss) and backpropagates
    its own share of it, the terms it contributed."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.contiguous().clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


class ScaleGrad(torch.autograd.Function):
    """The identity whose gradient is scaled: a term every process of the
    model axis computes whole (the l2 term of the replicated parameters),
    whose gradients the processes then sum."""

    @staticmethod
    def forward(ctx, t, scale):
        ctx.scale = scale
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of x over the image's pixels, when x holds a shard's: over
    the active mesh's H shards (the JAX loss's mean over the global
    array). Without a mesh, or with the shards in this process (whose
    batch already holds them all), ``torch.mean``."""
    mesh = active_mesh()
    if mesh is None or mesh.model.procs == 1:
        return torch.mean(x)
    total = SumValue.apply(x.sum(), mesh.model.group)
    return total / (x.numel() * mesh.model.procs)


def replicated(t: torch.Tensor) -> torch.Tensor:
    """A term of the loss that every process of the active mesh's model
    axis computes whole: its gradient, summed over them, counts once."""
    mesh = active_mesh()
    if mesh is None or mesh.model.procs == 1:
        return t
    return ScaleGrad.apply(t, 1.0 / mesh.model.procs)
