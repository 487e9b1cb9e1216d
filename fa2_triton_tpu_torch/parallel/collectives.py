"""Every collective of the port's parallel layer, over `torch.distributed`.

The JAX package runs one controller over a `shard_map` mesh and speaks in
`ppermute`, `all_to_all` and `psum`; the port runs SPMD ranks, one process
each, and this module is their only way to talk:

* `ring_shift` / `ring_shift_start`: every rank of a group sends its tensors
  to the next rank and receives the previous rank's (`batch_isend_irecv`);
  the started form returns a handle, so a caller can compute while the hop
  is in flight (ring attention's KV prefetch, JAX `parallel/ring.py:236-241`).
  `ring_pass` is one differentiable hop: its backward sends the cotangent
  one hop the other way (JAX's transpose of `ppermute`; the pipeline's).
* `all_to_all`: JAX's tiled `lax.all_to_all` along a split and a concat dim.
* `all_reduce` (a sum), `broadcast`, `all_gather` along a dim.
* `shard` / `gather`: a replicated tensor's piece on this rank, and back,
  per a spec of axis names (`parallel/mesh.py`).
* Training's conjugates: `copy_to_group` (Megatron's f: the identity
  forward, a sum over the group backward), the partner of `all_reduce`
  (Megatron's g); `reduce_scatter`; `fsdp_gather` (all-gather forward,
  reduce-scatter backward: the weight gradients of data ranks that each
  saw their own batch are summed, and each rank keeps its piece).

The group's backend picks the transport, explicitly (`transport`):
"nccl" sends device tensors direct; "gloo" sends CPU tensors; "host" is a
gloo group holding CUDA tensors, which gloo cannot send or all-to-all, so
each op copies them to host memory, runs there and copies the result back.
The copies and the exchange are timed apart in `STAGING` (ranks that share
one GPU take this transport: NCCL refuses two ranks on one device). The
differentiable forms (`all_to_all`, `all_reduce`, `shard`, `gather`,
`ring_pass`, `copy_to_group`, `fsdp_gather`) are `torch.autograd.Function`s
with the transposed collective as backward.
"""
from __future__ import annotations

import time
from typing import List, Sequence

import torch
import torch.distributed as dist

# Host staging of "host" transports since the last reset: seconds spent
# copying device <-> host and in the gloo exchange, ops and bytes moved.
STAGING = {"copy_s": 0.0, "comm_s": 0.0, "ops": 0, "bytes": 0}


def reset_staging() -> None:
    STAGING.update(copy_s=0.0, comm_s=0.0, ops=0, bytes=0)


def transport(group, tensor: torch.Tensor) -> str:
    """"nccl", "gloo" (CPU tensors) or "host" (CUDA tensors through host
    memory on a gloo group)."""
    backend = str(dist.get_backend(group)).lower()
    if backend == "nccl":
        return "nccl"
    if backend != "gloo":
        raise ValueError(f"the parallel layer takes gloo or nccl groups, got {backend}")
    return "host" if tensor.device.type == "cuda" else "gloo"


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def _to_host(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    if tensors[0].device.type == "cuda":
        # The copy waits for the stream's earlier kernels; wait here, so
        # that STAGING's copy time is the copy's.
        torch.cuda.current_stream(tensors[0].device).synchronize()
    t0 = time.perf_counter()
    out = [t.detach().to("cpu") for t in tensors]
    STAGING["copy_s"] += time.perf_counter() - t0
    STAGING["bytes"] += sum(t.numel() * t.element_size() for t in out)
    return out


def _to_device(tensors: Sequence[torch.Tensor], device) -> List[torch.Tensor]:
    t0 = time.perf_counter()
    out = [t.to(device) for t in tensors]
    STAGING["copy_s"] += time.perf_counter() - t0
    return out


class _Staged:
    """Runs `op(tensors)` (which returns the result tensors) on the
    transport of `group`: on host copies for "host", as they are else."""

    def __init__(self, group, like: torch.Tensor):
        self.host = transport(group, like) == "host"
        self.device = like.device

    def __call__(self, op, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if not self.host:
            return op(list(tensors))
        host = _to_host(tensors)
        t0 = time.perf_counter()
        out = op(host)
        STAGING["comm_s"] += time.perf_counter() - t0
        STAGING["ops"] += 1
        return _to_device(out, self.device)


class ShiftHandle:
    """A ring hop in flight: `wait()` returns the received tensors."""

    def __init__(self, reqs, received, device, host: bool, t0: float):
        self._reqs, self._received, self._device = reqs, received, device
        self._host, self._t0 = host, t0

    def wait(self) -> List[torch.Tensor]:
        for r in self._reqs:
            r.wait()
        if not self._host:
            return self._received
        STAGING["comm_s"] += time.perf_counter() - self._t0
        STAGING["ops"] += 1
        return _to_device(self._received, self._device)


def ring_shift_start(tensors: Sequence[torch.Tensor], group, step: int = 1) -> ShiftHandle:
    """Start one hop of the ring over `group`: rank r's `tensors` go to rank
    (r + step) % n, and the handle's `wait()` returns what rank (r - step)
    % n sent (JAX's `ppermute` with perm [(i, (i + 1) % n)] at step 1). A
    group of one returns the tensors themselves."""
    n = group_size(group)
    tensors = [t.contiguous() for t in tensors]
    if n == 1:
        return ShiftHandle([], tensors, None, False, 0.0)
    host = transport(group, tensors[0]) == "host"
    device = tensors[0].device
    send = _to_host(tensors) if host else tensors
    recv = [torch.empty_like(t) for t in send]
    r = group_rank(group)
    nxt = dist.get_global_rank(group, (r + step) % n)
    prv = dist.get_global_rank(group, (r - step) % n)
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in send]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
    t0 = time.perf_counter()
    reqs = dist.batch_isend_irecv(ops)
    return ShiftHandle(reqs, recv, device, host, t0)


def ring_shift(tensors: Sequence[torch.Tensor], group, step: int = 1) -> List[torch.Tensor]:
    """One hop of the ring, waited for (`ring_shift_start`)."""
    return ring_shift_start(tensors, group, step).wait()


class _RingPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.args = (group, step)
        return ring_shift([x], group, step)[0]

    @staticmethod
    def backward(ctx, g):
        group, step = ctx.args
        return ring_shift([g], group, -step)[0], None, None


def ring_pass(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """One hop of the ring as a differentiable op: x goes to rank (r + step)
    % n, and the result is what rank (r - step) % n sent. The backward sends
    the cotangent back the way the value came (JAX's transpose of
    `ppermute`), so every rank must run it: each rank must use the result
    of every hop whose gradient any rank needs (the pipeline selects with
    `torch.where`, never with a branch on the rank). x itself in a group of
    one."""
    if group_size(group) == 1:
        return x
    return _RingPass.apply(x, group, step)


def _all_to_all_raw(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split "
                         f"into {n}")
    inp = torch.stack(x.chunk(n, dim=split_dim)).contiguous()

    def op(ts):
        out = torch.empty_like(ts[0])
        dist.all_to_all_single(out, ts[0], group=group)
        return [out]

    out = _Staged(group, x)(op, [inp])[0]
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all_raw(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all_raw(g, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """JAX's `lax.all_to_all(x, split_axis, concat_axis, tiled=True)`: x
    splits along `split_dim` into n equal chunks, chunk j goes to rank j,
    and the chunks received are concatenated along `concat_dim` in the
    order of their source rank. Differentiable (the backward swaps the
    dims)."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def _all_reduce_raw(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x

    staged = _Staged(group, x)

    def op(ts):
        t = ts[0] if staged.host else ts[0].clone()   # a host copy is the op's own
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return [t]

    return staged(op, [x.contiguous()])[0]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        # Megatron's g: a sum over the ranks forward, the identity backward
        # (the cotangent of the replicated result is the same on every rank).
        return g, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group's ranks (JAX's `psum`), as a new tensor;
    every rank gets the same bits. Differentiable: the backward is the
    identity (Megatron's row-parallel reduce)."""
    return _AllReduce.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g.contiguous(), ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: x itself forward, the sum of the cotangents over the
    group backward. It marks a replicated tensor that each rank feeds into
    its own shard of a computation (the normed input of the column-parallel
    wq / wk / wv, w_gate / w_up and lm_head; the tokens and routing weights
    of expert parallelism; a stage's replicated input): the replicated
    tensor's gradient is the sum of the shards' parts. x itself without a
    group or in a group of one."""
    if group is None or group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of x over the group's ranks, cut along `dim` into n equal
    pieces, of which rank r keeps piece r (not differentiable)."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not split into {n}")

    def op(ts):
        parts = [c.contiguous() for c in ts[0].chunk(n, dim=dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group)
        return [out]

    return _Staged(group, x)(op, [x.contiguous()])[0]


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """The group's rank `src` (a rank within the group) sends x to every
    rank; returns the received tensor (x itself on `src`)."""
    if group_size(group) == 1:
        return x

    def op(ts):
        t = ts[0].clone()
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
        return [t]

    return _Staged(group, x)(op, [x.contiguous()])[0]


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in rank order."""
    n = group_size(group)
    if n == 1:
        return x

    def op(ts):
        parts = [torch.empty_like(ts[0]) for _ in range(n)]
        dist.all_gather(parts, ts[0], group=group)
        return parts

    return torch.cat(_Staged(group, x)(op, [x.contiguous()]), dim=dim)


def all_gather_ints(values: Sequence[int], group) -> List[List[int]]:
    """Every rank's list of ints (all of one length), in rank order: the
    host-side exchange of the schedulers (CPU tensors, whatever the
    transport of the model's tensors)."""
    x = torch.tensor(list(values), dtype=torch.int64)
    if group_size(group) == 1:
        return [x.tolist()]
    if str(dist.get_backend(group)).lower() == "nccl":
        x = x.cuda()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return [p.tolist() for p in parts]


def shard_slice(size: int, n: int, i: int) -> slice:
    if size % n:
        raise ValueError(f"a dim of {size} does not split over {n} ranks")
    step = size // n
    return slice(i * step, (i + 1) * step)


class _Shard(torch.autograd.Function):
    """Forward: this rank's piece of a replicated tensor. Backward: the
    pieces' cotangents gathered, so the replicated input gets the whole
    gradient on every rank."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        for dim, group in dims:
            x = x[(slice(None),) * dim + (shard_slice(x.shape[dim], group_size(group),
                                                      group_rank(group)),)]
        return x.contiguous()

    @staticmethod
    def backward(ctx, g):
        for dim, group in reversed(ctx.dims):
            g = all_gather(g.contiguous(), group, dim)
        return g, None


class _Gather(torch.autograd.Function):
    """Forward: the pieces gathered into the replicated tensor. Backward:
    this rank's piece of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        for dim, group in reversed(dims):
            x = all_gather(x.contiguous(), group, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        for dim, group in ctx.dims:
            g = g[(slice(None),) * dim + (shard_slice(g.shape[dim], group_size(group),
                                                      group_rank(group)),)]
        return g.contiguous(), None


class _FsdpGather(_Gather):
    """Forward: `_Gather`'s. Backward: the cotangent reduce-scattered,
    because each rank's cotangent is its own part of the gradient (its own
    batch), not a replica of one."""

    @staticmethod
    def backward(ctx, g):
        for dim, group in ctx.dims:
            g = reduce_scatter(g, group, dim)
        return g, None


def _spec_dims(spec, groups) -> tuple:
    """((dim, group), ...) of the dims a spec shards over groups of more
    than one rank; `groups` maps an axis name to its group."""
    return tuple((d, groups[a]) for d, a in enumerate(spec)
                 if a is not None and group_size(groups[a]) > 1)


def shard(x: torch.Tensor, spec, groups) -> torch.Tensor:
    """This rank's piece of x, replicated on every rank: each dim named by
    an axis in `spec` (a tuple of axis names or None per dim, as
    `parallel/mesh.py` writes PartitionSpecs) is cut by that axis's group
    size at this rank's index. Differentiable."""
    return _Shard.apply(x, _spec_dims(spec, groups))


def gather(x: torch.Tensor, spec, groups) -> torch.Tensor:
    """The inverse of `shard`: every rank gets the whole tensor.
    Differentiable: the backward keeps this rank's piece of a cotangent that
    every rank holds whole (a replicated loss)."""
    return _Gather.apply(x, _spec_dims(spec, groups))


def fsdp_gather(x: torch.Tensor, spec, groups) -> torch.Tensor:
    """FSDP's gather of a weight's pieces: forward as `gather`, backward a
    reduce-scatter, so each rank's piece gets the sum over the group of the
    whole weight's gradients (each data rank's own batch). The sum is not
    divided: the mean over the data ranks is the loss's business."""
    dims = _spec_dims(spec, groups)
    return _FsdpGather.apply(x, dims) if dims else x
