"""Ring (sequence-parallel) attention, forward and backward (port of
`fa2_triton_tpu/parallel/ring.py`).

The sequence is sharded over the mesh's `seq` axis, one shard a rank. Each
rank attends its query shard to the K/V shard it holds while K/V travel
the ring one hop a step (`parallel/collectives.py:ring_shift_start`, the
next hop started before this one's kernels run), and the per-chunk partials
merge by the kernels' own online-softmax rule on base-2 LSEs (`_merge`):

    m'   = max(m, lse_c)
    acc' = acc * exp2(m - m') + o_c * exp2(lse_c - m')
    l'   = l   * exp2(m - m') +        exp2(lse_c - m')

Causal rings default to the zigzag layout: the sequence splits into 2n
chunks and rank i holds the pair (i, 2n-1-i), so every rank does about the
same work at every hop. A diagonal chunk pair (equal global offsets) is a
causal call with a static shift of 0, which the forward and backward route
to their causal schedules at the real lengths (`ops/flash_fwd.py:
forward_route`, `ops/flash_bwd.py:backward_route`); a strictly-past pair
is a call with no mask at all. Every call carries the global `q_off` /
`kv_off` and the global lengths, so dropout draws the single-device
counter stream and windows see true positions.

q is multiplied by softmax_scale * log2(e) once, rounded to its dtype, and
every forward chunk takes it `q_prescaled` (JAX l.222-223). The backward
recomputes per pair from the global LSE: dq stays on its rank, while
(k, v) and the dk / dv accumulators travel the ring, the accumulators one
hop behind their chunk (JAX l.311-319), and one last hop takes each home.
The LSE output is differentiable: its cotangent reaches every pair's delta
(`flash_attn_backward(dlse=...)`), zeroed on rows whose lse or dlse is not
finite (JAX l.430-432).

The port's kernels take head dims 64, 128 and 256 as they are, so the ring
pads nothing (JAX pads D to 128 lanes, l.218-221).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd
from fa2_triton_tpu_torch.ops.attention import resolve_dropout_seed
from fa2_triton_tpu_torch.ops.tuning import BlockSizes, choose_block_sizes
from fa2_triton_tpu_torch.parallel import collectives as coll
from fa2_triton_tpu_torch.parallel.mesh import (
    AXIS_DATA, AXIS_MODEL, AXIS_SEQ, axis_groups, axis_size,
)
from fa2_triton_tpu_torch.utils import LOG2E, default_softmax_scale

MASK_LOG2 = -1e30   # the kernels' running-max start (JAX ops/flash_fwd.py MASK_LOG2)


@dataclass(frozen=True)
class RingConfig:
    group: object            # the seq axis's process group
    causal: bool
    softmax_scale: Optional[float]
    window: Tuple[int, int] = (-1, -1)
    dropout_p: float = 0.0
    # Zigzag chunk layout (causal only): rank i holds chunks (i, 2n-1-i) of
    # 2n; `make_ring_attention` permutes and unpermutes.
    zigzag: bool = False


def _merge(m, l, acc, o_c, lse_c):
    m_new = torch.maximum(m, lse_c)
    w_old = torch.exp2(m - m_new)
    w_c = torch.exp2(lse_c - m_new)
    return m_new, l * w_old + w_c, acc * w_old + o_c.float() * w_c


def zigzag_permute(x: torch.Tensor, n: int, dim: int = 1) -> torch.Tensor:
    """Reorder a global sequence so that a contiguous split into n shards
    gives rank i the chunk pair (i, 2n-1-i) of 2n equal chunks."""
    if x.shape[dim] % (2 * n):
        raise ValueError(f"seqlen {x.shape[dim]} must divide into 2*{n} chunks")
    chunks = x.chunk(2 * n, dim=dim)
    return torch.cat([c for i in range(n) for c in (chunks[i], chunks[2 * n - 1 - i])], dim=dim)


def zigzag_unpermute(x: torch.Tensor, n: int, dim: int = 1) -> torch.Tensor:
    parts = x.chunk(2 * n, dim=dim)
    out = [None] * (2 * n)
    for i in range(n):
        out[i] = parts[2 * i]
        out[2 * n - 1 - i] = parts[2 * i + 1]
    return torch.cat(out, dim=dim)


def _needed(cfg: RingConfig, q_chunk: int, kv_chunk: int, C: int) -> bool:
    """Is the chunk pair (q_chunk, kv_chunk) inside the mask band? (JAX
    l.185-197)"""
    need = True
    if cfg.causal:
        need = kv_chunk <= q_chunk
    if cfg.window[0] >= 0:
        # The kv chunk ends before the window's left edge.
        need = need and (kv_chunk + 1) * C - 1 >= q_chunk * C - cfg.window[0]
    if cfg.window[1] >= 0 and not cfg.causal:
        need = need and kv_chunk * C <= (q_chunk + 1) * C - 1 + cfg.window[1]
    return need


def _halves(cfg: RingConfig, x: torch.Tensor, n: int, idx: int):
    """A local tensor's zigzag halves along dim 2 (views: the rows of a
    BHSD tensor, of a [B, H, S] lse) with their global chunk ids, and the
    chunk length."""
    if not cfg.zigzag:
        return [(x, idx)], x.shape[2]
    C = x.shape[2] // 2
    return [(x[:, :, :C], idx), (x[:, :, C:], 2 * n - 1 - idx)], C


def _pair_mode(cfg: RingConfig, diag: bool):
    """(causal, static_skip) of one chunk pair's kernel call (JAX
    l.161-169): a window needs true relative positions and keeps its
    dynamic mask; a diagonal causal pair takes the static causal schedules;
    a strictly-past pair is unmasked."""
    if cfg.window != (-1, -1):
        return cfg.causal, False
    if diag and cfg.causal:
        return True, True
    return False, False


def _blocks(C: int, D: int, dtype_bytes: int, causal: bool) -> BlockSizes:
    """JAX's blocks for a chunk call (l.157-159), cut to the chunk (a
    multiple of 128): the padded shape the routing gates read is C itself.
    D is padded to 128 lanes as JAX pads it."""
    b = choose_block_sizes(C, C, -(-D // 128) * 128, dtype_bits=8 * dtype_bytes, causal=causal)
    return BlockSizes(block_q=min(b.block_q, C), block_kv=min(b.block_kv, C),
                      block_q_bwd=min(b.block_q_bwd, C), block_kv_bwd=min(b.block_kv_bwd, C),
                      unroll_kv=b.unroll_kv, unroll_bwd=b.unroll_bwd)


def _lens(B: int, S_tot: int, device) -> torch.Tensor:
    return torch.full((B, 2), S_tot, dtype=torch.int32, device=device)


def _ring_forward(cfg: RingConfig, q, k, v, seed: int):
    """One rank's forward on its shard q [B, S_loc, Hq, D], k / v
    [B, S_loc, Hkv, D]. Returns (out BSHD like q, lse [B, Hq, S_loc] fp32,
    base 2)."""
    B, S_loc, Hq, D = q.shape
    n, idx = coll.group_size(cfg.group), coll.group_rank(cfg.group)
    scale = cfg.softmax_scale if cfg.softmax_scale is not None else default_softmax_scale(D)
    S_tot = n * S_loc
    lens = _lens(B, S_tot, q.device)
    # The scale * log2(e) fold, once for every chunk, rounded to q's dtype.
    qT = (q.float() * (scale * LOG2E)).to(q.dtype).transpose(1, 2)
    q_halves, C = _halves(cfg, qT, n, idx)
    # (m, l, acc) per q half: [B, Hq, C, 1], [B, Hq, C, 1], [B, Hq, C, D].
    states = [(torch.full((B, Hq, C, 1), MASK_LOG2, device=q.device),
               torch.zeros((B, Hq, C, 1), device=q.device),
               torch.zeros((B, Hq, C, D), device=q.device)) for _ in q_halves]
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for step in range(n):
        # The next hop's K/V start before this hop's kernels.
        nxt = coll.ring_shift_start([k_cur, v_cur], cfg.group) if step != n - 1 else None
        src = (idx - step) % n
        kv_halves, _ = _halves(cfg, k_cur.transpose(1, 2), n, src)
        v_halves, _ = _halves(cfg, v_cur.transpose(1, 2), n, src)
        for qi, (q_h, qc) in enumerate(q_halves):
            for (k_h, kc), (v_h, _) in zip(kv_halves, v_halves):
                if not _needed(cfg, qc, kc, C):
                    continue
                causal, static_skip = _pair_mode(cfg, kc == qc)
                o_c, lse_c = flash_fwd.flash_attn_forward(
                    q_h, k_h, v_h, lens, qc * C, kc * C, causal=causal, softmax_scale=scale,
                    window=cfg.window, dropout_p=cfg.dropout_p, dropout_seed=seed,
                    seqlen_q_real=S_tot, seqlen_k_real=S_tot, static_skip=static_skip,
                    block_sizes=_blocks(C, D, q.element_size(), causal and static_skip),
                    q_prescaled=True)
                states[qi] = _merge(*states[qi], o_c, lse_c[..., None])
        if nxt is not None:
            k_cur, v_cur = nxt.wait()
    outs, lses = [], []
    for m, l, acc in states:
        l_inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
        outs.append((acc * l_inv).to(q.dtype))
        lses.append((m + torch.log2(torch.clamp(l, min=0.0)))[..., 0])   # -inf on dead rows
    out = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
    lse = torch.cat(lses, dim=2) if len(lses) > 1 else lses[0]
    return out.transpose(1, 2).contiguous(), lse


def _ring_backward(cfg: RingConfig, q, k, v, out, lse, do, dlse, seed: int):
    """One rank's backward: (dq, dk, dv) of its shard. dq accumulates here;
    (k, v) travel the ring with the dk / dv accumulators one hop behind
    (the hop of step s carries the folds of step s - 1), and a last hop
    delivers each accumulator to the rank that holds its chunk."""
    B, S_loc, Hq, D = q.shape
    n, idx = coll.group_size(cfg.group), coll.group_rank(cfg.group)
    scale = cfg.softmax_scale if cfg.softmax_scale is not None else default_softmax_scale(D)
    S_tot = n * S_loc
    lens = _lens(B, S_tot, q.device)
    qT, oT, doT = (x.contiguous().transpose(1, 2) for x in (q, out, do))
    q_halves, C = _halves(cfg, qT, n, idx)
    o_halves, _ = _halves(cfg, oT, n, idx)
    do_halves, _ = _halves(cfg, doT, n, idx)
    # lse / dlse [B, Hq, S_loc] split along dim 2 as the BHSD tensors do.
    lse_halves = [x for x, _ in _halves(cfg, lse, n, idx)[0]]
    dlse_halves = ([x for x, _ in _halves(cfg, dlse, n, idx)[0]] if dlse is not None
                   else [None] * len(q_halves))
    dq_halves = [torch.zeros((B, Hq, C, D), device=q.device) for _ in q_halves]
    Hkv = k.shape[2]
    acc_dk = torch.zeros((B, S_loc, Hkv, D), device=q.device)
    acc_dv = torch.zeros_like(acc_dk)
    pend_dk = pend_dv = None
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for step in range(n):
        # Last step's folds ride this hop while this step's kernels run.
        acc_hop = (coll.ring_shift_start([acc_dk + pend_dk, acc_dv + pend_dv], cfg.group)
                   if step > 0 else None)
        nxt = coll.ring_shift_start([k_cur, v_cur], cfg.group) if step != n - 1 else None
        pend_dk, pend_dv = torch.zeros_like(acc_dk), torch.zeros_like(acc_dv)
        src = (idx - step) % n
        kv_halves, _ = _halves(cfg, k_cur.transpose(1, 2), n, src)
        v_halves, _ = _halves(cfg, v_cur.transpose(1, 2), n, src)
        for qi, (q_h, qc) in enumerate(q_halves):
            for kj, ((k_h, kc), (v_h, _)) in enumerate(zip(kv_halves, v_halves)):
                if not _needed(cfg, qc, kc, C):
                    continue
                causal, static_skip = _pair_mode(cfg, kc == qc)
                dq_c, dk_c, dv_c = flash_bwd.flash_attn_backward(
                    q_h, k_h, v_h, do_halves[qi][0], o_halves[qi][0], lse_halves[qi], lens,
                    qc * C, kc * C, causal=causal, softmax_scale=scale, window=cfg.window,
                    dlse=dlse_halves[qi],
                    dropout_p=cfg.dropout_p, dropout_seed=seed, seqlen_q_real=S_tot,
                    seqlen_k_real=S_tot, static_skip=static_skip,
                    block_sizes=_blocks(C, D, q.element_size(), causal))
                dq_halves[qi] += dq_c.float()
                rows = slice(kj * C, (kj + 1) * C) if cfg.zigzag else slice(None)
                pend_dk[:, rows] += dk_c.float().transpose(1, 2)
                pend_dv[:, rows] += dv_c.float().transpose(1, 2)
        if acc_hop is not None:
            acc_dk, acc_dv = acc_hop.wait()
        if nxt is not None:
            k_cur, v_cur = nxt.wait()
    dk, dv = coll.ring_shift([acc_dk + pend_dk, acc_dv + pend_dv], cfg.group)
    dq = torch.cat(dq_halves, dim=2) if len(dq_halves) > 1 else dq_halves[0]
    return dq.transpose(1, 2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttn(torch.autograd.Function):
    """(out, lse) = ring attention of the shards (q, k, v); differentiable
    in both outputs."""

    @staticmethod
    def forward(ctx, q, k, v, cfg, seed):
        out, lse = _ring_forward(cfg, q, k, v, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg, ctx.seed = cfg, seed
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dlse is not None:
            # Dead rows (lse -inf) and non-finite cotangents reach no delta.
            dlse = torch.where(torch.isfinite(lse) & torch.isfinite(dlse), dlse,
                               torch.zeros_like(dlse))
        if do is None:
            do = torch.zeros_like(out)
        dq, dk, dv = _ring_backward(ctx.cfg, q, k, v, out, lse, do, dlse, ctx.seed)
        return dq, dk, dv, None, None


def shared_dropout_seed(dropout_p: float, dropout_seed, dropout_rng, group=None) -> int:
    """The seed contract of `flash_attn_func` (`ops/attention.py:
    resolve_dropout_seed`) for a group of ranks: a seed drawn from
    `dropout_rng` is the group's first rank's, broadcast, so every rank
    draws one mask stream (each rank still draws, keeping its generator in
    step with the others')."""
    seed = resolve_dropout_seed(dropout_p, dropout_seed, dropout_rng)
    if dropout_p > 0.0 and dropout_seed is None:
        import torch.distributed as dist

        g = group if group is not None else dist.group.WORLD
        seed = int(coll.broadcast(torch.tensor([seed], dtype=torch.int64), g)[0])
    return seed


def ring_attention_local(
    q: torch.Tensor,   # [B, S_loc, Hq, D] this rank's shard
    k: torch.Tensor,   # [B, S_loc, Hkv, D]
    v: torch.Tensor,
    *,
    group,
    causal: bool,
    softmax_scale: Optional[float] = None,
    window: Tuple[int, int] = (-1, -1),
    dropout_p: float = 0.0,
    zigzag: bool = False,
    return_lse: bool = False,
    dropout_seed: Optional[int] = None,
    dropout_rng: Optional[torch.Generator] = None,
):
    """Differentiable ring attention of this rank's shard over `group` (the
    seq axis's process group); every rank of the group calls it together.
    With zigzag=True the shard must already hold the chunk pair layout
    (`make_ring_attention` permutes globally). With dropout_p > 0, exactly
    one of `dropout_seed` (the same on every rank) or `dropout_rng` (the
    group's first rank's draw is used). Returns out [B, S_loc, Hq, D], and
    lse [B, Hq, S_loc] (base 2) with `return_lse`."""
    cfg = RingConfig(group=group, causal=causal, softmax_scale=softmax_scale,
                     window=tuple(window), dropout_p=dropout_p, zigzag=zigzag)
    rows = 256 if zigzag else 128
    if q.shape[1] % rows:
        raise ValueError(f"ring shards must be multiples of {rows} rows (chunks of a multiple "
                         f"of 128), got {q.shape[1]}")
    seed = shared_dropout_seed(dropout_p, dropout_seed, dropout_rng, group)
    out, lse = _RingAttn.apply(q, k, v, cfg, seed)
    return (out, lse) if return_lse else out


def make_ring_attention(
    mesh,
    *,
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    seq_axis: str = AXIS_SEQ,
    window: Tuple[int, int] = (-1, -1),
    dropout_p: float = 0.0,
    zigzag: Optional[bool] = None,
    return_lse: bool = False,
    dropout_seed: Optional[int] = None,
):
    """Returns a differentiable fn(q, k, v, dropout_rng=None) over GLOBAL
    [B, S, H, D] tensors, the same on every rank of `mesh` (a
    `make_mesh` DeviceMesh): each rank takes its (data, seq, model) piece,
    runs `ring_attention_local` over the seq group and gathers the output,
    so every rank returns the whole out (and lse [B, H, S] with
    `return_lse`). Causal rings default to the zigzag layout, applied and
    undone here, when the chunks S / (2n) are multiples of 128; otherwise
    the contiguous one (JAX l.506-508). The dropout seed follows
    `flash_attn_func`'s contract: `dropout_seed` here, or a CPU generator
    per call as `dropout_rng`, whose draw on the first rank every rank
    uses. The mask is the single-device one over a seq-only mesh; where the
    data or model axis cuts the batch or the heads, each rank's calls count
    its local batch rows and heads, as JAX's shard_map does."""
    n = axis_size(mesh, seq_axis)
    groups = axis_groups(mesh)
    spec = (AXIS_DATA, seq_axis, AXIS_MODEL, None)
    lse_spec = (AXIS_DATA, AXIS_MODEL, seq_axis)

    def fn(q, k, v, dropout_rng=None):
        S = q.shape[1]
        zz_ok = S % (2 * n) == 0 and (S // (2 * n)) % 128 == 0
        use_zigzag = (causal and n > 1 and zz_ok) if zigzag is None else (zigzag and zz_ok)
        seed = shared_dropout_seed(dropout_p, dropout_seed, dropout_rng)
        if use_zigzag:
            q, k, v = (zigzag_permute(x, n, dim=1) for x in (q, k, v))
        out, lse = ring_attention_local(
            *(coll.shard(x, spec, groups) for x in (q, k, v)), group=groups[seq_axis],
            causal=causal, softmax_scale=softmax_scale, window=window, dropout_p=dropout_p,
            zigzag=use_zigzag, return_lse=True, dropout_seed=seed)
        out, lse = coll.gather(out, spec, groups), coll.gather(lse, lse_spec, groups)
        if use_zigzag:
            out, lse = zigzag_unpermute(out, n, dim=1), zigzag_unpermute(lse, n, dim=2)
        return (out, lse) if return_lse else out

    return fn
