"""Sequence parallelism: ring attention + Ulysses all-to-all attention,
and dense attention, the reference both are held against.

Counterpart of the JAX package's `parallel/ring_attention.py`, run SPMD
over `torch.distributed`: every rank of the mesh axis calls the function
with its LOCAL sequence block — q, k, v (B, S/n, H, D), rank i holding
positions i*S/n .. (i+1)*S/n - 1 — and gets its local block of the
output back, (B, S/n, H, D) f32.  Inputs and outputs are local blocks,
not DTensors: the caller holds its block, as a rank does.

- `ring_attention`: K/V blocks rotate around the axis with
  `batch_isend_irecv` (the next block is in flight while the current one
  computes) while each rank folds its queries' attention block by block.
  When the local block takes the flash kernel (`kernel_ok`), each block
  is B4 (`ops.attention_kernels.flash_attention_fwd`), whose logsumexp
  [B*H, S] is the merge statistic (`_merge_normalized`); between blocks
  causality is static per relation — a block behind the queries is
  fully visible, the diagonal block takes the kernel's causal mask, a
  block ahead is skipped.  Its backward is the dense-ring recompute, as
  the JAX package's custom VJP: autograd through `_ring_dense`, whose
  rotation (`_Rotate`) sends gradients the other way round the ring.
  Shapes the kernel rule rejects take `_ring_dense` for the forward too.
- `ulysses_attention`: two `all_to_all`s reshard (S/n, H) -> (S, H/n),
  `fused_attention` runs on full sequences per head shard (B4 forward,
  B5/B6 backward), and the result reshards back; heads must divide by
  the axis size.

Both are exact: they match `full_attention` to float tolerance.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["full_attention", "attention_with_lse", "ring_attention",
           "ulysses_attention", "ring_block_step"]


def attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`full_attention` and the per-row logsumexp of its scaled scores,
    [B*H, Sq] f32 (the residual the flash backward reads)."""
    d = q.shape[-1]
    # the matmuls run at the input dtype with f32 accumulation: a product
    # of two bf16 values is exact in f32, so widening the inputs first is
    # that product (up to the order of the sums)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    b, h, sq = s.shape[:3]
    return out, torch.logsumexp(s, dim=-1).reshape(b * h, sq)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """Reference dense attention.  q, k, v: (B, S, H, D) -> (B, S, H, D) f32.

    Both matmuls run at the input dtype with f32 accumulation, the
    softmax statistics are f32, and the probabilities are cast to v's
    dtype before the PV product, as in the JAX package.  The causal mask
    is `tril`: query i sees keys <= i."""
    return attention_with_lse(q, k, v, causal)[0]


# ---------------------------------------------------------------- blocks

def _block_accumulate(q, k_blk, v_blk, o, m, l, q_off: int, k_off: int,
                      causal: bool):
    """Online-softmax accumulation of one K/V block into (o, m, l), dense.

    q: (B, Sq, H, D) local queries at global offset q_off; k_blk/v_blk:
    (B, Sk, H, D) at global offset k_off.  o: (B, Sq, H, D) f32
    unnormalized; m, l: (B, H, Sq) running max / normalizer."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) / \
        math.sqrt(d)
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=q.device)
        kpos = k_off + torch.arange(k_blk.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = s.masked_fill(~mask[None, None], float("-inf"))
    m_blk = s.amax(dim=-1)                           # (B, H, Sq)
    m_new = torch.maximum(m, m_blk)
    # fully-masked rows give -inf maxima; keep exp() finite
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                       torch.zeros_like(m))
    fin = torch.isfinite(s)
    p = torch.where(fin, torch.exp(torch.where(fin, s, 0.0)
                                   - m_safe[..., None]), 0.0)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p.to(v_blk.dtype).float(), v_blk.float())
    return o_new, m_new, l_new


def _merge_normalized(o, m, l, o_b, lse_b):
    """Fold one NORMALIZED attention block (o_b, lse_b) into the running
    (o, m, l) online-softmax carry: a normalized block is a weighted
    value with scalar log-weight lse_b per row — the same algebra as
    `_block_accumulate`, so dense and flash steps mix freely."""
    m_new = torch.maximum(m, lse_b)
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                       torch.zeros_like(m))
    w = torch.where(torch.isfinite(lse_b), torch.exp(lse_b - m_safe),
                    torch.zeros_like(lse_b))
    o_new = (o * corr.transpose(1, 2)[..., None]
             + o_b * w.transpose(1, 2)[..., None])
    return o_new, m_new, l * corr + w


def ring_block_step(q, k_blk, v_blk, o, m, l, q_off: int, k_off: int,
                    causal: bool):
    """The ring's per-block step on the flash path: B4 over (q, block)
    and the logsumexp merge into (o, m, l).  Causal: a block behind the
    queries (k_off < q_off) runs unmasked, the diagonal block (equal
    offsets, equal block sizes) runs the kernel's causal mask, a block
    ahead is skipped — no launch, the carry unchanged."""
    from ..ops.attention_kernels import flash_attention_fwd

    if causal and k_off > q_off:
        return o, m, l
    blk_causal = causal and k_off == q_off
    b, s_loc, h, _ = q.shape
    o_b, lse = flash_attention_fwd(q, k_blk, v_blk, blk_causal)
    return _merge_normalized(o, m, l, o_b, lse.reshape(b, h, s_loc))


# ------------------------------------------------------------------ ring

def _resolve_axis(mesh, axis: Optional[str]) -> str:
    """Default to the mesh's 'seq' axis when it is populated; else 'data'
    so an all-data mesh still works."""
    if axis is not None:
        return axis
    names = mesh.mesh_dim_names
    if "seq" in names and mesh.size(names.index("seq")) > 1:
        return "seq"
    return "data"


class _Axis:
    """One mesh axis as the ring sees it: its group, size, this rank's
    index on it and the global ranks of its neighbours."""

    def __init__(self, mesh, axis: str):
        import torch.distributed as dist

        names = mesh.mesh_dim_names
        self.group = mesh.get_group(axis)
        self.n = mesh.size(names.index(axis))
        self.idx = mesh.get_local_rank(axis)
        self.next = dist.get_global_rank(self.group, (self.idx + 1) % self.n)
        self.prev = dist.get_global_rank(self.group, (self.idx - 1) % self.n)


def _exchange(x: torch.Tensor, send_to: int, recv_from: int, group):
    """Start sending `x` and receiving its peer's like-shaped tensor;
    returns (buffer, works) — wait on the works before reading it."""
    import torch.distributed as dist

    buf = torch.empty_like(x)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, send_to, group),
        dist.P2POp(dist.irecv, buf, recv_from, group)])
    return buf, works


class _Rotate(torch.autograd.Function):
    """The ring's hop: send to the next rank, receive from the previous;
    its gradient goes the other way round."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        buf, works = _exchange(x.contiguous(), ax.next, ax.prev, ax.group)
        for w in works:
            w.wait()
        return buf

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        buf, works = _exchange(g.contiguous(), ax.prev, ax.next, ax.group)
        for w in works:
            w.wait()
        return buf, None


def _finish(o, l):
    return o / l.clamp(min=1e-20).transpose(1, 2)[..., None]


def _init_carry(q):
    b, s_loc, h, _ = q.shape
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    return o, m, l


def _ring_dense(q, k, v, ax: _Axis, causal: bool):
    """The dense-block ring, differentiable: K and V travel stacked, one
    chain of `_Rotate`s, so every rank runs the same hops in the same
    order forward and backward."""
    s_loc = q.shape[1]
    o, m, l = _init_carry(q)
    kv = torch.stack([k, v])
    for r in range(ax.n):
        k_off = ((ax.idx - r) % ax.n) * s_loc
        o, m, l = _block_accumulate(q, kv[0], kv[1], o, m, l,
                                    ax.idx * s_loc, k_off, causal)
        if r + 1 < ax.n:
            kv = _Rotate.apply(kv, ax)
    return _finish(o, l)


def _ring_flash_fwd(q, k, v, ax: _Axis, causal: bool):
    """The flash ring forward: the next K/V block is in flight while the
    current one runs `ring_block_step`."""
    s_loc = q.shape[1]
    o, m, l = _init_carry(q)
    kv = torch.stack([k, v])
    for r in range(ax.n):
        works = ()
        if r + 1 < ax.n:
            nxt, works = _exchange(kv, ax.next, ax.prev, ax.group)
        k_off = ((ax.idx - r) % ax.n) * s_loc
        o, m, l = ring_block_step(q, kv[0], kv[1], o, m, l, ax.idx * s_loc,
                                  k_off, causal)
        for w in works:
            w.wait()
        if works:
            kv = nxt
    return _finish(o, l)


class _RingFlash(torch.autograd.Function):
    """Flash-forward ring with the dense-ring recompute as backward."""

    @staticmethod
    def forward(ctx, q, k, v, ax, causal):
        ctx.ax, ctx.causal = ax, causal
        ctx.save_for_backward(q, k, v)
        return _ring_flash_fwd(q, k, v, ax, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _ring_dense(q, k, v, ctx.ax, ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


def ring_attention(q, k, v, mesh, axis: Optional[str] = None,
                   causal: bool = False):
    """Exact attention with the sequence sharded over `axis` of `mesh`
    (a DeviceMesh or a MeshPlan; default axis: 'seq' if populated, else
    'data').  q, k, v are this rank's (B, S/n, H, D) blocks; returns this
    rank's (B, S/n, H, D) f32 block.

    When the local block takes the flash kernel (`kernel_ok`), each ring
    step runs B4 and blocks merge by their logsumexp; otherwise the
    dense-block ring runs.  Differentiable either way (the dense-ring
    recompute is the backward)."""
    from ..ops.attention_kernels import kernel_ok
    from .mesh import as_device_mesh

    mesh = as_device_mesh(mesh)
    ax = _Axis(mesh, _resolve_axis(mesh, axis))
    if kernel_ok(q):
        return _RingFlash.apply(q, k, v, ax, causal)
    return _ring_dense(q, k, v, ax, causal)


# --------------------------------------------------------------- Ulysses

def _all_to_all(x: torch.Tensor, group, n: int) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, x, group=group)
    return out


def _scatter_heads(x, group, n):
    """(B, S/n, H, D) -> (B, S, H/n, D): send head chunk j to rank j,
    receive sequence block j from rank j."""
    b, s, h, d = x.shape
    send = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    recv = _all_to_all(send, group, n)            # [n(seq block), B, S/n, H/n, D]
    return recv.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _gather_seq(x, group, n):
    """(B, S, H/n, D) -> (B, S/n, H, D), the inverse of `_scatter_heads`."""
    b, s, hl, d = x.shape
    send = x.reshape(b, n, s // n, hl, d).permute(1, 0, 2, 3, 4)
    recv = _all_to_all(send, group, n)            # [n(head chunk), B, S/n, H/n, D]
    return recv.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hl, d)


class _ScatterHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _scatter_heads(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group, ctx.n), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _gather_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter_heads(g, ctx.group, ctx.n), None, None


def ulysses_attention(q, k, v, mesh, axis: Optional[str] = None,
                      causal: bool = False):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses construction).

    q, k, v are this rank's (B, S/n, H, D) blocks.  Heads must divide by
    the axis size: reshard (S/n, H) ->
    (S, H/n), run `fused_attention` on full sequences per head shard
    (dense `full_attention` for shapes the kernel rule rejects), reshard
    back.  Returns this rank's (B, S/n, H, D) f32 block."""
    from ..ops.attention_kernels import fused_attention, kernel_ok
    from .mesh import as_device_mesh

    mesh = as_device_mesh(mesh)
    axis = _resolve_axis(mesh, axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if q.shape[2] % n:
        raise ValueError(f"heads {q.shape[2]} not divisible by axis size {n}")
    group = mesh.get_group(axis)
    qg, kg, vg = (_ScatterHeads.apply(x, group, n) for x in (q, k, v))
    attn = fused_attention if kernel_ok(qg) else full_attention
    og = attn(qg, kg, vg, causal)
    return _GatherSeq.apply(og, group, n)
