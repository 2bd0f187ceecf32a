"""Ring attention: exact attention over a sequence-sharded mesh axis.

Port of ``kungfu_tpu/parallel/ring.py``.  Q stays local, K/V blocks
rotate around the ``sp`` ring by
:func:`~kungfu_tpu_torch.ops.collective.ppermute` while an online-softmax
accumulator folds each block in.  ``block_impl`` picks the per-round
block: the flash kernels merged across rounds by lse (``flash``), or a
plain online-softmax fold (``einsum``); ``auto`` is flash on CUDA
tensors and einsum on CPU ones, the reference's TPU / non-TPU split with
the card in the TPU's place.

The port's ranks run in lockstep over the stacked rank axis of the
current :func:`~kungfu_tpu_torch.ops.collective.rank_world`: q, k and v
are ``[n, B, H, S_local, D]``, each rank's row its own sequence shard,
and one round runs for every rank at once.  Where the reference's ranks
each take one branch of a ``lax.switch`` (a causal round is masked, full
or diagonal, from the rotating block's index against the rank's own),
the port partitions the ranks' rows by branch: the full rows go through
one flash launch with ``causal=False``, the diagonal rows through one
with ``causal=True``, and the masked rows get zeros and a ``-inf`` lse
without a launch.  Each round's lse enters the merge, so the flash
backward runs with a non-zero lse cotangent (``delta -= dlse``).

Differentiable: autograd through the rounds, where the rotation's
gradient is the inverse rotation — the ring-attention backward schedule.
Outside a rank world the inputs are one rank's ``[B, H, S, D]`` and the
ring has one block.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from kungfu_tpu_torch.ops import collective as coll


def ring_attention(q, k, v, causal: bool = True, axis: str = "sp",
                   block_impl: str = "auto",
                   kv_gather: Optional[str] = None):
    """q, k, v: ``[n, B, H, S_local, D]`` stacked over the ranks of the
    current world (the sequence sharded over ``axis``), or one rank's
    ``[B, H, S, D]`` outside a world.  Returns the exact softmax
    attention output, shaped as q, as if the whole sequence were on one
    rank.

    ``block_impl``: ``einsum`` (one ``[S_local, S_local]`` f32 logits
    tile a round), ``flash`` (the flash kernels through
    :func:`~kungfu_tpu_torch.ops.cuda.attention.flash_attention_with_lse`,
    their plain versions on CPU tensors; causal rounds that are fully
    masked launch nothing) or ``auto`` (flash on CUDA, einsum on the
    CPU).

    ``kv_gather`` swaps the rotation for one all-gather of K and V up
    front (:func:`~kungfu_tpu_torch.ops.schedules.all_gather_flat`:
    ``"pallas_ring"`` rides the ring kernels, ``"lax"`` a plain copy),
    whose backward reduce-scatters dK/dV; ``None`` keeps the rotation."""
    if block_impl not in ("auto", "flash", "einsum"):
        raise ValueError(f"unknown block_impl {block_impl!r}")
    if coll.current_world() is None:
        with coll.rank_world([(axis, 1)]):
            return ring_attention(q[None], k[None], v[None], causal, axis,
                                  block_impl, kv_gather)[0]
    if kv_gather is not None:
        if block_impl == "flash":
            # the gathered path is one masked einsum block: an explicit
            # flash request would be downgraded silently
            raise ValueError(
                "kv_gather is einsum-block attention and cannot honor "
                "block_impl='flash'; use the ppermute rotation "
                "(kv_gather=None) for the flash path")
        from kungfu_tpu_torch.ops.schedules import FLAT_SCHEDULES

        if kv_gather not in FLAT_SCHEDULES:
            raise ValueError(
                f"unknown kv_gather {kv_gather!r}; one of {FLAT_SCHEDULES}"
                " (or None for the ppermute rotation)")
        return _ring_kv_gather(q, k, v, causal, axis, kv_gather)
    if block_impl == "flash" or (block_impl == "auto"
                                 and q.device.type == "cuda"):
        return _ring_flash(q, k, v, causal, axis)
    return _ring_einsum(q, k, v, causal, axis)


def _rotate(kv, axis: str, n_sp: int):
    """Each rank receives the next rank's block: ``[(j+1) % n, j]``."""
    return coll.ppermute(kv, axis, [((j + 1) % n_sp, j) for j in range(n_sp)])


def _blocks(axis: str) -> List[int]:
    """Each rank's own block index along ``axis`` (host ints)."""
    return coll.peer_rank(axis).tolist()


def _ring_kv_gather(q, k, v, causal: bool, axis: str, schedule: str):
    """Gathered-K/V block attention: one all-gather of K and V over
    ``axis``, then one masked online-softmax block per rank; exact, and
    the gather's backward reduce-scatters dK/dV to their owners."""
    from kungfu_tpu_torch.ops.schedules import all_gather_flat

    n_sp = coll.peer_size(axis)
    N, B, H, S, D = q.shape

    def gather(t):
        flat = all_gather_flat(t.reshape(N, -1), [axis], schedule=schedule)
        # mesh-major rows = ring order: rank j's [B, H, S, D] block
        return flat.reshape(N, n_sp, B, H, S, D).movedim(1, 3).reshape(
            N, B, H, n_sp * S, D)

    kf = gather(k).float()
    vf = gather(v).float()
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("nbhqd,nbhkd->nbhqk", q.float() * scale, kf)
    mask = None
    if causal:
        my = coll.axis_index(axis, q.device)
        q_pos = my[:, None] * S + torch.arange(S, device=q.device)
        k_pos = torch.arange(n_sp * S, device=q.device)
        mask = (q_pos[:, :, None] >= k_pos[None, None, :])[:, None, None]
        logits = logits.masked_fill(~mask, -math.inf)
    m = logits.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(logits - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    out = torch.einsum("nbhqk,nbhkd->nbhqd", p, vf)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (out / denom).to(q.dtype)


def _flash_rows(q3, kb3, vb3, rows: List[int], causal: bool):
    """One flash launch over the ranks in ``rows``: ``(O, lse)`` as
    ``[len(rows), BH, S, D]`` and ``[len(rows), BH, S]``."""
    from kungfu_tpu_torch.ops.cuda.attention import flash_attention_with_lse

    N, BH, S, D = q3.shape
    if len(rows) < N:
        idx = coll.index_tensor(rows, q3.device)
        q3, kb3, vb3 = (t.index_select(0, idx) for t in (q3, kb3, vb3))
    r = len(rows)
    o, lse = flash_attention_with_lse(q3.reshape(r * BH, S, D),
                                      kb3.reshape(r * BH, S, D),
                                      vb3.reshape(r * BH, S, D), causal=causal)
    return o.reshape(r, BH, S, D), lse.reshape(r, BH, S)


def _ring_flash(q, k, v, causal: bool, axis: str):
    """Flash-block ring: each round folds the rotating K/V block through
    the flash kernels, the rows partitioned by branch; rounds merge by
    the online-softmax combine over (out, lse)."""
    n_sp = coll.peer_size(axis)
    my = _blocks(axis)
    N, B, H, S, D = q.shape
    q3 = q.reshape(N, B * H, S, D)
    dev = q.device
    m = torch.full((N, B * H, S), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((N, B * H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((N, B * H, S, D), dtype=torch.float32, device=dev)
    kb, vb = k, v
    for rnd in range(n_sp):
        # rank i holds block (i + rnd) % n_sp this round
        blk = [(i + rnd) % n_sp for i in my]
        if causal:
            full = [r for r in range(N) if blk[r] < my[r]]
            diag = [r for r in range(N) if blk[r] == my[r]]
        else:
            full, diag = list(range(N)), []
        kb3, vb3 = kb.reshape(N, B * H, S, D), vb.reshape(N, B * H, S, D)
        out_i = lse_i = None
        if len(full) == N or len(diag) == N:
            out_i, lse_i = _flash_rows(q3, kb3, vb3, list(range(N)),
                                       causal=bool(diag))
        else:
            # masked rows (a future block under causal): zero
            # contribution, lse = -inf, no launch
            out_i = torch.zeros_like(q3)
            lse_i = torch.full((N, B * H, S), -math.inf, dtype=torch.float32,
                               device=dev)
            for rows, c in ((full, False), (diag, True)):
                if rows:
                    o, s = _flash_rows(q3, kb3, vb3, rows, causal=c)
                    idx = coll.index_tensor(rows, dev)
                    out_i = out_i.index_copy(0, idx, o)
                    lse_i = lse_i.index_copy(0, idx, s)
        m_new = torch.maximum(m, lse_i)
        # -inf - -inf is NaN: m is -inf before the first contributing
        # round, so guard the operands, not the result — a masked or
        # virgin term must contribute exactly 0
        safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe))
        w = torch.where(torch.isneginf(lse_i), 0.0, torch.exp(lse_i - safe))
        l = l * corr + w
        acc = acc * corr[..., None] + out_i.float() * w[..., None]
        m = m_new
        if rnd < n_sp - 1:  # the last rotation would feed no round
            kb, vb = _rotate((kb, vb), axis, n_sp)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype).reshape(N, B, H, S, D)


def _ring_einsum(q, k, v, causal: bool, axis: str):
    """Plain online-softmax ring fold."""
    n_sp = coll.peer_size(axis)
    my = _blocks(axis)
    N, B, H, S, D = q.shape
    dev = q.device
    qf = q.float() * (1.0 / math.sqrt(D))
    ar = torch.arange(S, device=dev)
    q_pos = coll.index_tensor(my, dev)[:, None] * S + ar  # [N, S]
    m = torch.full((N, B, H, S), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((N, B, H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((N, B, H, S, D), dtype=torch.float32, device=dev)
    kb, vb = k, v
    for rnd in range(n_sp):
        logits = torch.einsum("nbhqd,nbhkd->nbhqk", qf, kb.float())
        if causal:
            blk = coll.index_tensor([(i + rnd) % n_sp for i in my], dev)
            k_pos = blk[:, None] * S + ar
            mask = (q_pos[:, :, None] >= k_pos[:, None, :])[:, None, None]
        else:
            mask = torch.ones((1, 1, 1, S, S), dtype=torch.bool, device=dev)
        m_new = torch.maximum(
            m, logits.masked_fill(~mask, -math.inf).amax(dim=-1))
        # clamp so fully-masked rounds keep m finite and add exactly 0
        m_new = m_new.clamp_min(-1e30)
        p = torch.exp(logits - m_new[..., None]).masked_fill(~mask, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("nbhqk,nbhkd->nbhqd", p,
                                                   vb.float())
        m = m_new
        if rnd < n_sp - 1:
            kb, vb = _rotate((kb, vb), axis, n_sp)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def make_ring_attn(axis: str = "sp", block_impl: str = "auto"):
    """Adapter for the ``attn_fn(q, k, v, causal)`` slot of
    :meth:`kungfu_tpu_torch.models.transformer.Transformer.apply`."""

    def attn(q, k, v, causal):
        return ring_attention(q, k, v, causal=causal, axis=axis,
                              block_impl=block_impl)

    return attn
