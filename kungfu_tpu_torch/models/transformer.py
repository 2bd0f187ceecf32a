"""GPT/BERT-style transformer — the flagship model.

Port of ``kungfu_tpu/models/transformer.py``: pre-LN blocks, RoPE or
learned positions, bf16 activations over f32 parameters, pluggable
attention, dropout, and the next-token loss.  Parameters are a plain
nested dict of tensors keyed like the reference's pytree
(``embed/table``, ``layer_{i}/wq/w``, ``head/w``);
:mod:`kungfu_tpu_torch.interop` carries them across.  ``apply``,
``hidden`` and ``loss`` are differentiable in the parameters, as the
reference's are under ``jax.grad``; inference callers wrap them in
``torch.inference_mode()``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from kungfu_tpu_torch.models import nn
from kungfu_tpu_torch.ops.lm_head import lm_head_nll
from kungfu_tpu_torch.ops.xent import token_nll
from kungfu_tpu_torch.utils import envs
from kungfu_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32128
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 2048
    dropout: float = 0.0
    causal: bool = True
    pos: str = "rope"  # "rope" | "learned"
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt


#: (half, device) -> the rotary frequencies on that device
_ROPE_FREQS: Dict[Tuple[int, str], torch.Tensor] = {}


def _rope_freqs(half: int, device: torch.device) -> torch.Tensor:
    """The rotary frequencies, computed once on the host (so every
    device gets the same f32 values) and kept on ``device``: a CUDA graph
    capturing the serving engine's decode step may not copy from the
    host."""
    key = (half, str(device))
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32)) / half
        freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32)
                          * log_base).to(device)
        _ROPE_FREQS[key] = freqs
    return freqs


def _rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary position embedding on the head dim (half-split), angles in
    f32 then cast to the activation dtype.  q, k: [B, H, S, D];
    positions: [B, S]."""
    half = q.shape[-1] // 2
    angles = positions[..., None].float() * _rope_freqs(half,
                                                        positions.device)
    cos, sin = torch.cos(angles), torch.sin(angles)

    def rot(x):
        x1, x2 = x[..., :half], x[..., half:]
        c = cos[:, None, :, :].to(x.dtype)
        s = sin[:, None, :, :].to(x.dtype)
        return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)

    return rot(q), rot(k)


def pick_attention() -> Callable:
    """Attention for the tensors' device (``KF_TPU_ATTN``: ``auto`` |
    ``xla`` | ``flash``).  ``auto`` and ``flash`` take the flash adapter,
    which launches the hand-written kernel on a CUDA tensor and runs its
    plain version on a CPU one; ``xla`` is :func:`default_attention`."""
    mode = os.environ.get(envs.ATTN, "auto").lower()
    if mode == "xla":
        return default_attention
    if mode in ("auto", "flash"):
        from kungfu_tpu_torch.ops.cuda.attention import make_flash_attn

        return make_flash_attn()
    raise ValueError(f"{envs.ATTN}={mode!r}: one of auto | xla | flash")


def default_attention(q, k, v, causal: bool, segment_positions=None):
    """Plain softmax attention.  q,k,v: [B, H, S, D].  Scores in the
    compute dtype, then f32 logits / sqrt(d), -1e30 mask, f32 softmax,
    probabilities cast back."""
    d = q.shape[-1]
    logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(d)
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        q_pos = torch.arange(s_q, device=q.device)[:, None]
        k_pos = torch.arange(s_k, device=q.device)[None, :]
        if segment_positions is not None:
            q_pos = q_pos + segment_positions[0]
            k_pos = k_pos + segment_positions[1]
        logits = logits.masked_fill(q_pos < k_pos, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return probs @ v


def param_spec(cfg: TransformerConfig) -> List[Tuple[str, tuple, str]]:
    """``(path, shape, init)`` for every parameter, in init order; the
    single source of the tree's keys for :meth:`Transformer.init` and
    the converter's totality check."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    spec = [("embed/table", (v, d), "normal")]
    if cfg.pos == "learned":
        spec.append(("pos_embed/table", (cfg.max_seq, d), "normal"))
    for i in range(cfg.n_layers):
        p = f"layer_{i}"
        spec += [(f"{p}/ln1/scale", (d,), "ones"), (f"{p}/ln1/bias", (d,), "zeros")]
        for name in ("wq", "wk", "wv", "wo"):
            spec += [(f"{p}/{name}/w", (d, d), "glorot"),
                     (f"{p}/{name}/b", (d,), "zeros")]
        spec += [(f"{p}/ln2/scale", (d,), "ones"), (f"{p}/ln2/bias", (d,), "zeros"),
                 (f"{p}/ffn_in/w", (d, f), "glorot"), (f"{p}/ffn_in/b", (f,), "zeros"),
                 (f"{p}/ffn_out/w", (f, d), "glorot"), (f"{p}/ffn_out/b", (d,), "zeros")]
    spec += [("ln_f/scale", (d,), "ones"), ("ln_f/bias", (d,), "zeros"),
             ("head/w", (d, v), "glorot")]
    return spec


def unflatten(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"a/b/c": t}`` -> ``{"a": {"b": {"c": t}}}``."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """Inverse of :func:`unflatten` (any leaf that is not a dict)."""
    out: Dict[str, object] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(flatten(val, path))
        else:
            out[path] = val
    return out


class Transformer:
    def __init__(self, config: TransformerConfig):
        self.cfg = config

    # -- init ------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> dict:
        """Random f32 parameters drawn on the CPU from ``generator``
        (default: seed 0), then moved to ``device`` (default ``cuda``;
        raises without a GPU unless ``device="cpu"``)."""
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        flat = {}
        for path, shape, kind in param_spec(self.cfg):
            if kind == "normal":
                t = nn.normal(gen, shape)
            elif kind == "glorot":
                t = nn.glorot_uniform(gen, shape)
            elif kind == "ones":
                t = torch.ones(shape, dtype=torch.float32)
            else:
                t = torch.zeros(shape, dtype=torch.float32)
            flat[path] = t.to(dev)
        return unflatten(flat)

    # -- apply -----------------------------------------------------------
    def apply(self, params, ids: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None,
              attn_fn: Optional[Callable] = None,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ids: [B, S] int → logits [B, S, vocab] f32 on the params'
        device.  ``train`` with a ``generator`` (on the params' device)
        applies dropout; ``attn_fn(q, k, v, causal)`` overrides
        attention; ``positions`` overrides token positions."""
        h = self.hidden(params, ids, train=train, generator=generator,
                        attn_fn=attn_fn, positions=positions)
        return nn.dense_apply(params["head"], h).float()

    def hidden(self, params, ids: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None,
               attn_fn: Optional[Callable] = None,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Features after the final norm, before the LM head."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        attn = attn_fn or pick_attention()
        ids = ids.to(params["embed"]["table"].device, torch.long)
        B, S = ids.shape
        if positions is None:
            positions = torch.arange(S, device=ids.device).expand(B, S)
        positions = positions.to(ids.device, torch.long)
        h = nn.embedding_apply(params["embed"], ids, dtype=dt)
        if cfg.pos == "learned":
            h = h + nn.embedding_apply(params["pos_embed"], positions, dtype=dt)
        for i in range(cfg.n_layers):
            lp = params[f"layer_{i}"]
            x = nn.layernorm_apply(lp["ln1"], h)
            q = self._heads(nn.dense_apply(lp["wq"], x, dtype=dt))
            k = self._heads(nn.dense_apply(lp["wk"], x, dtype=dt))
            v = self._heads(nn.dense_apply(lp["wv"], x, dtype=dt))
            if cfg.pos == "rope":
                q, k = _rope(q, k, positions)
            o = self._merge(attn(q, k, v, cfg.causal))
            h = h + nn.dense_apply(lp["wo"], o, dtype=dt)
            x = nn.layernorm_apply(lp["ln2"], h)
            y = nn.gelu(nn.dense_apply(lp["ffn_in"], x, dtype=dt))
            if train and cfg.dropout > 0 and generator is not None:
                y = nn.dropout(generator, y, cfg.dropout, train)
            h = h + nn.dense_apply(lp["ffn_out"], y, dtype=dt)
        return nn.layernorm_apply(params["ln_f"], h)

    def loss(self, params, batch, train: bool = True,
             generator: Optional[torch.Generator] = None,
             attn_fn: Optional[Callable] = None,
             positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Next-token LM loss; batch = (ids, targets), both [B, S].

        ``KF_TPU_LM_HEAD`` (``fused`` | ``plain`` | ``auto``, default
        auto) selects the head.  ``fused`` takes the features from
        :meth:`hidden` into :func:`~kungfu_tpu_torch.ops.lm_head.lm_head_nll`
        (the logits never materialize); ``plain`` materializes the logits
        and routes through :func:`~kungfu_tpu_torch.ops.xent.token_nll`;
        ``auto`` is ``plain`` here, as the reference's is off a TPU (its
        budget, ``route_fused_lm_head``, is a TPU setting)."""
        ids, targets = batch
        mode = os.environ.get(envs.LM_HEAD, "auto").lower()
        if mode not in ("fused", "plain", "auto"):
            raise ValueError(
                f"{envs.LM_HEAD}={mode!r}: one of fused | plain | auto")
        if mode == "fused":
            h = self.hidden(params, ids, train=train, generator=generator,
                            attn_fn=attn_fn, positions=positions)
            return lm_head_nll(h, params["head"]["w"],
                               targets.to(h.device)).mean()
        logits = self.apply(params, ids, train=train, generator=generator,
                            attn_fn=attn_fn, positions=positions)
        return token_nll(logits, targets.to(logits.device), training=train)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        return x.reshape(B, S, self.cfg.n_heads, self.cfg.head_dim
                         ).transpose(1, 2)

    def _merge(self, x: torch.Tensor) -> torch.Tensor:
        B, H, S, D = x.shape
        return x.transpose(1, 2).reshape(B, S, H * D)


def bert_base() -> Transformer:
    """BERT-base sized (the reference's benchmark size list model)."""
    return Transformer(TransformerConfig(
        vocab_size=30528, d_model=768, n_layers=12, n_heads=12, d_ff=3072,
        causal=False, pos="learned", max_seq=512))


def gpt_small(vocab: int = 32128, max_seq: int = 2048) -> Transformer:
    return Transformer(TransformerConfig(
        vocab_size=vocab, d_model=768, n_layers=12, n_heads=12, d_ff=3072,
        causal=True, pos="rope", max_seq=max_seq))
