"""BERT-style bidirectional encoder — the port of
``pytorch_operator_tpu/models/bert.py``.

The original BERT architecture (learned positions, post-LayerNorm, GELU
MLP, a pooler over [CLS]) with a classification head for fine-tuning
(:class:`BertClassifier`, the ``bert_fsdp`` workload) and an MLM head
(:class:`BertMLM`). bf16 compute over f32 parameters (``BertConfig.dtype``/
``param_dtype``), as there. What the port keeps of flax's arithmetic:

- Embeddings: each table cast to ``dtype`` (a gather, then the cast: the
  same values) and summed in ``dtype``, word + position, then + type.
- Attention: scores ``q·kᵀ`` in f32 from the ``dtype`` q and k (a bf16 ×
  bf16 product is exact in f32, so ``q.float() @ k.float()ᵀ`` is the
  reference's ``preferred_element_type=f32``), divided by ``√D`` in f32; a
  key that is a pad (``pad_mask`` False) gets ``finfo(f32).min``; the
  softmax in f32, the probabilities cast to ``dtype`` and ``p·v`` in
  ``dtype``.
- The layer is post-LN: the residual sum in ``dtype``, LayerNorm in f32
  (epsilon ``ln_eps``, 1e-12; flax's fast variance ``mean(x²) − mean(x)²``
  clamped at 0, :func:`layer_norm`) and its output cast back to ``dtype``.
- GELU is the tanh form; the pooler is ``tanh(dense(x[:, 0]))`` in
  ``dtype``; the classifier and the MLM head are f32 on the promoted
  activations (the MLM head's LayerNorm output stays f32).
- ``type_embed`` exists only when the model is built with
  ``type_embed=True``, as flax's tree holds it only when ``init`` saw
  ``type_ids`` (``bert_fsdp``'s init does not).

**Tensor parallelism.** ``BertClassifier(cfg, n, tp=TensorParallel(...))``
(or ``mesh=``, whose tp axis it takes) holds this rank's blocks as JAX's
logical annotations split them over ``tp`` (``parallel/sharding.py``
:data:`~pytorch_operator_tpu_torch.parallel.sharding.BERT_PARAM_AXES`): q,
k and v their ``n_heads/tp`` heads' rows and bias blocks (column-parallel,
after ``tp_enter``), o_proj the matching input columns (row-parallel:
``F.linear`` without the bias, ``tp_leave``, then the whole bias added
once), ``mlp_up`` its ``d_ff/tp`` rows and bias block and ``mlp_down`` the
matching columns (row-parallel like o_proj), ``word_embed`` its ``V/tp``
rows (a masked local lookup, then ``tp_leave``), ``BertMLM``'s
``mlm_head`` its ``V/tp`` rows, whose logits are gathered over tp
(``all_gather_autograd`` on the last dim; the whole bias added after), so
that the heads return the whole outputs on every rank. ``pos_embed``,
``type_embed``, every LayerNorm, the pooler, the classifier,
``mlm_transform`` and the row-parallel biases are whole on every rank. The
model is built whole, drawn as one process draws it, and each parameter
cut to its block by the table (``sharding.take_block``), so that the ranks
together hold the one-process init. A tp that does not divide
``n_heads``, ``d_ff`` or the vocabulary is refused
(:func:`check_bert_tp_divides`), as JAX's partitioner refuses such a mesh.
Over sp, ep and pp the model is whole (``REPLICATED_AXES``): JAX splits
no BERT parameter over them.

Parameter names follow the flax tree (``bert.word_embed``, ``bert.pos_embed``,
``bert.type_embed``, ``bert.embed_ln``, ``bert.layers.<i>.{attn.{q,k,v,o}_proj,
attn_ln,mlp_up,mlp_down,mlp_ln}``, ``bert.pooler``, ``classifier``;
``mlm_transform``, ``mlm_ln``, ``mlm_head``); the JAX layers are stacked by
``nn.scan`` and ``models/convert.bert_params_from_jax`` unstacks them. The
encoder layers are ``layers`` (also on the heads), so that
``parallel/sharding.shard_model`` makes each an FSDP2 unit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import all_gather_autograd
from ..parallel.sharding import BERT_PARAM_AXES, TensorParallel, model_splits, take_block


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30_522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_len: int = 512
    type_vocab: int = 2
    ln_eps: float = 1e-12
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def bert_base(**over) -> BertConfig:
    return BertConfig(**over)


def bert_tiny(**over) -> BertConfig:
    base = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_len=64,
                dtype=torch.float32)
    base.update(over)
    return BertConfig(**base)


def check_bert_tp_divides(cfg: BertConfig, size: int) -> None:
    """Refuse a tp that does not divide a dimension it splits, naming it:
    the heads, ``d_ff`` and the vocabulary. JAX's ``bert_fsdp`` refuses
    such a mesh too: its partitioner raises a ValueError that a parameter
    (``k_proj``'s bias at tp=8 on 4 heads, ``word_embed`` at a vocabulary
    of 130 over tp=4) is not divisible by tp."""
    if size <= 1:
        return
    for what in ("n_heads", "d_ff", "vocab_size"):
        n = getattr(cfg, what)
        if n % size:
            raise ValueError(
                f"tp={size} does not divide {what}={n}: BERT's tp splits the heads, d_ff and the "
                "vocabulary, so it must divide each (JAX's bert_fsdp refuses such a mesh too)"
            )


def layer_norm(x, weight, bias, eps: float):
    """flax ``nn.LayerNorm(dtype=f32)`` with its default fast variance:
    ``mean(x²) − mean(x)²`` clamped at 0, in f32; f32 out."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * weight) + bias


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class Dense(nn.Linear):
    """flax ``nn.DenseGeneral(dtype)``: the ``[out, in]`` weight and the bias
    cast to ``dtype`` at each use, the input too."""

    def __init__(self, d_in: int, d_out: int, dtype, param_dtype):
        super().__init__(d_in, d_out, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def row_parallel(dense: Dense, x, tp: Optional[TensorParallel]):
    """``dense(x)`` where ``dense`` holds this rank's input columns under
    ``tp``: the partial product without the bias, summed over tp, then the
    whole bias added once (every rank adding it before the sum would count
    it tp times)."""
    if tp is None:
        return dense(x)
    dt = dense.compute_dtype
    return tp.leave(F.linear(x.to(dt), dense.weight.to(dt))) + dense.bias.to(dt)


class SelfAttention(nn.Module):
    """Bidirectional multi-head attention with a padding mask; under ``tp``
    over this rank's heads (as many as its q_proj rows hold)."""

    def __init__(self, cfg: BertConfig, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        d, dt, pt = cfg.d_model, cfg.dtype, cfg.param_dtype
        hd = cfg.n_heads * cfg.head_dim
        self.q_proj, self.k_proj, self.v_proj = (Dense(d, hd, dt, pt) for _ in range(3))
        self.o_proj = Dense(hd, d, dt, pt)

    def forward(self, x, pad_mask):
        cfg = self.cfg
        B, S, _ = x.shape
        D = cfg.head_dim
        H = self.q_proj.weight.shape[0] // D
        if self.tp is not None:
            x = self.tp.enter(x)
        q, k, v = (proj(x).view(B, S, H, D) for proj in (self.q_proj, self.k_proj, self.v_proj))
        scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(D)
        if pad_mask is not None:
            # pad_mask [B, S]: True = a real token; nothing attends to a pad.
            scores = scores.masked_fill(~pad_mask[:, None, None, :], torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, H * D)
        return row_parallel(self.o_proj, out, self.tp)


class EncoderLayer(nn.Module):
    """Post-LN transformer encoder layer (the original BERT's residual order);
    under ``tp`` the MLP over this rank's ``d_ff/tp`` columns."""

    def __init__(self, cfg: BertConfig, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        d, dt, pt = cfg.d_model, cfg.dtype, cfg.param_dtype
        self.attn = SelfAttention(cfg, tp)
        self.attn_ln = LayerNorm(d, cfg.ln_eps, pt)
        self.mlp_up = Dense(d, cfg.d_ff, dt, pt)
        self.mlp_down = Dense(cfg.d_ff, d, dt, pt)
        self.mlp_ln = LayerNorm(d, cfg.ln_eps, pt)

    def forward(self, x, pad_mask):
        dt = self.cfg.dtype
        x = self.attn_ln(x + self.attn(x, pad_mask)).to(dt)
        up = self.mlp_up(x if self.tp is None else self.tp.enter(x))
        h = row_parallel(self.mlp_down, F.gelu(up, approximate="tanh"), self.tp)
        return self.mlp_ln(x + h).to(dt)


def _check_pad_mask(tokens, pad_mask) -> None:
    if pad_mask is None:
        return
    if pad_mask.dtype != torch.bool or tuple(pad_mask.shape) != tuple(tokens.shape):
        raise ValueError(
            f"pad_mask must be a bool [B, S] tensor like tokens {tuple(tokens.shape)} (True = a "
            f"real token), got {pad_mask.dtype} {tuple(pad_mask.shape)}"
        )


class Bert(nn.Module):
    """Encoder backbone: ``forward(tokens [B, S], type_ids=None,
    pad_mask=None) -> (sequence_output [B, S, d], pooled [B, d])``, both in
    ``dtype``. Under ``tp`` it is built whole and cut to this rank's blocks
    by the head that holds it (:class:`BertClassifier`, :class:`BertMLM`)."""

    def __init__(self, cfg: BertConfig, type_embed: bool = False, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        d, dt, pt = cfg.d_model, cfg.dtype, cfg.param_dtype
        self.word_embed = nn.Embedding(cfg.vocab_size, d, dtype=pt)
        self.pos_embed = nn.Embedding(cfg.max_len, d, dtype=pt)
        self.type_embed = nn.Embedding(cfg.type_vocab, d, dtype=pt) if type_embed else None
        self.embed_ln = LayerNorm(d, cfg.ln_eps, pt)
        self.layers = nn.ModuleList(EncoderLayer(cfg, tp) for _ in range(cfg.n_layers))
        self.pooler = Dense(d, d, dt, pt)

    def _embed(self, tokens):
        """The word embedding in ``dtype``; under tp vocab-parallel: this
        rank's rows, zeros for the others' ids, summed over tp."""
        if self.tp is None:
            return self.word_embed(tokens).to(self.cfg.dtype)
        n = self.word_embed.weight.shape[0]
        local = tokens - self.tp.index * n
        mine = (local >= 0) & (local < n)
        x = F.embedding(local.clamp(0, n - 1), self.word_embed.weight)
        return self.tp.leave(torch.where(mine[..., None], x, 0).to(self.cfg.dtype))

    def forward(self, tokens, type_ids=None, pad_mask=None):
        cfg = self.cfg
        dt = cfg.dtype
        _check_pad_mask(tokens, pad_mask)
        S = tokens.shape[1]
        x = self._embed(tokens)
        x = x + self.pos_embed(torch.arange(S, device=tokens.device)).to(dt)
        if type_ids is not None:
            if self.type_embed is None:
                raise ValueError("type_ids given to a Bert built without type_embed "
                                 "(build it with type_embed=True, as flax's init with type_ids)")
            x = x + self.type_embed(type_ids).to(dt)
        x = self.embed_ln(x).to(dt)
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, pad_mask, use_reentrant=False)
            else:
                x = layer(x, pad_mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class _BertHead(nn.Module):
    """What the heads share: the backbone, the layout over a mesh (the
    parameter axes' table, the axes that hold the model whole), and the
    cut of the whole init to this rank's tp blocks."""

    PARAM_AXES = BERT_PARAM_AXES
    REPLICATED_AXES = ("sp", "ep", "pp")

    def _backbone(self, cfg: BertConfig, type_embed: bool, tp, mesh) -> None:
        if tp is None:
            tp = TensorParallel.of(mesh)
        if tp is not None:
            check_bert_tp_divides(cfg, tp.size)
        self.cfg = cfg
        self.tp = tp
        self.bert = Bert(cfg, type_embed, tp)

    @property
    def layers(self):
        return self.bert.layers

    @torch.no_grad()
    def _init(self, seed: int) -> None:
        """The one-process init of ``seed`` (:func:`init_weights`), then,
        under tp, each parameter cut to this rank's block."""
        init_weights(self, torch.Generator().manual_seed(seed))
        if self.tp is None:
            return
        for name, p in list(self.named_parameters()):
            module_name, leaf = name.rsplit(".", 1)
            block = take_block(p, model_splits(self, name))
            if block.shape != p.shape:
                setattr(self.get_submodule(module_name), leaf, nn.Parameter(block.clone()))


class BertClassifier(_BertHead):
    """Backbone + classification head (f32 logits ``[B, num_classes]``) —
    the fine-tune surface of ``bert_fsdp``. ``tp`` (or ``mesh``, whose tp
    axis it takes) builds this rank's part of a tensor-parallel model."""

    def __init__(self, cfg: BertConfig, num_classes: int, type_embed: bool = False, seed: int = 0,
                 tp: Optional[TensorParallel] = None, mesh=None):
        super().__init__()
        self._backbone(cfg, type_embed, tp, mesh)
        self.classifier = Dense(cfg.d_model, num_classes, torch.float32, cfg.param_dtype)
        self._init(seed)

    def forward(self, tokens, type_ids=None, pad_mask=None):
        _, pooled = self.bert(tokens, type_ids, pad_mask)
        return self.classifier(pooled)


class BertMLM(_BertHead):
    """Backbone + masked-LM head (f32 logits ``[B, S, vocab]``; untied).
    Under tp the head holds ``V/tp`` rows and the logits are gathered over
    tp, so every rank returns the whole ``[B, S, vocab]``."""

    def __init__(self, cfg: BertConfig, type_embed: bool = False, seed: int = 0,
                 tp: Optional[TensorParallel] = None, mesh=None):
        super().__init__()
        self._backbone(cfg, type_embed, tp, mesh)
        self.mlm_transform = Dense(cfg.d_model, cfg.d_model, cfg.dtype, cfg.param_dtype)
        self.mlm_ln = LayerNorm(cfg.d_model, cfg.ln_eps, cfg.param_dtype)
        self.mlm_head = Dense(cfg.d_model, cfg.vocab_size, torch.float32, cfg.param_dtype)
        self._init(seed)

    def forward(self, tokens, type_ids=None, pad_mask=None):
        seq, _ = self.bert(tokens, type_ids, pad_mask)
        h = self.mlm_ln(F.gelu(self.mlm_transform(seq), approximate="tanh"))
        if self.tp is None:
            return self.mlm_head(h)
        # Every rank's h is whole; its gradient sums the ranks' rows' parts.
        local = F.linear(self.tp.enter(h).float(), self.mlm_head.weight.float())
        return all_gather_autograd(local, "tp", self.tp.mesh, dim=-1) + self.mlm_head.bias.float()


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX module's initializers, in distribution: ``normal(0.02)`` for
    every embedding table and Dense kernel, zero biases, LayerNorm ones and
    zeros. Drawn on the CPU, in parameter order (under a meta device:
    shapes only)."""
    for name, p in model.named_parameters():
        if isinstance(model.get_submodule(name.rsplit(".", 1)[0]), LayerNorm):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            w = torch.empty(p.shape, dtype=torch.float32)
            w.normal_(0.0, 0.02, generator=generator)
            p.copy_(w)
    return model
