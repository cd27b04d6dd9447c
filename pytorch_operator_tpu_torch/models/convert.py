"""Load a JAX param tree into the port's models: the Llama
(:func:`params_from_jax`), ResNet (:func:`resnet_params_from_jax`), ViT
(:func:`vit_params_from_jax`), the digit CNN (:func:`mnist_params_from_jax`)
and BERT (:func:`bert_params_from_jax`), the last four at the end of the
module.

The JAX package's ``Llama.init`` yields nested dicts whose layer leaves are
stacked ``[n_layers, ...]`` (flax ``nn.scan``) and whose matmul kernels keep
``DenseGeneral``'s ``[in, ...out]`` shape. :func:`params_from_jax` takes that
tree as nested dicts of numpy arrays (e.g. after ``jax.device_get``) and
returns the port's ``state_dict``: per-layer ``[out, in]`` weights, the norm
scales in float32, and every other weight in ``cfg.param_dtype``, the dtype
the port's ``Llama`` holds its parameters in. A serving model casts its matmul
weights to ``cfg.dtype`` once after loading
(:meth:`~pytorch_operator_tpu_torch.models.llama.Llama.cast_matmul_weights_`).

A tree that came out of the JAX package's ``quantize_tree`` holds its matmul
weights as ``QuantizedTensor`` leaves (int8 ``q``, f32 ``scale``). The port
cannot import that class and recognises such a leaf by its ``q`` and
``scale`` attributes; it then returns the int8 state dict of a
``quantize="int8"`` model, bit for bit: ``q`` and ``scale`` go through the
same transposes and reshapes, ``<module>.weight`` holding ``q`` and
``<module>.scale`` the scale (e.g. q/k/v ``q`` ``[L, M, H, D]`` with scale
``[L, 1, H, D]`` become ``[H·D, M]`` and ``[H·D, 1]``). A MoE model's expert
banks keep the reference's layout (``w_in`` ``q`` ``[L, E, D, F]`` with
scale ``[L, E, 1, F]`` become ``[E, D, F]`` and ``w_in_scale`` ``[E, 1,
F]``); its router ``gate`` is never quantized.

For a tensor- or expert-parallel model (``tp``, ``ep``),
:func:`params_from_jax` returns this rank's block of each tensor that tp or
ep splits (``parallel/sharding.param_splits``: the MoE banks' experts on
dim 0); FSDP2 takes its rows of the block when the model is sharded. For a
pp stage (``pp``) it returns the stage's tensors: its layers, stage 0's
embedding, and the final norm and head rows where the stage holds them.

The mapping between the two layouts lives in one place, :func:`jax_leaves`:
one :class:`JaxLeaf` a JAX param leaf, with the port tensors it holds and the
two directions between them. :func:`params_from_jax` reads it one way; the
port's adafactor (``workloads/trainer.py``) reads it both ways, since optax
picks the factored axes and takes the block RMS on the JAX leaf, not on the
port's per-layer tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.quantize import is_quantized, scale_name
from .llama import LlamaConfig


@dataclass(frozen=True)
class JaxLeaf:
    """One JAX param leaf and the port tensors it holds.

    ``shape`` is the JAX leaf's; ``names`` the port's state-dict names, one a
    layer for a leaf stacked over layers (``nn.scan``), else one. ``layout``
    maps a JAX slice onto a port tensor: ``"same"``; ``"t"``, the transpose
    (``DenseGeneral``'s ``[in, out]`` to ``nn.Linear``'s ``[out, in]``); or
    ``"heads"``, ``[M, heads, D]`` to ``[heads·D, M]`` (q, k and v)."""

    path: str
    shape: Tuple[int, ...]
    names: Tuple[str, ...]
    layout: str
    stacked: bool
    norm: bool = False

    def to_port(self, a: torch.Tensor, i: int = 0) -> torch.Tensor:
        """The port tensor ``names[i]`` of the JAX-layout ``a`` (a view where
        possible). Also maps a quantized leaf's scale, whose reduced axis has
        extent 1."""
        x = a[i] if self.stacked else a
        if self.layout == "t":
            return x.t()
        if self.layout == "heads":
            return x.reshape(x.shape[0], -1).t()
        return x

    def box(self, offsets: Sequence[int], sizes: Sequence[int]) -> tuple:
        """``(offsets, sizes)`` in this JAX leaf of the port block at
        ``offsets`` of ``sizes`` (the same block of every layer's tensor, for
        a stacked leaf). A block of q/k/v's rows that does not map to a box
        of ``[M, heads, D]`` (rows that cut across a head boundary) raises
        NotImplementedError."""
        offsets, sizes = tuple(offsets), tuple(sizes)
        if self.layout == "t":
            offsets, sizes = offsets[::-1], sizes[::-1]
        elif self.layout == "heads":
            H, D = self.shape[-2:]
            (r0, c0), (n, m) = offsets, sizes
            if n == 0:
                h, hn, d, dn = min(r0 // D, H), 0, 0, D
            elif r0 % D == 0 and n % D == 0:
                h, hn, d, dn = r0 // D, n // D, 0, D
            elif r0 // D == (r0 + n - 1) // D:
                h, hn, d, dn = r0 // D, 1, r0 % D, n
            else:
                raise NotImplementedError(
                    f"{self.path}: rows [{r0}, {r0 + n}) of a rank cut across heads of {D}"
                )
            offsets, sizes = (c0, h, d), (m, hn, dn)
        if self.stacked:
            offsets, sizes = (0,) + offsets, (self.shape[0],) + sizes
        return offsets, sizes

    def from_port(self, tensors: Sequence[torch.Tensor], shape=None) -> torch.Tensor:
        """The JAX-layout leaf of the port tensors ``tensors`` (one a name),
        stacked over layers where the leaf is (a pp stage's layers stack into
        the leaf's rows of that stage). ``shape``: the shape of the part of
        the leaf that ``tensors`` hold, where they are a rank's blocks
        (default: the whole leaf's)."""
        shape = self.shape if shape is None else tuple(shape)

        def one(t):
            if self.layout == "t":
                return t.t()
            if self.layout == "heads":
                return t.t().reshape(t.shape[1], *shape[-2:])
            return t

        if self.stacked:
            return torch.stack([one(t) for t in tensors])
        (t,) = tensors
        return one(t).contiguous()


def jax_leaves(cfg: LlamaConfig) -> List[JaxLeaf]:
    """The JAX param leaves of a Llama of config ``cfg``, each with the port
    tensors it holds (the order in which :func:`params_from_jax` checks
    them). With ``cfg.n_experts > 0`` the MoE leaves (router ``gate``
    ``[L, M, E]``, banks ``w_in`` ``[L, E, M, F]`` and ``w_out``
    ``[L, E, F, M]``, all in the port's layout) take the place of the MLP's."""
    H, K, D, M, Fd, V, L, E = (
        cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model, cfg.d_ff,
        cfg.vocab_size, cfg.n_layers, cfg.n_experts,
    )

    def layers(name):
        return tuple(f"layers.{i}.{name}" for i in range(L))

    if E > 0:
        mlp = [
            JaxLeaf("layers/moe_mlp/gate", (L, M, E), layers("moe_mlp.gate"), "same", True),
            JaxLeaf("layers/moe_mlp/w_in", (L, E, M, Fd), layers("moe_mlp.w_in"), "same", True),
            JaxLeaf("layers/moe_mlp/w_out", (L, E, Fd, M), layers("moe_mlp.w_out"), "same", True),
        ]
    else:
        mlp = [
            JaxLeaf("layers/mlp/gate_proj/kernel", (L, M, Fd), layers("mlp.gate_proj.weight"), "t", True),
            JaxLeaf("layers/mlp/up_proj/kernel", (L, M, Fd), layers("mlp.up_proj.weight"), "t", True),
            JaxLeaf("layers/mlp/down_proj/kernel", (L, Fd, M), layers("mlp.down_proj.weight"), "t", True),
        ]
    return [
        JaxLeaf("embed/embedding", (V, M), ("embed.weight",), "same", False),
        JaxLeaf("final_norm/scale", (M,), ("final_norm.weight",), "same", False, norm=True),
        JaxLeaf("lm_head/kernel", (M, V), ("lm_head.weight",), "t", False),
        JaxLeaf("layers/attn_norm/scale", (L, M), layers("attn_norm.weight"), "same", True, norm=True),
        JaxLeaf("layers/mlp_norm/scale", (L, M), layers("mlp_norm.weight"), "same", True, norm=True),
        JaxLeaf("layers/attn/q_proj/kernel", (L, M, H, D), layers("attn.q_proj.weight"), "heads", True),
        JaxLeaf("layers/attn/k_proj/kernel", (L, M, K, D), layers("attn.k_proj.weight"), "heads", True),
        JaxLeaf("layers/attn/v_proj/kernel", (L, M, K, D), layers("attn.v_proj.weight"), "heads", True),
        JaxLeaf("layers/attn/o_proj/kernel", (L, H * D, M), layers("attn.o_proj.weight"), "t", True),
        *mlp,
    ]


def params_from_jax(tree, cfg: LlamaConfig, tp=None, ep=None, pp=None) -> Dict[str, torch.Tensor]:
    """The port's state dict for the JAX param ``tree`` of config ``cfg``;
    with ``tp`` (``parallel/sharding.TensorParallel``) and ``ep``
    (``ExpertParallel``) this rank's block of each tensor that they split;
    with ``pp`` (``PipelineParallel``) this stage's tensors only: its layers
    (rows of the stacked leaves), the embedding on stage 0, the final norm
    and its head rows (the head kernel's vocabulary columns); beside tp or
    ep the stage's blocks of them, the head's rows nested pp outer, tp inner
    (``sharding.take_block``). Raises
    ``ValueError`` naming the first leaf whose shape disagrees, or whose
    quantization disagrees with ``cfg.quantize``."""
    from ..parallel.sharding import cut_splits, param_splits, take_block

    sd: Dict[str, torch.Tensor] = {}

    def node(path: str):
        n = tree
        for part in path.split("/"):
            n = n[part]
        return n

    for leaf in jax_leaves(cfg):
        raw = node(leaf.path)
        quantized = _is_quantized(raw)
        # The rule decides which leaves a quantized tree holds in int8.
        if quantized != (cfg.quantize == "int8" and is_quantized(leaf.names[0])):
            raise ValueError(
                f"JAX param {leaf.path} is {'' if quantized else 'not '}quantized, "
                f"config has quantize={cfg.quantize!r}"
            )
        if quantized:
            w = torch.from_numpy(np.array(raw.q, dtype=np.int8))
            scale = torch.from_numpy(np.array(raw.scale, dtype=np.float32))
        else:
            w, scale = torch.from_numpy(np.array(raw, dtype=np.float32)), None
        _check(leaf.path, w.shape, leaf.shape)
        axes = [ax for ax in (tp, ep, pp) if ax is not None and ax.size > 1]
        if axes and quantized:
            raise NotImplementedError("int8 weights of a tensor-, expert- or pipeline-parallel model")
        splits = param_splits(leaf.names[0], axes, cfg.vocab_size)
        for i, name in enumerate(leaf.names):
            if pp is not None and not pp.holds(name, cfg.n_layers, cfg.vocab_size):
                continue
            if cut_splits(splits):
                sd[name] = take_block(leaf.to_port(w, i), splits).to(cfg.param_dtype).contiguous()
            elif leaf.norm:
                sd[name] = leaf.to_port(w, i).clone()
            elif scale is None:
                sd[name] = leaf.to_port(w, i).to(cfg.param_dtype).contiguous()
            else:
                sd[name] = leaf.to_port(w, i).contiguous()
                sd[scale_name(name)] = leaf.to_port(scale, i).contiguous()
    return sd


def is_quantized_tree(tree) -> bool:
    """Whether a JAX param tree came out of ``quantize_tree`` (its head
    kernel is a ``QuantizedTensor``)."""
    return _is_quantized(tree["lm_head"]["kernel"])


def _is_quantized(leaf) -> bool:
    return hasattr(leaf, "q") and hasattr(leaf, "scale")


def _check(path: str, got, want) -> None:
    if tuple(got) != tuple(want):
        raise ValueError(f"JAX param {path} has shape {tuple(got)}, config expects {tuple(want)}")


# ---- the image models ----


def _np32(leaf) -> np.ndarray:
    """A JAX leaf (a numpy or jax array, bf16 included, or a flax
    ``Partitioned`` box, unboxed by duck typing) as f32 numpy."""
    if hasattr(leaf, "unbox"):
        leaf = leaf.unbox()
    return np.array(leaf, dtype=np.float32)


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# flax leaf name -> the port's state-dict suffix.
_RESNET_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
                "mean": "running_mean", "var": "running_var"}


def resnet_params_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """The port ``ResNet``'s state dict (f32 tensors; ``load_state_dict``
    casts bf16 ones) for the JAX ResNet's ``params`` and ``batch_stats``
    trees. Module paths carry over by name (``BottleneckBlock_3/Conv_1`` is
    ``BottleneckBlock_3.Conv_1``); conv kernels HWIO become OIHW (the
    space-to-depth stem keeps the canonical ``(7, 7, C, F)`` kernel, as the
    JAX module does), the Dense kernel ``[in, out]`` becomes ``[out, in]``,
    BN ``scale``/``bias`` become ``weight``/``bias`` and ``mean``/``var``
    the running buffers."""
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, leaf in _walk(tree):
            w = torch.from_numpy(_np32(leaf))
            if path[-1] == "kernel":
                w = w.permute(3, 2, 0, 1) if w.dim() == 4 else w.t()
            sd[".".join(path[:-1] + (_RESNET_LEAF[path[-1]],))] = w.contiguous()
    return sd


def vit_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The port ``ViT``'s state dict (f32) for the JAX ViT's ``params``
    tree, whose encoder leaves ``nn.scan`` stacked ``[depth, ...]``: each
    layer is unstacked; the ``DenseGeneral`` kernels q/k/v ``[D, H, hd]``
    become ``[H·hd, D]`` weights and their ``[H, hd]`` biases ``[H·hd]``,
    o ``[H, hd, D]`` becomes ``[D, H·hd]``; Dense kernels ``[in, out]``
    become ``[out, in]``; the patch kernel HWIO becomes OIHW; LayerNorm
    ``scale`` is ``weight``; ``cls`` and ``pos_embed`` carry over."""
    sd: Dict[str, torch.Tensor] = {}

    def linear(name: str, node, i=None):
        k, b = (_np32(node[leaf]) for leaf in ("kernel", "bias"))
        if i is not None:
            k, b = k[i], b[i]
        d_out = b.size
        sd[f"{name}.weight"] = torch.from_numpy(k.reshape(-1, d_out).T.copy())
        sd[f"{name}.bias"] = torch.from_numpy(b.reshape(d_out).copy())

    def norm(name: str, node, i=None):
        for leaf, port in (("scale", "weight"), ("bias", "bias")):
            a = _np32(node[leaf])
            sd[f"{name}.{port}"] = torch.from_numpy((a[i] if i is not None else a).copy())

    pe = _np32(params["patch_embed"]["kernel"])
    sd["patch_embed.weight"] = torch.from_numpy(pe.transpose(3, 2, 0, 1).copy())
    sd["patch_embed.bias"] = torch.from_numpy(_np32(params["patch_embed"]["bias"]))
    sd["cls"] = torch.from_numpy(_np32(params["cls"]))
    sd["pos_embed"] = torch.from_numpy(_np32(params["pos_embed"]))
    layers = params["layers"]
    depth = _np32(layers["attn_norm"]["scale"]).shape[0]
    for i in range(depth):
        for n in ("attn_norm", "mlp_norm"):
            norm(f"layers.{i}.{n}", layers[n], i)
        for n in ("q_proj", "k_proj", "v_proj", "o_proj", "up_proj", "down_proj"):
            linear(f"layers.{i}.{n}", layers[n], i)
    norm("final_norm", params["final_norm"])
    linear("head", params["head"])
    return sd


def mnist_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The port ``DigitCNN``'s state dict (f32) for the JAX ``DigitCNN``'s
    ``params`` tree (``Conv_0``, ``Conv_1``, ``Dense_0``, ``Dense_1``):
    conv kernels HWIO become OIHW, Dense kernels ``[in, out]`` become
    ``[out, in]``. ``Dense_0``'s rows keep flax's (h, w, c) flatten order,
    which the port's forward follows."""
    return resnet_params_from_jax(params, {})


def bert_params_from_jax(params, tp=None) -> Dict[str, torch.Tensor]:
    """The state dict (f32) of the port's ``BertClassifier`` or ``BertMLM``
    for the JAX model's ``params`` tree. flax's ``Partitioned`` leaves are
    unboxed (``embed_ln``, ``mlm_ln`` and the classifier's bias are raw);
    the ``layers`` leaves, stacked ``[L, ...]`` by ``nn.scan``, become
    ``layers.<i>``; a ``DenseGeneral`` kernel ``[in, *out]`` becomes the
    ``[prod(out), in]`` weight (q, k and v ``[d, H, D]`` → ``[H·D, d]``) and
    its bias ``[*out]`` a vector; ``embedding`` is an ``nn.Embedding``'s
    ``weight``, LayerNorm ``scale`` its ``weight``. With ``tp``
    (``parallel/sharding.TensorParallel``) this rank's block of each tensor
    that tp splits (``sharding.BERT_PARAM_AXES``, ``take_block``)."""
    from ..parallel.sharding import BERT_PARAM_AXES, param_splits, take_block

    sd: Dict[str, torch.Tensor] = {}

    def put(path, a: np.ndarray) -> None:
        leaf = path[-1]
        if leaf == "kernel":
            a = a.reshape(a.shape[0], -1).T
        elif leaf == "bias":
            a = a.reshape(-1)
        port = {"embedding": "weight", "kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        sd[".".join(path[:-1] + (port,))] = torch.from_numpy(np.ascontiguousarray(a))

    for path, leaf in _walk(params):
        a = _np32(leaf)
        if "layers" in path:
            at = path.index("layers") + 1
            for i in range(a.shape[0]):
                put(path[:at] + (str(i),) + path[at:], a[i])
        else:
            put(path, a)
    if tp is None or tp.size == 1:
        return sd
    return {name: take_block(t, param_splits(name, [tp], table=BERT_PARAM_AXES)).contiguous()
            for name, t in sd.items()}
