"""Laying a model out on a mesh — the port of
``pytorch_operator_tpu/parallel/sharding.py``.

The logical-axis rule table is the JAX package's (:data:`DEFAULT_RULES`,
:func:`filter_axis_for_mesh`, :func:`logical_to_mesh_axes`): it says which
mesh axes the batch and each parameter axis map to. JAX lets XLA insert the
collectives a sharding implies; here the two kinds of axes are laid out
apart.

**tp.** :data:`LLAMA_PARAM_AXES` names each Llama parameter's logical axes
(the JAX model's annotations turned to ``nn.Linear``'s ``[out, in]``), and
:func:`tp_dim` reads from the rule table the dim that ``tp`` splits: the
heads of q/k/v (dim 0) and o (dim 1), the MLP's ``d_ff`` (gate and up dim
0, down dim 1), the vocabulary of the embedding and the head (dim 0); the
norms are replicated. A model names its own table in ``PARAM_AXES`` (the
Llama's by default): BERT's, :data:`BERT_PARAM_AXES`, is read by whole
names, so that ``pos_embed`` (whole over tp) is not taken for the Llama's
``embed.weight``, and holds its biases too. A tensor-parallel model (``Llama(cfg,
tp=TensorParallel...)``) holds only its rank's block of each such tensor, a
plain tensor, and runs its collectives itself
(``collectives.tp_enter``/``tp_leave``): PyTorch's ``parallelize_module``
redistributes through DTensor's functional collectives, which crash under
gloo on CUDA tensors.

**ep** splits the MoE banks ``w_in`` ``[E, D, F]`` and ``w_out`` ``[E, F,
D]`` on dim 0 (the rule ``expert → ep``): a model built with an
:class:`ExpertParallel` holds ``E/ep`` experts a rank, plain tensors as tp's
blocks are, and tp splits each expert's ``F`` on top (``mlp → tp``). **sp**
splits no parameter: each sp rank holds them whole, trains on its block of
the sequence, and the gradients are averaged over sp after the backward
(``workloads/trainer.py``). :class:`SequenceParallel` is the axis as the
model holds it.

**dp, fsdp** (the rule for ``"batch"``) are laid out with FSDP2:
:func:`shard_model` calls ``torch.distributed.fsdp.fully_shard`` on each
decoder block and then on the root, over the mesh of the data axes (one
such mesh a coordinate of the other axes). ``fsdp`` is the shard dimension: every parameter (a
tp block, under tp), its gradient and its optimizer state become DTensors
sharded on dim 0, gathered per block for the forward and the backward and
reduce-scattered after it. ``dp`` replicates: on a mesh ``(dp, fsdp)``
FSDP2 is HSDP (an all-reduce over ``dp`` after the reduce-scatter over
``fsdp``), and a mesh with ``dp`` alone is HSDP with a one-rank shard
dimension (the gradients all-reduced, the parameters whole on every rank).

:class:`Block` says where a rank's part of a tensor sits in the whole
(tp's block, FSDP2's rows of it): the checkpoint writes and restores by it,
:func:`full_tensor` gathers by the same rule.

The master weights stay in their dtype (f32) and are cast at the call as on
one device; no mixed-precision policy is set, so gradients reduce in f32,
as JAX's psum does. Known, deliberate differences: JAX's ``fsdp_spec``
shards a parameter's largest evenly divisible dimension of at least 2^16
elements; FSDP2 shards dim 0 of every parameter (of its tp block). And JAX
splits the ``[in, out]`` kernels; the port splits the same logical axis of
the ``[out, in]`` weight. The bytes a rank holds differ, the numerics do
not.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, ClassVar, Optional, Sequence, Tuple, Union

MeshAxes = Union[str, Tuple[str, ...], None]
LogicalRules = Sequence[Tuple[str, MeshAxes]]

# The JAX package's rule table: earlier entries win; None replicates; a
# tuple shards over those mesh axes jointly (the batch over dp AND fsdp).
DEFAULT_RULES: LogicalRules = (
    ("batch", ("dp", "fsdp")),
    ("seq", "sp"),
    ("embed", "fsdp"),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("vocab", "tp"),
    ("expert", "ep"),
    ("stage", "pp"),
    ("head_dim", None),
    ("norm", None),
    ("layers", None),
)


def filter_axis_for_mesh(mesh_ax: MeshAxes, mesh_axes: Optional[set]) -> MeshAxes:
    """Drop mesh axes absent from ``mesh_axes`` (None keeps everything);
    tuples are filtered member-wise and collapse to a bare string (one
    member) or None (empty)."""
    if mesh_ax is None or mesh_axes is None:
        return mesh_ax
    if isinstance(mesh_ax, tuple):
        kept = tuple(a for a in mesh_ax if a in mesh_axes)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else kept
    return mesh_ax if mesh_ax in mesh_axes else None


def logical_to_mesh_axes(
    logical_axes: Sequence[Optional[str]], rules: LogicalRules = DEFAULT_RULES, mesh_axes=None,
) -> list:
    """The mesh axes of each logical axis (``logical_to_spec``'s entries,
    trailing Nones trimmed), for a mesh with axes ``mesh_axes``."""
    table = {}
    for name, mesh_ax in rules:
        table.setdefault(name, mesh_ax)
    names = set(mesh_axes) if mesh_axes is not None else None
    out = [
        filter_axis_for_mesh(table.get(ax), names) if ax is not None else None
        for ax in logical_axes
    ]
    while out and out[-1] is None:
        out.pop()
    return out


def data_axes(mesh_axes, rules: LogicalRules = DEFAULT_RULES) -> tuple:
    """The mesh axes the batch is split over (the ``"batch"`` rule), in the
    mesh's order."""
    ax = logical_to_mesh_axes(("batch",), rules, mesh_axes)
    ax = ax[0] if ax else None
    kept = () if ax is None else ((ax,) if isinstance(ax, str) else ax)
    return tuple(a for a in mesh_axes if a in kept)


# Each Llama parameter's logical axes in the port's orientation (a weight
# [out, in]), by the end of its state-dict name: the JAX model's
# annotations (models/llama.py: q l.325, k/v l.330, o l.406, gate/up l.578,
# down l.587, embed l.763, head l.803).
LLAMA_PARAM_AXES = (
    ("attn.q_proj.weight", ("heads", "embed")),
    ("attn.k_proj.weight", ("kv_heads", "embed")),
    ("attn.v_proj.weight", ("kv_heads", "embed")),
    ("attn.o_proj.weight", ("embed", "heads")),
    ("mlp.gate_proj.weight", ("mlp", "embed")),
    ("mlp.up_proj.weight", ("mlp", "embed")),
    ("mlp.down_proj.weight", ("embed", "mlp")),
    ("embed.weight", ("vocab", "embed")),
    ("lm_head.weight", ("vocab", "embed")),
    ("norm.weight", ("norm",)),
    # The MoE layer's parameters keep the reference's layout (models/llama.py
    # MoEMLP: gate l.616, w_in l.624, w_out l.632).
    ("moe_mlp.gate", ("embed", None)),
    ("moe_mlp.w_in", ("expert", "embed", "mlp")),
    ("moe_mlp.w_out", ("expert", "mlp", "embed")),
)


# Each BERT parameter's logical axes in the port's orientation, by its whole
# state-dict name in BertClassifier or BertMLM with the layer index written
# "*" (models/bert.py of the JAX package: q/k/v l.85-88, o l.104, mlp_up
# l.135, mlp_down l.138, the embeddings l.160-168, the LayerNorms l.119-124,
# the pooler l.190, the classifier l.207, mlm_transform l.221, mlm_head
# l.230). Looked up by the exact name, never by a suffix: pos_embed and
# type_embed end like the Llama's embed.weight but are whole over tp. A leaf
# that JAX leaves unannotated (embed_ln, mlm_ln, the classifier's, pooler's,
# mlm_transform's and mlm_head's biases) is (None,): whole on every rank.
BERT_PARAM_AXES = {
    "bert.word_embed.weight": ("vocab", "embed"),
    "bert.pos_embed.weight": (None, "embed"),
    "bert.type_embed.weight": (None, "embed"),
    "bert.embed_ln.weight": (None,),
    "bert.embed_ln.bias": (None,),
    **{f"bert.layers.*.attn.{p}_proj.{leaf}": axes
       for p in "qkv" for leaf, axes in (("weight", ("heads", "embed")), ("bias", ("heads",)))},
    "bert.layers.*.attn.o_proj.weight": ("embed", "heads"),
    "bert.layers.*.attn.o_proj.bias": ("embed",),
    "bert.layers.*.mlp_up.weight": ("mlp", "embed"),
    "bert.layers.*.mlp_up.bias": ("mlp",),
    "bert.layers.*.mlp_down.weight": ("embed", "mlp"),
    "bert.layers.*.mlp_down.bias": ("embed",),
    **{f"bert.layers.*.{ln}.{leaf}": ("norm",) for ln in ("attn_ln", "mlp_ln") for leaf in ("weight", "bias")},
    **{f"{dense}.{leaf}": axes for dense in ("bert.pooler", "classifier", "mlm_transform")
       for leaf, axes in (("weight", (None, "embed")), ("bias", (None,)))},
    "mlm_ln.weight": (None,),
    "mlm_ln.bias": (None,),
    "mlm_head.weight": ("vocab", "embed"),
    "mlm_head.bias": (None,),
}

_LAYER_INDEX = re.compile(r"(?<=\.layers\.)\d+(?=\.)")


def param_axes(name: str, table=LLAMA_PARAM_AXES) -> tuple:
    """The logical axes of parameter ``name`` in ``table``: the Llama's
    (:data:`LLAMA_PARAM_AXES`, ``(suffix, axes)`` pairs matched by the end
    of the name) by default, or a dict keyed by whole names with each layer
    index written ``*`` (:data:`BERT_PARAM_AXES`)."""
    if isinstance(table, dict):
        axes = table.get(_LAYER_INDEX.sub("*", name))
        if axes is not None:
            return axes
    else:
        for suffix, axes in table:
            if name.endswith(suffix):
                return axes
    raise KeyError(f"no logical axes for parameter {name!r} in its model's layout")


def axis_dim(name: str, axis: str, rules: LogicalRules = DEFAULT_RULES,
             table=LLAMA_PARAM_AXES) -> Optional[int]:
    """The dim of parameter ``name`` (in ``table``, :func:`param_axes`) that
    mesh axis ``axis`` splits under ``rules``, or None (replicated)."""
    axes = logical_to_mesh_axes(param_axes(name, table), rules, {axis})
    dims = [i for i, ax in enumerate(axes) if ax == axis]
    return dims[0] if dims else None


def tp_dim(name: str, rules: LogicalRules = DEFAULT_RULES) -> Optional[int]:
    """The dim of parameter ``name`` that ``tp`` splits, or None."""
    return axis_dim(name, "tp", rules)


@dataclass(frozen=True)
class AxisParallel:
    """One model-parallel mesh axis as a model holds it: ``size`` ranks,
    this one at ``index``; ``mesh`` the ``DeviceMesh`` whose group of the
    axis (:attr:`axis`) the collectives run on."""

    size: int
    index: int
    mesh: Any = None
    axis: ClassVar[str] = ""

    @classmethod
    def of(cls, mesh):
        """The mesh's axis, or None when it has none (or of size 1)."""
        if mesh is None:
            return None
        from .mesh import axis_sizes

        n = axis_sizes(mesh).get(cls.axis, 1)
        return cls(n, mesh.get_local_rank(cls.axis), mesh) if n > 1 else None

    def enter(self, x):
        from .collectives import tp_enter

        return tp_enter(x, self.axis, self.mesh)

    def leave(self, x):
        from .collectives import tp_leave

        return tp_leave(x, self.axis, self.mesh)

    def block(self, n: int, what: str) -> tuple:
        """``(start, length)`` of this rank's block of ``n`` (``what``: its
        name in the error); the axis must divide ``n``."""
        if n % self.size:
            raise ValueError(f"{self.axis}={self.size} does not divide {what}={n}")
        k = n // self.size
        return self.index * k, k


class TensorParallel(AxisParallel):
    """The ``tp`` axis."""

    axis = "tp"


class ExpertParallel(AxisParallel):
    """The ``ep`` axis: ``E/ep`` experts a rank."""

    axis = "ep"


class SequenceParallel(AxisParallel):
    """The ``sp`` axis: this rank's block of ``S/sp`` positions."""

    axis = "sp"


# param_splits' dim for a tensor that one pp stage holds whole and alone (a
# layer of its stage, stage 0's embedding, the last stage's whole head): the
# rule table's ("stage", "pp") splits the JAX leaf's layer axis, which the
# port's state-dict names carry (``layers.<i>``).
STAGE = "stage"


class PipelineParallel(AxisParallel):
    """The ``pp`` axis: stage ``index`` of ``size``. The Llama's layout on a
    stage (``models/llama.py``): layers ``[s·L/P, (s+1)·L/P)`` under their
    global names, the embedding on stage 0; where P divides the vocabulary
    (:meth:`vocab_parallel`) every stage holds the final norm and its
    ``V/P`` head rows, else the last stage holds both whole. Beside tp the
    same tensors are tp's blocks: a stage's head rows are cut again by tp
    inside the stage (pp outer, tp inner: :func:`param_splits`)."""

    axis = "pp"

    def layers(self, n_layers: int) -> range:
        """The global indices of this stage's layers."""
        start, n = self.block(n_layers, "n_layers")
        return range(start, start + n)

    def vocab_parallel(self, vocab: int) -> bool:
        return vocab % self.size == 0

    def holds_tail(self, vocab: int) -> bool:
        """Whether this stage holds the final norm and (part of) the head."""
        return self.vocab_parallel(vocab) or self.index == self.size - 1

    def holds(self, name: str, n_layers: int, vocab: int) -> bool:
        """Whether this stage holds the Llama's parameter ``name``."""
        if name.startswith("layers."):
            return int(name.split(".")[1]) in self.layers(n_layers)
        if name.startswith("embed."):
            return self.index == 0
        return self.holds_tail(vocab)

    def split(self, name: str, vocab: int):
        """:func:`param_splits`' dim of parameter ``name`` under pp: the head's
        vocabulary rows (dim 0) and None for the final norm (every stage holds
        a copy) on the vocab-parallel layout, else :data:`STAGE`."""
        if self.vocab_parallel(vocab):
            if name == "lm_head.weight":
                return 0
            if name == "final_norm.weight":
                return None
        return STAGE


def model_axes(model) -> tuple:
    """The model-parallel axes a model holds (its ``tp``, ``ep``, ``sp`` and
    ``pp`` attributes that are set), in that order."""
    return tuple(ax for ax in (getattr(model, a, None) for a in ("tp", "ep", "sp", "pp"))
                 if ax is not None)


def param_splits(name: str, axes, vocab: Optional[int] = None, table=LLAMA_PARAM_AXES) -> tuple:
    """``(axis, dim)`` for each of ``axes`` (:class:`AxisParallel` s, in
    :func:`model_axes`' order): the dim of parameter ``name`` it splits,
    None where it replicates it, or :data:`STAGE` where it is this pp
    stage's alone (pp needs ``vocab``, the model's vocabulary, which decides
    its layout).

    Two axes may cut one dim: the head's vocabulary rows over pp and tp.
    They nest in the order of ``axes``, the first innermost: a stage holds
    ``V/P`` rows and its tp ranks their blocks of those, so that stage s, tp
    rank t holds rows ``[s·V/P + t·V/(P·tp), ...)``. Where tp does not
    divide a stage's ``V/P`` rows (JAX runs such a vocabulary; only a tp
    that does not divide V is refused, :func:`check_tp_divides`), tp
    replicates the stage's rows instead of cutting them. ``table``: the
    model's parameter axes (:func:`param_axes`)."""
    pp = next((ax for ax in axes if isinstance(ax, PipelineParallel)), None)

    def dim(ax):
        if ax is pp:
            return ax.split(name, vocab)
        d = axis_dim(name, ax.axis, table=table)
        if (d is not None and pp is not None and name == "lm_head.weight" and pp.vocab_parallel(vocab)
                and (vocab // pp.size) % ax.size):
            return None
        return d

    return tuple((ax, dim(ax)) for ax in axes)


def cut_splits(splits) -> list:
    """The ``(axis, dim)`` of ``splits`` that cut a tensor into blocks along
    a dim (neither replicated nor a stage's own), innermost first."""
    return [(ax, d) for ax, d in splits if ax.size > 1 and d is not None and d != STAGE]


def take_block(t, splits):
    """This rank's block of the whole tensor ``t`` under ``splits``
    (:func:`param_splits`): each cutting axis narrows its dim to this rank's
    block, the outermost (last) first, so that axes cutting one dim nest as
    :class:`Block` and :func:`full_tensor` read them."""
    for ax, d in reversed(cut_splits(splits)):
        t = t.narrow(d, *ax.block(t.shape[d], f"dim {d} of a {tuple(t.shape)} block"))
    return t


def check_tp_divides(cfg, size: int) -> None:
    """Refuse a tp that does not divide a dimension it splits, naming it.
    JAX's ``llama_train`` refuses such a mesh too: its partitioner raises a
    ValueError that an output (the optimizer state of ``k_proj`` at tp=4 on
    the tiny config, the embedding at tp=3) is not divisible by tp."""
    if size <= 1:
        return
    for what in ("n_heads", "n_kv_heads", "d_ff", "vocab_size"):
        n = getattr(cfg, what)
        if n % size:
            raise ValueError(
                f"tp={size} does not divide {what}={n}: tp splits the heads, kv heads, d_ff and "
                "the vocabulary, so it must divide each (JAX's llama_train refuses such a mesh too)"
            )


def dim0_rows(shape, mesh, placements) -> tuple:
    """``(offset, rows)``: the rows of dim 0 this rank holds of a DTensor of
    global ``shape`` laid out as ``placements`` on ``mesh``: FSDP2's
    ``Shard(0)`` takes ``torch.chunk``'s blocks (ceil-sized, the last ones
    short or empty), a ``Replicate`` dimension takes them all."""
    offset, rows = 0, int(shape[0])
    for i, pl in enumerate(placements):
        if pl.is_shard():
            if pl.dim != 0:
                raise NotImplementedError(f"a Shard({pl.dim}) layout (FSDP2 shards dim 0)")
            chunk = -(-rows // mesh.size(i))
            start = min(mesh.get_local_rank(i) * chunk, rows)
            offset, rows = offset + start, min(start + chunk, rows) - start
    return offset, rows


@dataclass
class Block:
    """This rank's part of a tensor and where it sits in the whole:
    ``local`` (a tensor, or the DTensor of FSDP2 that holds it), the whole
    tensor's ``shape``, the part's ``offsets`` on every dim, and whether
    this rank is the one that writes it (``writer``: the lowest coordinate
    of every mesh axis that holds the same part)."""

    local: Any
    offsets: tuple
    shape: tuple
    writer: bool = True

    @property
    def data(self):
        """The part itself, a plain tensor."""
        return local_tensor(self.local)

    @classmethod
    def of(cls, t, splits: Sequence = ()) -> "Block":
        """The block of ``t`` (a tensor, or a DTensor of FSDP2's dim-0
        layout) under ``splits``, ``(axis, dim)`` pairs
        (:func:`param_splits`): each axis splits the tensor's dim ``dim``,
        or, with ``dim`` None, replicates it (coordinate 0 writes it)."""
        from torch.distributed.tensor import DTensor

        shape = list(t.shape)
        offsets = [0] * len(shape)
        writer = True
        if isinstance(t, DTensor):
            offsets[0], _ = dim0_rows(t.shape, t.device_mesh, t.placements)
            writer = all(t.device_mesh.get_local_rank(i) == 0
                         for i, pl in enumerate(t.placements) if pl.is_replicate())
        for ax, d in splits:
            if ax.size <= 1 or d == STAGE:
                continue
            if d is None:
                writer = writer and ax.index == 0
            else:
                offsets[d] += ax.index * shape[d]
                shape[d] *= ax.size
        return cls(t, tuple(offsets), tuple(shape), writer)


def model_splits(model, name: str) -> tuple:
    """:func:`param_splits` of ``model``'s parameter ``name`` over the
    model-parallel axes it holds, in the model's table of parameter axes
    (its ``PARAM_AXES``; the Llama's, :data:`LLAMA_PARAM_AXES`, by
    default)."""
    return param_splits(name, model_axes(model), model.cfg.vocab_size,
                        getattr(model, "PARAM_AXES", LLAMA_PARAM_AXES))


class Elsewhere:
    """A tensor of the whole model that another pp stage holds, by its whole
    ``shape``: in :func:`model_blocks` it holds a stage's tree to the whole
    model's names, and a checkpoint neither writes nor reads it."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def model_blocks(model) -> dict:
    """A model's state dict as :class:`Block` s (name: its block), the
    layout a checkpoint writes: each tp and ep parameter's block of the
    whole, FSDP2's rows of it, pp's head rows; a part that a tp, ep, sp or
    pp coordinate other than 0 also holds is written by coordinate 0; a pp
    stage's own tensors by that stage, and every other stage's tensor as
    :class:`Elsewhere`, so that a restore holds the step to the whole
    model's names (one process's order)."""
    blocks = {name: Block.of(t, model_splits(model, name)) for name, t in model.state_dict().items()}
    if getattr(model, "pp", None) is None:
        return blocks
    return {name: blocks[name] if name in blocks else Elsewhere(t.shape)
            for name, t in model.whole().state_dict().items()}


def shard_model(model, mesh):
    """Lay ``model`` out on ``mesh``: tp and ep first (the model must hold
    the mesh's tp and ep blocks already: built with ``Llama(cfg,
    mesh=mesh)``; a model that names an axis in its ``REPLICATED_AXES``,
    as BERT names sp, ep and pp, is whole over it), then FSDP2 over the
    data axes, each block of ``model.layers`` and then the root (embedding,
    final norm, LM head), one
    data mesh a coordinate of the other axes (tp, ep, sp, pp); a pp stage's
    parts (``llama.PP_FORWARD_METHODS``) become FSDP2 forward methods of the
    root. Returns the model, whose parameters are then DTensors (none
    on a mesh whose data axes hold one rank). Every rank of a tp coordinate
    must hold the same values before the call (the same seeded init or the
    same ``init_params``): each keeps its own shard of them."""
    from torch.distributed.fsdp import fully_shard

    from .mesh import axis_sizes

    sizes = axis_sizes(mesh)
    replicated = getattr(model, "REPLICATED_AXES", ())
    for name in ("tp", "ep"):
        ax = getattr(model, name, None)
        if name not in replicated and sizes.get(name, 1) != (ax.size if ax is not None else 1):
            raise ValueError(
                f"the mesh has {name}={sizes.get(name, 1)} but the model holds "
                f"{'whole tensors' if ax is None else f'{name}={ax.size} blocks'}: build it "
                f"with {type(model).__name__}(cfg, mesh=mesh)"
            )
    axes = data_axes(mesh.mesh_dim_names)
    if math.prod(sizes[a] for a in axes) == 1:
        return model
    if "fsdp" in axes:
        data_mesh = mesh[axes] if len(axes) > 1 else mesh["fsdp"]
    else:
        # dp alone: HSDP with a one-rank shard dimension. DeviceMesh slices
        # only what exists, so the same ranks are laid out again with an
        # fsdp axis of one after dp (a tp axis keeps its groups).
        from torch.distributed.device_mesh import DeviceMesh

        names = list(mesh.mesh_dim_names)
        at = names.index("dp") + 1
        full = DeviceMesh(mesh.device_type, mesh.mesh.unsqueeze(at),
                          mesh_dim_names=tuple(names[:at] + ["fsdp"] + names[at:]))
        data_mesh = full[("dp", "fsdp")]
    # FSDP2 wants one parameter dtype a unit: with bf16 parameters the f32
    # norm scales are units of their own (each is called as a module, so
    # its unit gathers it), leaving the matmul weights in the blocks and
    # the embedding and head in the root.
    mixed = len({p.dtype for p in model.parameters()}) > 1
    for block in filter(None, model.layers):  # a pp stage holds its layers only
        if mixed:
            for norm in (block.attn_norm, block.mlp_norm):
                fully_shard(norm, mesh=data_mesh)
        fully_shard(block, mesh=data_mesh)
    if mixed and model.final_norm is not None:
        fully_shard(model.final_norm, mesh=data_mesh)
    fully_shard(model, mesh=data_mesh)
    if getattr(model, "pp", None) is not None:
        from torch.distributed.fsdp import register_fsdp_forward_method

        from ..models.llama import PP_FORWARD_METHODS

        for name in PP_FORWARD_METHODS:
            register_fsdp_forward_method(model, name)
    return model


def full_tensor(t, splits: Sequence = ()):
    """The whole of ``t`` on every rank: a DTensor sharded on dim 0 over at
    most one mesh dimension (FSDP2's and HSDP's layouts) gathered with the
    c10d all-gather (each rank's rows padded to the ceil-sized chunk, the
    padding cut off after); then, for each ``(axis, dim)`` of ``splits``
    (:func:`param_splits`) whose axis splits dim ``dim``, the axis' blocks
    gathered along it. ``t`` itself if it is neither. ``DTensor.full_tensor`` would gather
    through functional collectives, which crash over gloo on CUDA tensors
    (torch 2.11)."""
    splits = cut_splits(splits)
    if splits:
        from .collectives import all_gather

        (ax, d), rest = splits[-1], splits[:-1]
        block = full_tensor(t, rest).movedim(d, 0).contiguous()
        return all_gather(block, ax.axis, ax.mesh).movedim(0, d)
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    local = t.to_local()
    shards = [(i, pl) for i, pl in enumerate(t.placements) if pl.is_shard()]
    if not shards:
        return local
    if len(shards) > 1 or shards[0][1].dim != 0:
        raise NotImplementedError(f"gathering a {t.placements} layout (only one Shard(0))")
    import torch
    import torch.distributed as dist

    group = t.device_mesh.get_group(shards[0][0])
    n, rows = dist.get_world_size(group), t.shape[0]
    chunk = -(-rows // n)
    padded = torch.zeros((chunk, *local.shape[1:]), dtype=local.dtype, device=local.device)
    padded[: local.shape[0]] = local
    out = torch.empty((n * chunk, *local.shape[1:]), dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(out, padded, group=group)
    return out[:rows]


def full_state_dict(model) -> dict:
    """The whole of each tensor of ``model.state_dict()`` on every rank (CPU
    tensors, in state-dict order), gathered from FSDP2's shards and tp's
    and ep's blocks; on a pp mesh, pp's head rows too, and the tensors of
    every stage, in one process's state-dict order."""
    whole = {name: full_tensor(t, model_splits(model, name)).detach().cpu()
             for name, t in model.state_dict().items()}
    pp = getattr(model, "pp", None)
    if pp is None:
        return whole
    import torch.distributed as dist

    stages = [None] * pp.size
    dist.all_gather_object(stages, whole, group=pp.mesh.get_group("pp"))
    merged = {k: v for stage in stages for k, v in stage.items()}
    return {name: merged[name] for name in model.whole().state_dict()}


def local_tensor(t):
    """This rank's part of ``t``: a DTensor's local shard, else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def local_nbytes(tensors) -> int:
    """Bytes this rank holds of ``tensors`` (DTensors count their local
    shard, a tp block its own bytes)."""
    return sum(local_tensor(t).nbytes for t in tensors)
