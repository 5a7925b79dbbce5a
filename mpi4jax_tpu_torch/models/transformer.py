"""Decoder transformer: the training step, and greedy decoding with a KV
cache.

Counterpart of ``mpi4jax_tpu/models/transformer.py`` on PyTorch: the
configuration and parameters (stacked ``(L, ...)`` leaves with the JAX
package's names, so carrying weights across is a copy per leaf), the
layer math, and

* training: :func:`make_global_train_step` (forward, backward and an
  SGD update; the streaming or chunked cross-entropy; per-layer
  recomputation with ``remat=True`` and the partial policies
  ``"dots"``, ``"names"`` and tuple save-lists) and its unsharded
  oracle :func:`reference_loss`.  With ``attn_impl="flash"`` the attention and
  its gradient run the hand-written CUDA flash-attention kernels.
* inference: :func:`make_global_decode` — a batched causal prefill over
  the prompt that fills the cache, then one cached step per generated
  token, greedy or drawn with JAX's threefry bits
  (``sampler="categorical"``); a long prompt's prefill runs the flash
  forward kernel (``prefill_impl="flash"``), and on the card the
  generate steps replay CUDA graphs — and its full-recompute oracles
  :func:`reference_greedy_decode` and :func:`reference_sample_decode`.

Both run over a ``(dp, tp, sp)`` mesh of ranks (the decoder over
``(dp, tp)``), given as the three 1-D sub-communicators of one world's
comm (``comm.sub("dp")`` ...): the batch split over dp, the sequence
over sp (ring or Ulysses attention), the projections over tp (the
Megatron f/g collectives; :func:`shard_params` cuts each rank's shards
and :func:`gather_params` joins them).  On one rank the comms are a
one-rank ``MeshComm``'s, every collective an identity.

Where the JAX package returns new arrays, the decoder here writes its
static KV cache in place (zeroed at the start of every call, each
position written once).  The training step returns new parameters and
leaves the caller's intact, as JAX's does, unless it was made with
``donate=True``: then it updates them in place.
"""

import contextlib
import functools
import math
import threading
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from mpi4jax_tpu_torch.ops import reductions
from mpi4jax_tpu_torch.ops._core import create_token
from mpi4jax_tpu_torch.ops.allreduce import allreduce
from mpi4jax_tpu_torch.parallel.longseq import (
    local_attention,
    ring_attention,
    ulysses_attention,
)
from mpi4jax_tpu_torch.utils import prng
from mpi4jax_tpu_torch.utils.runtime import (
    graph_capture,
    resolve_device,
    run_on_side_stream,
)

__all__ = [
    "TransformerConfig",
    "BlockParams",
    "TransformerParams",
    "init_params",
    "make_global_train_step",
    "make_global_decode",
    "reference_loss",
    "reference_greedy_decode",
    "reference_sample_decode",
    "CHECKPOINT_NAMES",
    "checkpoint_tag",
    "TP_SHARDED",
    "P",
    "param_specs",
    "shard_params",
    "gather_params",
    "config_from_jax",
    "params_from_jax",
    "params_to_numpy",
]

# checkpoint_name tags of the JAX package's layer; remat may name a
# tuple of them as a save-list, and "names" saves NAMES_SAVED (of which
# "mlp_out" keeps nothing, as in JAX: _recompute_layers)
CHECKPOINT_NAMES = ("qkv", "v_proj", "attn_out", "mlp_out")
NAMES_SAVED = ("qkv", "attn_out", "mlp_out")

_MM = torch.ops.aten.mm.default
_tag = threading.local()


@contextlib.contextmanager
def checkpoint_tag(name):
    """Tag the projection computed inside the block with ``name`` (one
    of :data:`CHECKPOINT_NAMES`), as the JAX layer's ``checkpoint_name``
    tags its output: a policy that saves ``name`` keeps the output of
    the block's ``aten.mm`` (a 3-D by 2-D ``@`` reaches the dispatcher
    as one), so the backward's recompute returns it without running the
    product again.  Inert outside a checkpointed region.

    ``"mlp_out"`` marks the MLP's output product, which no policy saves
    (:func:`_recompute_layers`); a custom ``mlp`` that ends in a product
    tags it so, or ``"dots"`` keeps that product for nothing."""
    prev = getattr(_tag, "name", None)
    _tag.name = name
    try:
        yield
    finally:
        _tag.name = prev


class TransformerConfig(NamedTuple):
    vocab: int = 64
    d_model: int = 32
    layers: int = 2
    heads: int = 4
    kv_heads: int = 2  # < heads = grouped-query attention
    head_dim: int = 8
    d_ff: int = 64
    eps: float = 1e-6
    # single-device attention of the training forward ("auto" / "flash"
    # / "xla", see parallel.longseq.local_attention): the one-rank
    # shortcut of ring/ulysses attention and Ulysses's full-sequence
    # attention across sp ranks (the ring across ranks runs its own
    # dense blocks); on one sp rank a function with local_attention's
    # (q, k, v, *, causal) signature is called instead
    attn_impl: str = "auto"
    # >0: the training loss in token chunks of this size (must divide the
    # sequence), each chunk's head matmul and logsumexp recomputed in the
    # backward, so the [B, S, V] logits are never held whole; 0 = one
    # streaming cross-entropy pass
    ce_chunk: int = 0


class BlockParams(NamedTuple):
    ln1: torch.Tensor  # (L, d)
    wq: torch.Tensor   # (L, d, Hq*dh)
    wk: torch.Tensor   # (L, d, Hkv*dh)
    wv: torch.Tensor   # (L, d, Hkv*dh)
    wo: torch.Tensor   # (L, Hq*dh, d)
    ln2: torch.Tensor  # (L, d)
    w1: torch.Tensor   # (L, d, F)
    w2: torch.Tensor   # (L, F, d)


class TransformerParams(NamedTuple):
    embed: torch.Tensor  # (V, d)
    blocks: BlockParams
    ln_f: torch.Tensor   # (d,)
    head: torch.Tensor   # (d, V)


class P(tuple):
    """A leaf's layout, the JAX package's ``PartitionSpec`` as a tuple:
    per dimension the name of the mesh axis it is cut over, or None
    where it is whole.  ``P(None, None, "tp")`` cuts the last of three
    dimensions over the ``"tp"`` ranks."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def dim(self, axis):
        """The dimension cut over ``axis``, or None."""
        return self.index(axis) if axis in self else None


def param_specs(tp_ax):
    """Each leaf's layout (:class:`P`): the tp shards live on the
    projections' head/ff dims; the rest is replicated."""
    blocks = BlockParams(
        ln1=P(None, None),
        wq=P(None, None, tp_ax),
        wk=P(None, None, tp_ax),
        wv=P(None, None, tp_ax),
        wo=P(None, tp_ax, None),
        ln2=P(None, None),
        w1=P(None, None, tp_ax),
        w2=P(None, tp_ax, None),
    )
    return TransformerParams(
        embed=P(None, None),
        blocks=blocks,
        ln_f=P(None),
        head=P(None, None),
    )


# which leaves are sharded over tp at all
TP_SHARDED = TransformerParams(
    embed=False,
    blocks=BlockParams(*("tp" in s for s in param_specs("tp").blocks)),
    ln_f=False,
    head=False,
)


def _leaves(p):
    """A parameter tree's leaves in the JAX package's tree order:
    ``embed``, the block fields, ``ln_f``, ``head`` (the dense model's
    or the MoE model's)."""
    return [p.embed, *p.blocks, p.ln_f, p.head]


def _from_leaves(leaves, like=None):
    """The tree of :func:`_leaves` back, of ``like``'s types (a
    ``TransformerParams`` by default)."""
    params_t, blocks_t = ((TransformerParams, BlockParams) if like is None
                          else (type(like), type(like.blocks)))
    n = len(blocks_t._fields)
    return params_t(embed=leaves[0], blocks=blocks_t(*leaves[1:1 + n]),
                    ln_f=leaves[1 + n], head=leaves[2 + n])


def _axis_name(comm, default):
    """The mesh axis a 1-D comm runs over (a proc comm has none: the
    ``default`` then names it)."""
    axes = getattr(comm, "axes", ())
    return axes[0] if len(axes) == 1 else default


def _cut(params, specs, comms):
    """This rank's shards of full ``params`` by ``specs``: each leaf
    cut on the dimension its spec names for each comm's axis, at the
    comm's rank; the rest copied whole (so the caller's tensors are
    never the step's)."""

    def cut(t, spec):
        t = t.detach()
        for comm, ax in comms:
            dim = spec.dim(ax)
            if dim is not None and comm.size > 1:
                n = t.shape[dim] // comm.size
                t = t.narrow(dim, comm.rank() * n, n)
        return t.clone(memory_format=torch.contiguous_format)

    return _from_leaves([cut(t, s) for t, s in zip(_leaves(params),
                                                  _leaves(specs))], params)


@torch.no_grad()
def _join(params, specs, comms):
    """The inverse of :func:`_cut`, a collective over each comm: each
    rank gets the full parameters."""
    from mpi4jax_tpu_torch.ops.collectives import allgather

    def join(t, spec):
        out = t.detach()
        for comm, ax in reversed(comms):
            dim = spec.dim(ax)
            if dim is not None and comm.size > 1:
                rows, _ = allgather(out, comm=comm)
                out = torch.cat(rows.unbind(0), dim=dim)
        return out.clone() if out.data_ptr() == t.data_ptr() else out

    return _from_leaves([join(t, s) for t, s in zip(_leaves(params),
                                                   _leaves(specs))], params)


def shard_params(params, comm_tp):
    """This rank's tp shards of full parameters (every rank passes the
    same ``params``): ``wq``, ``wk``, ``wv`` and ``w1`` cut on their last
    axis, ``wo`` and ``w2`` on axis 1 of the ``(L, F, d)`` stack, the
    rest replicated (:func:`param_specs`; copies, so a donated step's
    in-place update never writes the caller's tensors).  One rank:
    copies of every leaf."""
    ax = _axis_name(comm_tp, "tp")
    return _cut(params, param_specs(ax), [(comm_tp, ax)])


def gather_params(params, comm_tp):
    """The full parameters from every tp rank's shards (each rank gets
    them all): the inverse of :func:`shard_params`, a collective over
    ``comm_tp``."""
    ax = _axis_name(comm_tp, "tp")
    return _join(params, param_specs(ax), [(comm_tp, ax)])


def _param_shapes(cfg):
    c = cfg
    L, d, dh = c.layers, c.d_model, c.head_dim
    blocks = BlockParams(
        ln1=(L, d), wq=(L, d, c.heads * dh), wk=(L, d, c.kv_heads * dh),
        wv=(L, d, c.kv_heads * dh), wo=(L, c.heads * dh, d), ln2=(L, d),
        w1=(L, d, c.d_ff), w2=(L, c.d_ff, d),
    )
    return TransformerParams(embed=(c.vocab, d), blocks=blocks, ln_f=(d,),
                             head=(d, c.vocab))


def init_params(cfg, *, generator, dtype=torch.float32, device="cuda"):
    """Parameters drawn from ``generator``: unit norms, and projections
    normal with std ``1/sqrt(fan_in)`` as the JAX package's
    ``init_params`` (the draws themselves differ: a ``torch.Generator``
    is not JAX's key stream).  Drawn in f32 on the generator's device,
    then cast to ``dtype`` on ``device``."""
    device = resolve_device(device)
    shapes = _param_shapes(cfg)

    def norm(shape, fan_in):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * (1.0 / math.sqrt(fan_in))).to(device=device, dtype=dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    s = shapes.blocks
    d, hd = cfg.d_model, cfg.heads * cfg.head_dim
    blocks = BlockParams(
        ln1=ones(s.ln1), wq=norm(s.wq, d), wk=norm(s.wk, d),
        wv=norm(s.wv, d), wo=norm(s.wo, hd), ln2=ones(s.ln2),
        w1=norm(s.w1, d), w2=norm(s.w2, cfg.d_ff),
    )
    return TransformerParams(
        embed=norm(shapes.embed, d), blocks=blocks, ln_f=ones(shapes.ln_f),
        head=norm(shapes.head, d),
    )


def _check_tp_divisibility(cfg, tp):
    for name, heads in (("heads", cfg.heads), ("kv_heads", cfg.kv_heads)):
        if heads % tp:
            raise ValueError(
                f"cfg.{name}={heads} must be divisible by the tensor-"
                f"parallel size {tp} (each tp rank owns "
                f"{name}/tp heads; for MQA-style configs with fewer kv "
                f"heads than tp ranks, replicate kv heads to tp first)"
            )


def _layer(blocks, i):
    """Layer ``i``'s slice of the stacked block parameters (of the
    blocks' own type: the dense model's or the MoE model's)."""
    return type(blocks)(*(t[i] for t in blocks))


def _rmsnorm(x, g, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g


class _FCollective(torch.autograd.Function):
    """Megatron "f": identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        out, _ = allreduce(grad, reductions.SUM, comm=ctx.comm)
        return out, None


def _f_collective(x, comm, token):
    """Megatron "f" over ``comm``; returns ``(x, token)``."""
    return _FCollective.apply(x, comm), token


def _dense_mlp(h2, bp, cfg, comm_tp, comm_sp, token):
    """Megatron MLP: column-sharded up, row-sharded down, g-allreduce.
    ``jax.nn.gelu`` is the tanh approximation, and so is this one."""
    h2, token = _f_collective(h2, comm_tp, token)
    m_part = F.gelu(h2 @ bp.w1, approximate="tanh")
    with checkpoint_tag("mlp_out"):
        m_part = m_part @ bp.w2
    return allreduce(m_part, reductions.SUM, comm=comm_tp, token=token)


def _attn_residual(x, bp, cfg):
    """Unsharded attention sublayer: ln1 → QKV → causal attention → wo,
    plus the residual."""
    b, s, _ = x.shape
    h = _rmsnorm(x, bp.ln1, cfg.eps)
    q = (h @ bp.wq).reshape(b, s, cfg.heads, cfg.head_dim)
    k = (h @ bp.wk).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    v = (h @ bp.wv).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    attn = local_attention(q, k, v, causal=True, impl="xla")
    return x + attn.reshape(b, s, -1) @ bp.wo


def dense_layer(x, bp, cfg):
    """One full unsharded decoder layer (attention + dense MLP)."""
    x = _attn_residual(x, bp, cfg)
    h2 = _rmsnorm(x, bp.ln2, cfg.eps)
    return x + F.gelu(h2 @ bp.w1, approximate="tanh") @ bp.w2


# ---------------------------- training -----------------------------


def _recompute_layers(remat):
    """Validate ``remat`` as the JAX package's ``_forward_sharded`` does.
    Returns None without remat, else the ``context_fn`` of the layer's
    ``torch.utils.checkpoint`` (its default, ``noop_context_fn``, for
    ``remat=True``: recompute everything).

    The partial policies are selective activation checkpointing: the
    policy sees each dispatcher op of the layer's forward and saves the
    outputs it names; every other op runs again in the backward.
    ``"dots"`` (JAX's ``dots_with_no_batch_dims_saveable``) saves every
    ``aten.mm``: the projections, not the attention's batched products
    (``bmm``) nor the flash forward, which the dispatcher does not see
    (a ctypes launch).  ``"names"`` saves the products tagged ``"qkv"``
    and ``"attn_out"`` (:func:`checkpoint_tag`), a tuple exactly its
    tags.  Allocations are never saved: the flash kernels write into
    theirs outside autograd's version counters.

    Two tags sit elsewhere than the JAX layer's:

    * ``"mlp_out"``: JAX tags the MLP's output, which no backward reads
      (a residual add follows it), so JAX keeps no residual for it under
      any policy, ``"dots"`` included.  Here the backward's recompute
      ends once it has rebuilt the last tensor the layer's backward
      saved, the output product's inputs (torch's early stop, on by
      default), so that product never runs again; saving it would hold
      one ``[tokens, d]`` a layer unread.  No policy saves it.
    * ``"attn_out"``: JAX tags the attention's output after the
      tensor-parallel allreduce; here the ``wo`` product before it, the
      op that computes it (an eager recompute re-runs every op it does
      not replay, so tagging the allreduce's output would run the
      product again).  So the recompute runs the tp allreduce again,
      one more ``[tokens, d]`` allreduce a layer in every backward (a
      copy on one rank), with the same inputs and so the same result;
      JAX's does not.  Saving the collective's output instead would
      need the policy to see a process group's call, which no backend
      routes alike.  ``tests/test_torch_multirank_transformer.py``
      counts it.
    """
    if isinstance(remat, (tuple, list)) and not remat:
        # () is falsy: it would silently run without remat
        raise ValueError(
            "empty remat save-list; use remat=True for full remat or a "
            f"non-empty subset of {CHECKPOINT_NAMES}"
        )
    if not remat:
        return None
    if isinstance(remat, (tuple, list)):
        unknown = set(remat) - set(CHECKPOINT_NAMES)
        if unknown:
            raise ValueError(
                f"unknown checkpoint tag(s) {sorted(unknown)}; the "
                f"layer tags are {CHECKPOINT_NAMES}"
            )
        saved = frozenset(remat)
    elif remat is True:
        return noop_context_fn
    elif remat == "dots":
        saved = None
    elif remat == "names":
        saved = frozenset(NAMES_SAVED)
    else:
        raise ValueError(
            f"remat must be False, True, 'dots', 'names' or a "
            f"tuple of tag names, got {remat!r}"
        )

    def policy(ctx, func, *args, **kwargs):
        tag = getattr(_tag, "name", None)
        if func == _MM and tag != "mlp_out" and (saved is None
                                                 or tag in saved):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _sequence_attention(sequence, impl):
    """The layer's causal attention over ``comm_sp``: ``(q, k, v, comm,
    token) -> (out, token)`` through ring or ulysses attention with
    ``impl``, or, when ``impl`` is a function with ``local_attention``'s
    ``(q, k, v, *, causal)`` signature (a caller holding the flash
    kernels against their plain versions passes one), that function on
    the local block."""
    if sequence not in ("ring", "ulysses"):
        raise ValueError(
            f"sequence must be 'ring' or 'ulysses', got {sequence!r}"
        )
    if callable(impl):
        def attend(q, k, v, comm, token):
            if comm.size > 1:
                raise ValueError(
                    "a function as cfg.attn_impl runs on one sp rank; "
                    f"comm_sp has {comm.size}"
                )
            return impl(q, k, v, causal=True), token
        return attend
    seq_attn = ring_attention if sequence == "ring" else ulysses_attention

    def attend(q, k, v, comm, token):
        return seq_attn(q, k, v, comm, causal=True, token=token, impl=impl)

    return attend


def _forward_sharded(params, tokens, cfg, comm_tp, comm_sp, mlp=None,
                     sequence="ring", remat=False, return_hidden=False):
    """The forward on the local shard.

    ``tokens``: local [B, S] int.  Activations are replicated across tp.
    Returns ``(logits, aux)`` — [B, S, V] logits, or with
    ``return_hidden`` the [B, S, d] final hidden for the chunked loss,
    and the f32 sum of the MLP's auxiliary losses.

    ``mlp(h2, bp, cfg, comm_tp, comm_sp, token) -> (out, token)`` is the
    MLP sublayer (post-ln2), the dense Megatron pair by default; it may
    return ``(out, token, aux)`` with a scalar auxiliary loss, summed
    over the layers.  ``sequence`` picks the context-parallel scheme
    ("ring" or "ulysses"), ``cfg.attn_impl`` its single-device
    attention.  ``remat=True`` recomputes each layer in the backward
    (``torch.utils.checkpoint``): activation memory for one layer
    instead of all, at one more forward pass; ``"dots"``, ``"names"``
    and a tuple of :data:`CHECKPOINT_NAMES` keep some of the layer's
    products and recompute the rest (:func:`_recompute_layers`).  The
    gradients are the same.
    """
    mlp = mlp or _dense_mlp
    tp = comm_tp.size
    dh = cfg.head_dim
    hq_l, hk_l = cfg.heads // tp, cfg.kv_heads // tp
    b, s = tokens.shape
    # the MoE config has neither attn_impl nor ce_chunk: read both as
    # the JAX scaffold does, with their defaults
    attend = _sequence_attention(sequence,
                                 getattr(cfg, "attn_impl", "auto"))
    context_fn = _recompute_layers(remat)

    def layer(x, aux, bp):
        token = create_token()
        h = _rmsnorm(x, bp.ln1, cfg.eps)
        h, token = _f_collective(h, comm_tp, token)
        # the JAX layer's checkpoint_name tags, on the products
        with checkpoint_tag("qkv"):
            q = (h @ bp.wq).reshape(b, s, hq_l, dh)
            k = (h @ bp.wk).reshape(b, s, hk_l, dh)
        with checkpoint_tag("v_proj"):
            v = (h @ bp.wv).reshape(b, s, hk_l, dh)
        attn, token = attend(q, k, v, comm_sp, token)
        with checkpoint_tag("attn_out"):
            a_part = attn.reshape(b, s, hq_l * dh) @ bp.wo
        a, token = allreduce(a_part, reductions.SUM, comm=comm_tp,
                             token=token)
        x = x + a
        h2 = _rmsnorm(x, bp.ln2, cfg.eps)
        res = mlp(h2, bp, cfg, comm_tp, comm_sp, token)
        if len(res) > 2:  # (out, token, aux): auxiliary losses
            aux = aux + res[2]
        return x + res[0], aux

    x = params.embed[tokens]  # (B, S, d)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.layers):
        bp = _layer(params.blocks, i)
        if context_fn is not None:
            x, aux = checkpoint(layer, x, aux, bp, use_reentrant=False,
                                context_fn=context_fn)
        else:
            x, aux = layer(x, aux, bp)
    x = _rmsnorm(x, params.ln_f, cfg.eps)
    if return_hidden:
        return x, aux
    return x @ params.head, aux


def _nll(logits, targets):
    """Per-token ``lse - logits[target]`` in f32 (the picked log-
    probability's negative), from logits in any dtype."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return lse - picked.float()


def _ce(logits, targets):
    """Streaming cross-entropy: ``mean(lse - logits[target])``."""
    return _nll(logits, targets).mean()


def _ce_chunk_sum(x, head, targets):
    return _nll(x @ head, targets).sum()


def _ce_chunked(x, head, targets, chunk):
    """Chunked cross-entropy: the head matmul and the loss per token
    chunk, each chunk recomputed in the backward
    (``torch.utils.checkpoint``), so only one ``[B, chunk, V]`` block of
    logits lives at a time.  Same math as :func:`_ce` (per-chunk f32
    sums, one final divide).  ``x``: [B, S, d] final hidden; ``head``:
    [d, V]."""
    b, s, _ = x.shape
    if s % chunk:
        raise ValueError(
            f"ce_chunk={chunk} must divide the local sequence length "
            f"{s} (global seq / sp size)"
        )
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        total = total + checkpoint(
            _ce_chunk_sum, x[:, c0:c0 + chunk], head,
            targets[:, c0:c0 + chunk], use_reentrant=False,
        )
    return total / (b * s)


def make_global_train_step(comm_dp, comm_tp, comm_sp, cfg, lr=1e-1, *,
                           mlp=None, specs=None, sequence="ring",
                           remat=False, donate=False, device="cuda"):
    """The training step over a ``(dp, tp, sp)`` mesh of ranks: forward,
    backward and one SGD update.

    ``step(params, (tokens, targets)) -> (params, loss)``: ``params`` are
    this rank's tp shards (:func:`shard_params`); ``tokens`` and
    ``targets`` are the global ``[B, S]`` int batch (tensors or arrays;
    targets are the caller's shifted next tokens, shifted globally, as
    the shift crosses sp blocks), the same on every rank, of which the
    step takes this rank's ``(dp, sp)`` block.  ``loss`` is f32 of shape
    ``[1]``, the mean over the whole batch, the same on every rank.  The
    new parameters are new tensors and the caller's stay as they were,
    as in the JAX step; with ``donate=True`` the step updates the
    caller's tensors in place and returns them (the training-loop idiom
    ``params, loss = step(params, batch)``, without a second copy of the
    parameters at the update).  Both give the same numbers.

    ``mlp`` and ``specs`` substitute the MLP sublayer and the
    parameters' layout (a tree of :class:`P` like
    :func:`param_specs`'s; the MoE model passes its own).  A leaf cut
    over the sp comm's axis (the MoE model's experts) is this sp rank's
    own: its gradient already holds every sp rank's tokens (they reach
    it through the dispatch's transpose), so it is summed over dp only;
    every other leaf over dp and sp.  ``sequence`` picks the
    context-parallel scheme ("ring" or "ulysses"), ``remat`` recomputes
    each layer in the backward, all of it (``True``) or all but the
    products a policy saves (``"dots"``, ``"names"``, a tuple of
    :data:`CHECKPOINT_NAMES`; see :func:`_forward_sharded`);
    ``cfg.attn_impl="flash"`` runs the attention and its gradient through
    the flash kernels and ``cfg.ce_chunk`` chunks the loss.

    There is no mesh argument: the comms carry the layout.  Every rank
    of the mesh calls the step in the same order: its forward and
    backward run the mesh's collectives.
    """
    if sequence not in ("ring", "ulysses"):
        raise ValueError(
            f"sequence must be 'ring' or 'ulysses', got {sequence!r}"
        )
    n_data = float(comm_dp.size * comm_sp.size)
    _check_tp_divisibility(cfg, comm_tp.size)
    if sequence == "ulysses" and comm_sp.size > 1:
        for name, heads in (("heads", cfg.heads), ("kv_heads", cfg.kv_heads)):
            if (heads // comm_tp.size) % comm_sp.size:
                raise ValueError(
                    f"sequence='ulysses' needs cfg.{name}/tp divisible by "
                    f"the sp size: {heads}//{comm_tp.size} per tp rank, "
                    f"sp={comm_sp.size} (for GQA, repeat kv heads or use "
                    f"sequence='ring')"
                )
    _recompute_layers(remat)
    device = resolve_device(device)
    ce_chunk = getattr(cfg, "ce_chunk", 0)
    tp_ax, sp_ax = _axis_name(comm_tp, "tp"), _axis_name(comm_sp, "sp")
    specs = param_specs(tp_ax) if specs is None else specs
    for spec in _leaves(specs):
        unknown = set(spec) - {None, tp_ax, sp_ax}
        if unknown:
            raise ValueError(
                f"specs cut a leaf over {sorted(unknown)}; the step's "
                f"axes are tp {tp_ax!r} and sp {sp_ax!r}"
            )
    # per leaf: cut over sp (an expert leaf), so summed over dp only
    expert = [spec.dim(sp_ax) is not None for spec in _leaves(specs)]
    dp_comms = [c for c in (comm_dp,) if c.size > 1]
    data_comms = dp_comms + [c for c in (comm_sp,) if c.size > 1]
    dp_rank, sp_rank = comm_dp.rank(), comm_sp.rank()

    def summed(x, comms):
        for comm in comms:
            x, _ = allreduce(x, reductions.SUM, comm=comm)
        return x

    def sync_grad(g, is_expert):
        # Autograd sums nothing across ranks on its own: each rank holds
        # the gradient of its own block's loss (the ring's and Ulysses's
        # cotangents from the other sp ranks' losses included, by the
        # exchanges' transposes).  The f-collectives already made a
        # replicated leaf's gradient the full tp sum on every tp rank,
        # and a tp shard's is its own.  So every leaf is summed over the
        # (dp, sp) ranks and divided by n_data, the mean of the blocks'
        # losses; but an expert leaf only over dp: its sp ranks hold
        # other experts, and its gradient from every sp rank's tokens
        # came home through the alltoall's transpose.  (JAX's shard_map
        # AD also sums replicated leaves over tp and so divides those by
        # n_data * tp.)
        g = summed(g, dp_comms if is_expert else data_comms)
        return g if n_data == 1.0 else g.div_(n_data)

    def local_block(t, like):
        t = torch.as_tensor(t, device=like.device)
        b, s = t.shape
        for name, n, size in (("batch", b, comm_dp.size),
                              ("sequence", s, comm_sp.size)):
            if n % size:
                raise ValueError(
                    f"the global {name} length {n} must be divisible by "
                    f"its mesh axis's {size} ranks"
                )
        bl, sl = b // comm_dp.size, s // comm_sp.size
        return t[dp_rank * bl:(dp_rank + 1) * bl,
                 sp_rank * sl:(sp_rank + 1) * sl]

    def loss_fn(params, tokens, targets):
        out, aux = _forward_sharded(
            params, tokens, cfg, comm_tp, comm_sp, mlp=mlp,
            sequence=sequence, remat=remat, return_hidden=bool(ce_chunk),
        )
        if ce_chunk:
            return _ce_chunked(out, params.head, targets, ce_chunk) + aux
        return _ce(out, targets) + aux

    def step(params, batch):
        if params.embed.device.type != device.type:
            raise ValueError(
                f"params are on {params.embed.device}, the step was made "
                f"for {device}"
            )
        tokens, targets = (local_block(t, params.embed) for t in batch)
        leaves = _leaves(params)
        if len(leaves) != len(expert):
            raise ValueError(
                f"params have {len(leaves)} leaves, specs {len(expert)}")
        # the forward runs on detached views: the caller's tensors keep
        # their flags, and without donate their values
        views = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(_from_leaves(views, params), tokens, targets)
        grads = torch.autograd.grad(loss, views)
        del views
        # SGD, p <- p - lr * g (the gradient's buffer holds lr * g): new
        # tensors, or with donate the caller's overwritten in place
        with torch.no_grad():
            new = []
            for p, g, is_expert in zip(leaves, grads, expert):
                update = sync_grad(g, is_expert).mul_(lr)
                new.append(p.sub_(update) if donate else p - update)
            del grads
            params = _from_leaves(new, params)
            # the mean of the (dp, sp) blocks' losses (JAX: the psum over
            # every rank / (n_data * tp)); one rank: the identity
            loss = summed(loss.detach().reshape(1), data_comms) / n_data
        return params, loss

    return step


def reference_loss(params, tokens, targets, cfg):
    """Unsharded oracle: the same math on one device, dense attention."""
    x = params.embed[tokens]
    for i in range(cfg.layers):
        x = dense_layer(x, _layer(params.blocks, i), cfg)
    x = _rmsnorm(x, params.ln_f, cfg.eps)
    return _ce(x @ params.head, targets)


# --------------------------- inference -----------------------------


def _check_sampler(sampler, temperature, top_k, vocab):
    if sampler not in ("greedy", "categorical"):
        raise ValueError(
            f"sampler must be 'greedy' or 'categorical', got {sampler!r}"
        )
    if sampler == "greedy":
        # greedy ignores both knobs — setting one is a forgotten
        # sampler="categorical", not a request for deterministic output
        if temperature != 1.0 or top_k is not None:
            raise ValueError(
                "temperature/top_k only apply to sampler='categorical' "
                f"(got sampler='greedy' with temperature={temperature}, "
                f"top_k={top_k})"
            )
        return
    if not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if top_k is not None and (
        int(top_k) != top_k or not 0 < int(top_k) <= vocab
    ):
        raise ValueError(
            f"top_k must be an integer in (0, vocab={vocab}], got {top_k!r}"
        )


def _choose_token(logits, pos, key, row_ids, sampler, temperature, top_k):
    """The next token from ``[B, V]`` logits — the single copy shared by
    the decoder and the oracles, as in the JAX package.

    ``"greedy"``: the first index of the maximum (``jnp.argmax`` and
    ``torch.argmax`` agree).  ``"categorical"``: f32 logits over
    ``temperature`` (a float, or a 0-d f32 tensor on the logits' device:
    the card divides by a device divisor exactly, by a host scalar through
    its reciprocal), the ``top_k`` highest kept per row (ties at the
    threshold stay eligible), then a draw per row under
    ``fold_in(fold_in(key, pos), row_id)`` with JAX's threefry bits
    (:mod:`~mpi4jax_tpu_torch.utils.prng`).  ``pos`` is an int or a 0-d
    integer tensor, ``key`` an int64 ``(2,)`` tensor, ``row_ids`` the
    rows' global ids."""
    if sampler == "greedy":
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k is not None:
        thresh = torch.topk(logits, int(top_k), dim=-1).values[..., -1:]
        logits = torch.where(logits >= thresh, logits, -math.inf)
    row_keys = prng.fold_in(prng.fold_in(key, pos), row_ids)
    return prng.categorical(row_keys, logits)


def _new_cache(cfg, b, max_len, hk_l, like):
    return torch.zeros(
        (cfg.layers, 2, b, max_len, hk_l, cfg.head_dim),
        dtype=like.dtype, device=like.device,
    )


def _decode_step_sharded(params, cache, last_tok, pos, cfg, comm_tp, hq_l,
                         hk_l):
    """One decode step on the local tp shard: embed the last token,
    write its K/V at ``pos`` (in place), attend over the cache view
    with positions <= ``pos`` visible, run the MLP, and return the
    position's logits — the caller picks the next token.

    ``cache``: (layers, 2, B, S_view, Hkv_local, dh), a view of the
    decoder's cache; ``last_tok``: (B,) int; ``pos``: a 0-d int64 tensor
    on the cache's device.  The position is read by the kernels, never by
    the host, so a CUDA graph can capture the step.  Returns
    ``(cache, logits)``.
    """
    dh = cfg.head_dim
    b = last_tok.shape[0]
    at = pos.view(1)
    x = params.embed[last_tok][:, None, :]  # (B, 1, d)
    token = None
    for i in range(cfg.layers):
        bp = _layer(params.blocks, i)
        h = _rmsnorm(x, bp.ln1, cfg.eps)
        h, token = _f_collective(h, comm_tp, token)
        q = (h @ bp.wq).reshape(b, 1, hq_l, dh)
        cache[i, 0].index_copy_(1, at, (h @ bp.wk).reshape(b, 1, hk_l, dh))
        cache[i, 1].index_copy_(1, at, (h @ bp.wv).reshape(b, 1, hk_l, dh))
        # attend over positions <= pos (masked full-view attention;
        # q_offset=pos makes the causal mask pass exactly those; the
        # dense path takes a tensor offset, the flash one would not)
        attn = local_attention(
            q, cache[i, 0], cache[i, 1], causal=True, q_offset=pos,
            impl="xla",
        )
        a_part = attn.reshape(b, 1, hq_l * dh) @ bp.wo
        a, token = allreduce(a_part, reductions.SUM, comm=comm_tp,
                             token=token)
        x = x + a
        h2 = _rmsnorm(x, bp.ln2, cfg.eps)
        m, token = _dense_mlp(h2, bp, cfg, comm_tp, None, token)
        x = x + m
    x = _rmsnorm(x, params.ln_f, cfg.eps)
    return cache, (x @ params.head)[:, 0, :]  # (B, V)


def _attention_fn(impl):
    """The prefill's causal attention: ``local_attention`` with ``impl``
    ("xla", "flash" or "auto"), or ``impl`` itself when it is a function
    with ``local_attention``'s ``(q, k, v, *, causal)`` signature (a
    caller holding the flash kernel against its plain version passes
    one)."""
    if callable(impl):
        return impl

    def attend(q, k, v, *, causal):
        return local_attention(q, k, v, causal=causal, impl=impl)

    return attend


def _prefill_sharded(params, prompt, cfg, comm_tp, hq_l, hk_l, max_len,
                     impl="xla", logits_pos=None, cache=None):
    """Batched prefill on the local tp shard: one causal forward pass
    over the whole prompt, writing every prompt position's K/V into a
    new ``max_len`` cache, whose later positions stay zero, or into
    ``cache`` (zero past the prompt) when one is given.

    Identical math to running :func:`_decode_step_sharded` position by
    position.  Returns ``(cache, logits)`` with the last prompt
    position's ``[B, V]`` logits, or those of position ``logits_pos``.
    ``impl`` is passed to ``local_attention`` (see :func:`_attention_fn`).
    """
    attend = _attention_fn(impl)
    dh = cfg.head_dim
    b, p_len = prompt.shape
    x = params.embed[prompt]  # (B, P, d)
    if cache is None:
        cache = _new_cache(cfg, b, max_len, hk_l, params.embed)
    token = None
    for i in range(cfg.layers):
        bp = _layer(params.blocks, i)
        h = _rmsnorm(x, bp.ln1, cfg.eps)
        h, token = _f_collective(h, comm_tp, token)
        q = (h @ bp.wq).reshape(b, p_len, hq_l, dh)
        k = (h @ bp.wk).reshape(b, p_len, hk_l, dh)
        v = (h @ bp.wv).reshape(b, p_len, hk_l, dh)
        attn = attend(q, k, v, causal=True)
        a_part = attn.reshape(b, p_len, hq_l * dh) @ bp.wo
        a, token = allreduce(a_part, reductions.SUM, comm=comm_tp,
                             token=token)
        x = x + a
        h2 = _rmsnorm(x, bp.ln2, cfg.eps)
        m, token = _dense_mlp(h2, bp, cfg, comm_tp, None, token)
        x = x + m
        cache[i, 0, :, :p_len] = k
        cache[i, 1, :, :p_len] = v
    last = x[:, -1] if logits_pos is None else x[:, logits_pos]
    return cache, _rmsnorm(last, params.ln_f, cfg.eps) @ params.head


def _segments(start, max_len, kv_bucket):
    """The generate loop's segments ``(view_len, first, stop)``: positions
    ``first..stop-1`` read a cache view of ``view_len`` positions.  Without
    ``kv_bucket`` one segment on the whole cache; with it, bucketed KV
    growth: segment s runs positions [prev, min(end_s, max_len-1)) on a
    view of length end_s, so each step reads ceil((pos+1)/N)·N positions,
    not max_len.  Empty segments are left out."""
    if kv_bucket is None:
        ends = [max_len]
    else:
        ends = list(range((start // kv_bucket + 1) * kv_bucket, max_len,
                          kv_bucket))
        ends.append(max_len)
    segments = []
    prev = start
    for end in ends:
        hi = min(end, max_len - 1)
        if hi > prev:
            segments.append((end, prev, hi))
            prev = hi
    return segments


class _DecodeLoop:
    """The decoder's state for one batch, prompt length and dtype: static
    buffers and the generate step that reads and writes only them.

    ``out`` (the tokens), ``cache`` (the KV cache), ``pos`` (the step's
    position, a 0-d int64 tensor), ``key`` and ``row_ids`` (the sampler's
    key and the rows' ids) live as long as the loop, so a CUDA graph of
    :meth:`step` replays on them: the JAX package's jitted ``scan`` body,
    with the position read and advanced on the device.
    """

    def __init__(self, params, prompt, cfg, max_len, *, comm_tp, batched,
                 kv_bucket, prefill_impl, sampler, temperature, top_k,
                 row0=0):
        tp = comm_tp.size
        self.hq_l, self.hk_l = cfg.heads // tp, cfg.kv_heads // tp
        b, self.p_len = prompt.shape
        if self.p_len > max_len:
            raise ValueError(
                f"prompt length {self.p_len} exceeds max_len={max_len} "
                f"(the decoder's static sequence budget)"
            )
        self.cfg, self.max_len, self.comm_tp = cfg, max_len, comm_tp
        self.prefill_impl, self.sampler, self.top_k = (prefill_impl,
                                                       sampler, top_k)
        device = params.embed.device
        self.out = torch.zeros((b, max_len), dtype=prompt.dtype,
                               device=device)
        self.cache = _new_cache(cfg, b, max_len, self.hk_l, params.embed)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.key = torch.zeros(2, dtype=torch.int64, device=device)
        # global row ids: the sampler folds them in, so the draws do not
        # depend on the dp split
        self.row_ids = row0 + torch.arange(b, device=device)
        self.temperature = torch.full((), temperature, dtype=torch.float32,
                                      device=device)
        self.batched = batched and self.p_len > 1
        start = self.p_len if self.batched else 0
        self.segments = _segments(start, max_len, kv_bucket)
        self.n_steps = sum(stop - first for _, first, stop in self.segments)

    def choose(self, logits, pos):
        return _choose_token(
            logits, pos, self.key, self.row_ids, self.sampler,
            self.temperature, self.top_k,
        ).to(self.out.dtype)

    def prepare(self, params, prompt, key):
        """Eager part: the buffers reset (the cache to zero, as the JAX
        decoder starts from a fresh one, so no earlier call's positions
        reach this one: masking alone would not, since 0 × NaN is NaN),
        the prompt in ``out``, and with the batched prefill its K/V and the
        first generated token."""
        self.out.zero_()
        self.out[:, :self.p_len] = prompt
        self.cache.zero_()
        if key is not None:
            self.key.copy_(key)
        if self.batched:
            _, logits = _prefill_sharded(
                params, prompt, self.cfg, self.comm_tp, self.hq_l,
                self.hk_l, self.max_len, impl=self.prefill_impl,
                cache=self.cache,
            )
            if self.p_len < self.max_len:
                # the token at position p_len is chosen from position
                # p_len - 1's logits
                self.out[:, self.p_len] = self.choose(logits, self.p_len - 1)

    def step(self, params, view_len):
        """One generate step at ``pos`` on the cache's first ``view_len``
        positions; advances ``pos``.  No host synchronisation: this is
        what a graph captures."""
        at = self.pos.view(1)
        _, logits = _decode_step_sharded(
            params, self.cache[:, :, :, :view_len],
            self.out.index_select(1, at)[:, 0], self.pos, self.cfg,
            self.comm_tp, self.hq_l, self.hk_l,
        )
        # inside the prompt, keep the given token; past it, append the
        # chosen one
        nxt = at + 1
        cur = self.out.index_select(1, nxt)[:, 0]
        write = torch.where(nxt < self.p_len, cur, self.choose(logits,
                                                                self.pos))
        self.out.index_copy_(1, nxt, write[:, None])
        self.pos.add_(1)

    def run(self, params, prompt, key, replay):
        """The decode: :meth:`prepare`, then each segment as ``pos`` set to
        its first position and one ``replay(view_len)`` per position.
        Returns ``out`` (the static buffer)."""
        self.prepare(params, prompt, key)
        for view_len, first, stop in self.segments:
            self.pos.fill_(first)
            for _ in range(stop - first):
                replay(view_len)
        return self.out


def _greedy_decode(params, prompt, cfg, max_len, *, comm_tp, batched,
                   kv_bucket, prefill_impl, sampler="greedy", key=None,
                   temperature=1.0, top_k=None):
    """The decoder behind :func:`make_global_decode`, eager, on fresh
    buffers (arguments already validated): every step a direct call.
    ``prompt``: [B, P] int on the parameters' device; ``key``: an int64
    ``(2,)`` tensor there, for ``sampler="categorical"``.  The card's
    graph replays are held to it."""
    loop = _DecodeLoop(
        params, prompt, cfg, max_len, comm_tp=comm_tp, batched=batched,
        kv_bucket=kv_bucket, prefill_impl=prefill_impl, sampler=sampler,
        temperature=temperature, top_k=top_k,
    )
    return loop.run(params, prompt, key,
                    lambda view_len: loop.step(params, view_len))


def _capture_steps(loop, params, capture_error_mode=None):
    """One CUDA graph of ``loop.step`` per view length of the loop's
    segments, in segment order, all in one memory pool: each graph's
    temporaries die inside it and every live output is a static buffer
    allocated outside the captures, so the graphs can share the pool.
    Over NCCL each graph holds the step's tp allreduces; every tp rank
    captures the same view lengths in the same order (the segments
    depend only on the prompt length, ``max_len`` and ``kv_bucket``)."""
    pool = torch.cuda.graph_pool_handle()
    graphs = {}
    for view_len, _, _ in loop.segments:
        graph = torch.cuda.CUDAGraph()
        try:
            with graph_capture(graph, pool, capture_error_mode):
                loop.step(params, view_len)
        except RuntimeError as exc:
            raise RuntimeError(
                f"CUDA graph capture of the decode step on a {view_len}-"
                f"position cache view failed: {exc}"
            ) from exc
        graphs[view_len] = graph
    return graphs


def make_global_decode(comm_dp, comm_tp, cfg, max_len, *, prefill="batched",
                       kv_bucket=None, prefill_impl="xla", sampler="greedy",
                       temperature=1.0, top_k=None, device="cuda"):
    """Autoregressive decoder over a ``(dp, tp)`` mesh of ranks, greedy
    or sampled.

    ``decode(params, prompt)``: ``params`` are this rank's tp shards
    (:func:`shard_params`), each tp rank holding a KV cache of
    ``kv_heads / tp`` heads; ``prompt`` is the global ``[B, P]`` int
    batch (a tensor or array), the same on every rank, of which each dp
    rank decodes its ``B / dp`` rows.  ``prefill="batched"`` (default)
    processes the whole prompt in one causal forward pass that fills the
    KV cache;
    ``prefill="stepwise"`` runs the prompt position by position through
    the cached step (same math).  Then generates ``max_len - P`` tokens.
    Returns the global ``[B, max_len]`` on ``device`` on every rank (the
    dp ranks' rows gathered), in the prompt's dtype: the prompt followed
    by the continuation.  Every tp rank chooses the same tokens: their
    logits come out of the same allreduces.  Greedy matches
    :func:`reference_greedy_decode`.

    ``sampler="categorical"`` draws each continuation token from the
    (temperature-scaled, optionally top-k-truncated) softmax; the decoder
    then takes a key, ``decode(params, prompt, key)`` (a
    ``jax.random.PRNGKey``'s ``uint32[2]`` as an array or tensor, or a
    typed key), and matches :func:`reference_sample_decode` and the JAX
    package's decoder token for token: the draws use JAX's threefry bits.

    ``prefill_impl`` picks the batched prefill's attention: ``"xla"``
    (dense scores) or ``"flash"`` (the flash kernel; on the card, the
    hand-written CUDA kernel) for long prompts.  ``kv_bucket=N`` runs
    the generate loop on a cache view whose length grows by N per
    segment, so each step reads ``ceil((pos+1)/N)·N`` positions instead
    of the full ``max_len`` budget; token-exact against the un-bucketed
    loop.

    The JAX decoder is one jitted executable; here the prefill runs
    eagerly and the generate loop on static buffers (:class:`_DecodeLoop`)
    that live across calls, as ``jit`` keeps its executable, keyed by the
    batch, the prompt length, the dtypes and every parameter leaf's
    ``data_ptr()``; a new key drops the old state.  On the CPU each step
    is a direct call.  On the card the first call for a key runs eagerly
    on a side stream, then captures one CUDA graph of the step per cache
    view length; every later call replays them, one replay a position,
    after setting the position at each segment's start.  Over NCCL the
    graphs hold the tp allreduces (captured in ``"thread_local"`` mode:
    NCCL's watchdog queries the device meanwhile); a world with a gloo
    group (a local world of thread ranks on one card) runs the steps
    eagerly, as ``make_multistep`` does: gloo stages through host
    memory, which a graph cannot hold.  A capture that fails raises;
    nothing on the card falls back to the eager loop.
    Every call returns a new tensor, so a later call never overwrites an
    earlier result.  ``decode.captures`` counts the graphs captured and
    ``decode.replays`` the steps replayed (eager: the direct calls).

    There is no mesh argument: the comms carry the layout.  Every rank
    of the mesh calls the decoder in the same order.
    """
    _check_tp_divisibility(cfg, comm_tp.size)
    if prefill not in ("batched", "stepwise"):
        raise ValueError(
            f"prefill must be 'batched' or 'stepwise', got {prefill!r}"
        )
    if prefill_impl not in ("xla", "flash"):
        raise ValueError(
            f"prefill_impl must be 'xla' or 'flash', got {prefill_impl!r}"
        )
    _check_sampler(sampler, temperature, top_k, cfg.vocab)
    if kv_bucket is not None and (
        int(kv_bucket) != kv_bucket or not 0 < int(kv_bucket) <= max_len
    ):
        raise ValueError(
            f"kv_bucket must be an integer in (0, max_len={max_len}], "
            f"got {kv_bucket!r}"
        )
    device = resolve_device(device)
    bucket = None if kv_bucket is None else int(kv_bucket)
    state = {"sig": None, "loop": None, "graphs": None}
    transports = [c.transport() for c in (comm_dp, comm_tp)]
    # a gloo group stages through host memory: no graph can hold it
    captures = all(t is None or t.backend == "nccl" for t in transports)
    mode = None if all(t is None for t in transports) else "thread_local"
    dp, dp_rank = comm_dp.size, comm_dp.rank()

    def loop_for(params, prompt):
        sig = (tuple(prompt.shape), prompt.dtype, params.embed.dtype,
               tuple(t.data_ptr() for t in _leaves(params)))
        if state["sig"] != sig:
            state.update(sig=None, loop=None, graphs=None)  # free them first
            state["loop"] = _DecodeLoop(
                params, prompt, cfg, max_len, comm_tp=comm_tp,
                batched=prefill == "batched", kv_bucket=bucket,
                prefill_impl=prefill_impl, sampler=sampler,
                temperature=temperature, top_k=top_k,
                row0=dp_rank * prompt.shape[0],
            )
            state["sig"] = sig
        return state["loop"]

    def local_rows(prompt):
        b = prompt.shape[0]
        if b % dp:
            raise ValueError(
                f"the global batch {b} must be divisible by the {dp} dp "
                f"ranks"
            )
        return prompt[dp_rank * (b // dp):(dp_rank + 1) * (b // dp)]

    def gather_rows(out):
        """The dp ranks' rows in rank order: the global batch."""
        if dp == 1:
            return out
        from mpi4jax_tpu_torch.ops.collectives import allgather

        rows, _ = allgather(out, comm=comm_dp)
        return rows.reshape(-1, out.shape[1])

    @torch.no_grad()
    def run(params, prompt, key):
        if params.embed.device.type != device.type:
            raise ValueError(
                f"params are on {params.embed.device}, the decoder was "
                f"made for {device}"
            )
        prompt = local_rows(torch.as_tensor(prompt,
                                            device=params.embed.device))
        if key is not None:
            key = prng.raw_key(key, params.embed.device)
        loop = loop_for(params, prompt)
        graphed = device.type == "cuda" and captures
        if graphed and state["graphs"] is None:
            out = run_on_side_stream(lambda: loop.run(
                params, prompt, key, lambda n: loop.step(params, n)).clone(),
                params.embed.device)
            state["graphs"] = _capture_steps(loop, params, mode)
            decode.captures += len(state["graphs"])
            return gather_rows(out)
        if graphed:
            graphs = state["graphs"]

            def replay(view_len):
                graphs[view_len].replay()
        else:
            def replay(view_len):
                loop.step(params, view_len)
        out = loop.run(params, prompt, key, replay).clone()
        decode.replays += loop.n_steps
        return gather_rows(out)

    if sampler == "greedy":
        def decode(params, prompt):
            return run(params, prompt, None)
    else:
        def decode(params, prompt, key):
            return run(params, prompt, key)

    decode.captures = 0
    decode.replays = 0
    return decode


def _oracle_decode(params, prompt, cfg, max_len, choose):
    """Full-sequence recompute per position, dense attention
    (``impl="xla"``); ``choose(logits, pos)`` picks each next token."""
    b, p_len = prompt.shape
    if p_len > max_len:
        raise ValueError(
            f"prompt length {p_len} exceeds max_len={max_len}"
        )
    out = torch.zeros((b, max_len), dtype=prompt.dtype, device=prompt.device)
    out[:, :p_len] = prompt
    for pos in range(max_len - 1):
        x = params.embed[out]
        for i in range(cfg.layers):
            x = dense_layer(x, _layer(params.blocks, i), cfg)
        x = _rmsnorm(x, params.ln_f, cfg.eps)
        logits = x[:, pos] @ params.head  # (B, V)
        if pos + 1 >= p_len:
            out[:, pos + 1] = choose(logits, pos)
    return out


@torch.no_grad()
def reference_greedy_decode(params, prompt, cfg, max_len):
    """Unsharded oracle: full-sequence recompute per position, dense
    attention (``impl="xla"``).  ``prompt``: ``[B, P]`` int tensor on the
    parameters' device."""
    return _oracle_decode(
        params, prompt, cfg, max_len,
        lambda logits, pos: _choose_token(logits, pos, None, None, "greedy",
                                          1.0, None),
    )


@torch.no_grad()
def reference_sample_decode(params, prompt, cfg, max_len, key, *,
                            temperature=1.0, top_k=None):
    """Unsharded sampling oracle: full-sequence recompute per position,
    next tokens drawn through the same :func:`_choose_token` (a per-row
    ``fold_in`` of the position and the row id) as the decoder, so
    ``make_global_decode(..., sampler="categorical")`` matches it token
    for token given the same key.  ``key`` as for the decoder."""
    _check_sampler("categorical", temperature, top_k, cfg.vocab)
    device = params.embed.device
    key = prng.raw_key(key, device)
    row_ids = torch.arange(prompt.shape[0], device=device)
    temp = torch.full((), temperature, dtype=torch.float32, device=device)
    return _oracle_decode(
        params, prompt, cfg, max_len,
        lambda logits, pos: _choose_token(
            logits, pos, key, row_ids, "categorical", temp, top_k,
        ).to(prompt.dtype),
    )


# ------------------- weights carried across ------------------------


def config_from_jax(cfg_fields):
    """The port's :class:`TransformerConfig` from a dict of the JAX
    ``TransformerConfig``'s fields (``jax_cfg._asdict()``)."""
    unknown = set(cfg_fields) - set(TransformerConfig._fields)
    if unknown:
        raise ValueError(
            f"unknown TransformerConfig fields {sorted(unknown)}"
        )
    return TransformerConfig(**cfg_fields)


def params_from_jax(arrays, cfg, *, dtype=torch.float32, device="cuda",
                    comm_tp=None):
    """Port parameters on ``device`` from the JAX ``TransformerParams``
    leaves as numpy arrays (the same structure: ``embed``, ``blocks``
    with its eight fields, ``ln_f``, ``head``).  bf16 arrives as
    ``ml_dtypes.bfloat16`` numpy; every leaf goes through float32, which
    holds bf16 exactly, and is cast to ``dtype``.  With ``comm_tp``, the
    full parameters land as this rank's tp shards
    (:func:`shard_params`)."""
    device = resolve_device(device)
    shapes = _param_shapes(cfg)

    def leaf(name, a, shape):
        a = np.asarray(a)
        if a.shape != tuple(shape):
            raise ValueError(
                f"{name} has shape {a.shape}, expected {tuple(shape)}"
            )
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=dtype
        )

    blocks = BlockParams(*(
        leaf(f"blocks.{name}", getattr(arrays.blocks, name), shape)
        for name, shape in zip(BlockParams._fields, shapes.blocks)
    ))
    params = TransformerParams(
        embed=leaf("embed", arrays.embed, shapes.embed),
        blocks=blocks,
        ln_f=leaf("ln_f", arrays.ln_f, shapes.ln_f),
        head=leaf("head", arrays.head, shapes.head),
    )
    if comm_tp is None or comm_tp.size == 1:
        return params
    return shard_params(params, comm_tp)


def params_to_numpy(params):
    """The parameters as numpy arrays, same structure; bf16 leaves come
    back as float32 (numpy has no bfloat16), which holds them exactly."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return TransformerParams(
        embed=leaf(params.embed),
        blocks=BlockParams(*(leaf(t) for t in params.blocks)),
        ln_f=leaf(params.ln_f),
        head=leaf(params.head),
    )
