"""Expert parallelism built on the ``alltoall`` building block.

Counterpart of ``mpi4jax_tpu/parallel/moe.py`` on PyTorch: tokens
bucketed by destination expert, one ``alltoall`` to deliver each expert
its work, expert computation local, and the inverse ``alltoall`` and
unsort (or gate-weighted scatter-add) to put results back in token
order.  Differentiable end to end (``alltoall`` transposes to itself),
on any comm of the port (a mesh comm or a proc comm).

Every selection is exact and ordered as the JAX package's:
``lax.top_k`` puts the lower index first among equal values, and
``torch.topk`` promises no order among them, so the top ``k`` here are
the first ``k`` of a stable descending sort (:func:`top_k`).
"""

import torch

from mpi4jax_tpu_torch.ops._core import as_token
from mpi4jax_tpu_torch.ops.collectives import alltoall, alltoall_multi

__all__ = [
    "expert_dispatch",
    "expert_combine",
    "default_capacity",
    "topk_route",
    "topk_moe",
    "load_balancing_loss",
    "router_z_loss",
    "dropped_fraction",
]


def top_k(x, k):
    """``lax.top_k`` over the last axis: ``(values, indices)`` of the
    ``k`` largest, in descending order, the lower index first among
    equal values (a stable descending sort, cut to ``k``)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def gate_sum(x, idx, gate, vals):
    """The gate-weighted scatter-add of the experts' results onto the
    tokens they came from: ``Σ_e`` over the experts in order of
    ``gate[e] · vals[e]`` added to rows ``idx[e]`` of zeros shaped like
    ``x`` (``idx``, ``gate``: ``(E, cap)``; ``vals``: ``(E, cap, d)``).

    Each expert's row of ``idx`` names distinct tokens (a top-k over
    them), so one ``index_add`` per expert adds at most one value to a
    row, and every token's sum runs in expert order, the order of the
    JAX package's scatter-add.  A single ``index_add`` of all experts
    would add colliding rows on the card by atomics in no fixed order,
    which would let the tp replicas of one rank's experts, each
    computing the same sum, drift apart in the last bits."""
    weighted = gate[..., None] * vals
    y = torch.zeros_like(x)
    for e in range(idx.shape[0]):
        y = y.index_add(0, idx[e], weighted[e])
    return y


def load_balancing_loss(probs, k=1):
    """Switch/GShard auxiliary load-balancing loss, generalised top-k:
    ``E * Σ_e f_e · P_e`` with ``f_e`` the fraction of the ``T*k``
    routing assignments that chose expert ``e`` (before capacity) and
    ``P_e`` the mean router probability of ``e``.  1 at perfect
    balance, up to ``E`` at full collapse.  The gradient flows through
    ``P`` only (``f`` is discrete and detached).

    Args:
      probs: ``(T, E)`` post-softmax router probabilities.
      k: experts per token the router selects.
    """
    t, n_experts = probs.shape
    _, top = top_k(probs, k)
    chosen = torch.zeros((t, n_experts), dtype=probs.dtype,
                         device=probs.device).scatter_(1, top, 1.0)
    f = (chosen.sum(0) / (t * k)).detach()
    return n_experts * torch.sum(f * probs.mean(0))


def router_z_loss(logits):
    """Router z-loss (ST-MoE): the mean squared ``logsumexp`` of the
    ``(T, E)`` router logits."""
    z = torch.logsumexp(logits, dim=-1)
    return torch.mean(torch.square(z))


def dropped_fraction(valid, n_tokens, k=1):
    """Fraction of the ``n_tokens * k`` routing assignments that
    overflowed expert capacity (``valid`` as :func:`topk_route` returns
    it); 0 = nothing dropped.  A 0-d float32 tensor."""
    kept = valid.sum(dtype=torch.float32)
    return 1.0 - kept / (n_tokens * k)


def expert_dispatch(x, expert_idx, comm, *, token=None):
    """Route tokens to experts (expert e = rank e of ``comm``).

    Args:
      x: ``(T, d)`` local tokens; ``T`` must be divisible by
        ``comm.size``.
      expert_idx: ``(T,)`` int, the destination expert per token; must
        be balanced: exactly ``T // n_experts`` tokens per expert.
      comm: a 1-D comm, one expert per rank.

    Returns ``(expert_input, order, token)``: ``expert_input`` is
    ``(n_ranks, capacity, d)``, this rank's expert's tokens, one block
    per source rank, and ``order`` the local sort permutation that
    :func:`expert_combine` undoes.
    """
    token = as_token(token)
    n = comm.size
    t_local, d = x.shape
    if t_local % n:
        raise ValueError(
            f"token count {t_local} not divisible by {n} experts"
        )
    cap = t_local // n
    # stable bucket-by-expert; balance makes the reshape exact
    order = torch.argsort(torch.as_tensor(expert_idx, device=x.device),
                          stable=True)
    buckets = x[order].reshape(n, cap, d)
    expert_input, token = alltoall(buckets, comm=comm, token=token)
    return expert_input, order, token


def default_capacity(k, tokens, n_experts):
    """Capacity-factor-1 default: ``ceil(k * tokens / n_experts)``."""
    return -(-k * tokens // n_experts)


def topk_route(scores, k, capacity):
    """Token-choice top-k routing with per-expert capacity (GShard /
    Switch): each token picks its ``k`` highest-scoring experts; each
    expert accepts at most ``capacity`` of the tokens that chose it, in
    score order, and the rest overflow (their combine contribution is
    zero; the residual carries them).

    ``scores`` is ``(T, E)``: probabilities, or any non-NaN values
    including ``-inf``-masked logits (slot validity comes from how many
    tokens chose each expert, not from finiteness; a ``-inf``-scored
    choice gates to 0).

    Returns ``(idx, gate, valid)``, each ``(E, capacity)``: the source
    token of expert ``e``'s slot ``c``, that token's score for ``e``,
    and False for unfilled or overflow slots.
    """
    t, n_experts = scores.shape
    _, top_experts = top_k(scores, k)  # (T, k)
    chosen = torch.zeros((t, n_experts), dtype=torch.bool,
                         device=scores.device).scatter_(1, top_experts, True)
    # sort key: the score where chosen (clamped finite, so a -inf-scored
    # choice still outranks every non-chooser), -inf elsewhere; each
    # expert takes its top-capacity choosers by score
    finite_min = torch.finfo(scores.dtype).min
    safe = torch.maximum(scores, torch.full((), finite_min,
                                            dtype=scores.dtype,
                                            device=scores.device))
    key = torch.where(chosen, safe, -torch.inf)
    _, idx = top_k(key.T, capacity)  # (E, cap)
    # validity = slot ordinal < chooser count (not score finiteness)
    count = torch.clamp(chosen.sum(0), max=capacity)  # (E,)
    valid = (torch.arange(capacity, device=scores.device)[None, :]
             < count[:, None])
    gate = torch.gather(scores.T, 1, idx)
    gate = torch.where(valid & torch.isfinite(gate), gate,
                       torch.zeros((), dtype=gate.dtype, device=gate.device))
    return idx, gate, valid


def topk_moe(x, scores, expert_fn, comm, *, k=1, capacity=None, token=None,
             coalesce=None):
    """Full token-choice MoE layer: route, alltoall dispatch, expert
    compute, alltoall combine, gate-weighted scatter-add.

    The expert count is ``scores.shape[1]``, a multiple of ``comm.size``:
    with ``E == comm.size`` rank r hosts expert r and ``expert_fn`` maps
    the ``(n_src*capacity, d)`` buffer per token; with ``E ==
    m*comm.size`` rank r hosts experts ``r*m .. r*m+m-1`` and
    ``expert_fn`` receives the stacked ``(m, n_src*capacity, d)``
    buffers.  Overflow tokens contribute zero.  The ``m`` parts travel
    through one :func:`alltoall_multi` each way (``coalesce`` as
    there: on a proc comm one wire frame a peer; the results are the
    same either way).  ``capacity`` defaults to ``ceil(k*T/E)``.
    Returns ``(y, token)`` with ``y`` shaped like ``x``.
    """
    token = as_token(token)
    n = comm.size
    t, d = x.shape
    if scores.ndim != 2 or scores.shape[0] != t or scores.shape[1] % n:
        raise ValueError(
            f"scores must be (tokens, n_experts) with n_experts a "
            f"multiple of comm.size={n} (tokens={t}), got "
            f"{tuple(scores.shape)}"
        )
    n_experts = scores.shape[1]
    m = n_experts // n  # experts hosted per rank
    if capacity is None:
        capacity = default_capacity(k, t, n_experts)
    idx, gate, valid = topk_route(scores, k, capacity)
    buckets = x[idx] * valid[..., None].to(x.dtype)  # (E, cap, d)
    # expert e = r*m + i lives on rank r as its local expert i: part i
    # stacks expert i of every rank, one alltoall row per destination
    parts = [buckets[i::m] for i in range(m)]
    sent_parts, token = alltoall_multi(parts, comm=comm, token=token,
                                       coalesce=coalesce)
    if m == 1:
        out = expert_fn(sent_parts[0].reshape(n * capacity, d))
        out_parts = [out.reshape(n, capacity, d)]
    else:
        stacked = torch.stack([s.reshape(n * capacity, d)
                               for s in sent_parts])  # (m, n_src*cap, d)
        out = expert_fn(stacked)
        out_parts = [out[i].reshape(n, capacity, d) for i in range(m)]
    back_parts, token = alltoall_multi(out_parts, comm=comm, token=token,
                                       coalesce=coalesce)
    # (E, cap, d): part i's row r is expert r*m+i's result
    if m == 1:
        vals = back_parts[0]
    else:
        vals = torch.stack(back_parts, dim=1).reshape(n_experts, capacity, d)
    return gate_sum(x, idx, gate, vals), token


def expert_combine(expert_output, order, comm, *, token=None):
    """Inverse of :func:`expert_dispatch`: return ``(n_ranks, capacity,
    d)`` results to their source ranks and the original token order."""
    token = as_token(token)
    n, cap, d = expert_output.shape
    back, token = alltoall(expert_output, comm=comm, token=token)
    flat = back.reshape(n * cap, d)
    # O(T) permutation inverse (a second argsort would re-sort)
    inv = torch.zeros_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    return flat[inv], token
