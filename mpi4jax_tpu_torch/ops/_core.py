"""Token plumbing shared by the communication ops.

Counterpart of ``mpi4jax_tpu/ops/_core.py``.  The JAX package threads a
token whose stamp array carries the ordering of collectives through the
compiled program.  PyTorch runs eagerly: ops are ordered by the order
the program issues them on the CUDA stream.  So a :class:`Token` here
holds no data and every op passes it through; it stays in every
signature so that code written against the JAX package's API runs
unchanged.
"""

import functools

import torch

__all__ = [
    "Token",
    "create_token",
    "as_token",
    "token_array",
    "publishes_token",
    "ANY_SOURCE",
    "ANY_TAG",
    "pop_match",
]

ANY_SOURCE = -1
ANY_TAG = -1


def pop_match(messages, source, tag):
    """Remove and return the earliest ``(source, tag, tensor)`` of
    ``messages`` from ``source`` (or ANY_SOURCE) with ``tag`` (or
    ANY_TAG); None if there is none."""
    for i, (src, t, _) in enumerate(messages):
        if source in (ANY_SOURCE, src) and tag in (ANY_TAG, t):
            return messages.pop(i)
    return None


class Token:
    """Opaque ordering token returned by every communication op."""

    __slots__ = ()

    def __repr__(self):
        return "Token()"


def create_token(arg=None):
    """Create a fresh communication token.

    ``arg`` is accepted (and ignored) for call-compatibility with
    ``jax.lax.create_token`` and the JAX package.
    """
    del arg
    return Token()


def as_token(token):
    """Coerce a user-supplied token (None or a :class:`Token`)."""
    if token is None:
        return Token()
    if isinstance(token, Token):
        return token
    raise TypeError(f"cannot interpret {type(token)} as a communication token")


def token_array(token):
    """The token's stamp array, for code that threads array tokens.  The
    port's tokens hold no data, so this is the JAX package's fresh
    stamp: a 0-d float32 zero."""
    as_token(token)
    return torch.zeros((), dtype=torch.float32)


def publishes_token(fn):
    """Wrap a public op in a profiler range named
    ``mpi4jax_tpu_torch.<op>`` (the counterpart of the JAX package's
    ``jax.named_scope``), so a ``torch.profiler`` trace attributes the
    op's device work to it.  The range is only opened while a profiler
    runs: entering one costs microseconds of host time, as much as a
    small kernel launch, and a solver step calls some twenty ops."""
    label = f"mpi4jax_tpu_torch.{fn.__name__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not torch.autograd._profiler_enabled():
            return fn(*args, **kwargs)
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    return wrapper
