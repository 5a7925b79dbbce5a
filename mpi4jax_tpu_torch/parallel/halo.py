"""Halo (ghost-cell) exchange for 2-D domain decomposition.

Counterpart of ``mpi4jax_tpu/parallel/halo.py``: each direction is one
``sendrecv`` over the axis sub-communicator, the x exchange moves full
columns (ghost rows included) and then the y exchange moves full rows
(the just-filled x ghosts included), so corners are correct after two
rounds.  On one rank a periodic x exchange is a self-sendrecv of column
slabs and a non-periodic y exchange on a size-1 axis has no pairs, so
it leaves the ghost rows as they are.

Unlike the JAX function, which returns a new array, the exchange writes
the ghost ring of the given tensor in place and returns that tensor:
the solver's fields are tens of megabytes, and a copy per exchange
would cost more memory traffic than the step's kernels.
"""

import torch

from mpi4jax_tpu_torch.ops._core import as_token, publishes_token
from mpi4jax_tpu_torch.ops.p2p import sendrecv

__all__ = ["halo_exchange_2d", "halo_exchange_2d_batch"]


def _axis_shift(slab, template, comm, axis, disp, periodic, token):
    """One directional exchange along ``axis`` (disp = ±1).

    Returns ``(halo, token)``; ``halo is None`` when the shift has no
    pairs (non-periodic on a size-1 axis), so the ghosts keep their
    values and the caller skips the write.
    """
    sub = comm.sub(axis)
    pairs = sub.shift_perm(axis, disp, periodic=periodic)
    if not pairs:
        return None, token
    return sendrecv(
        slab, template, source=pairs, dest=pairs, comm=sub, token=token
    )


@publishes_token
def halo_exchange_2d(arr, comm, *, periodic=(False, True), token=None,
                     width=1):
    """Exchange ``width``-cell halos of a local block over a ("y", "x")
    MeshComm, in place.

    ``arr`` is the local block of shape ``(ny_local + 2*width,
    nx_local + 2*width)``.  Returns ``(arr, token)`` with the ghost
    cells holding the neighbours' adjacent interior cells.
    ``periodic`` is (y, x); non-periodic edges keep their ghost values
    (apply wall conditions separately).
    """
    arrs, token = _exchange(
        [arr], comm, periodic=periodic, token=token, width=width,
        stack=False,
    )
    return arrs[0], token


@publishes_token
def halo_exchange_2d_batch(arrs, comm, *, periodic=(False, True), token=None,
                           width=1):
    """Exchange the halos of several same-shaped blocks at once, in
    place: the slabs of all blocks travel in one stacked ``sendrecv``
    per direction.  Returns ``(list_of_arrs, token)``."""
    return _exchange(
        list(arrs), comm, periodic=periodic, token=token, width=width,
        stack=True,
    )


def _exchange(arrs, comm, *, periodic, token, width, stack):
    """Shared four-direction body (x then y so corners fill
    transitively)."""
    token = as_token(token)
    per_y, per_x = periodic
    w = width

    def shift(slabs, templates, axis, disp, per):
        nonlocal token
        if stack:
            halo, token = _axis_shift(
                torch.stack(slabs), torch.stack(templates), comm, axis,
                disp, per, token,
            )
            return [None] * len(slabs) if halo is None else list(halo)
        out = []
        for slab, template in zip(slabs, templates):
            halo, token = _axis_shift(
                slab, template, comm, axis, disp, per, token
            )
            out.append(halo)
        return out

    def write(halo, region):
        for a, h in zip(arrs, halo):
            if h is not None:
                a[region] = h

    # --- x direction: full-height column slabs (corners ride along) ---
    halo = shift(
        [a[:, -2 * w : -w] for a in arrs], [a[:, :w] for a in arrs],
        "x", +1, per_x,
    )
    write(halo, (slice(None), slice(None, w)))
    halo = shift(
        [a[:, w : 2 * w] for a in arrs], [a[:, -w:] for a in arrs],
        "x", -1, per_x,
    )
    write(halo, (slice(None), slice(-w, None)))

    # --- y direction: full-width row slabs (x halos already current) ---
    halo = shift(
        [a[-2 * w : -w, :] for a in arrs], [a[:w, :] for a in arrs],
        "y", +1, per_y,
    )
    write(halo, (slice(None, w), slice(None)))
    halo = shift(
        [a[w : 2 * w, :] for a in arrs], [a[-w:, :] for a in arrs],
        "y", -1, per_y,
    )
    write(halo, (slice(-w, None), slice(None)))

    return arrs, token
