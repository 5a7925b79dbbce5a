"""The PyTorch port's 2-D halo exchange across a 2x4 grid of ranks,
against the JAX package's on its virtual mesh (``comm2d``): widths 1, 2
and 4, every combination of periodic axes, single-field and batched.

Each rank's block is one tile of a global array; the JAX function runs
under ``shard_map`` over the tiles, the port's in a local world of 8
ranks (threads, gloo over loopback).  The exchange only moves values,
so the two must agree bit for bit, corners included, and a rank on a
non-periodic edge keeps its ghosts.
"""

import jax
import numpy as np
import pytest
import torch

from mpi4jax_tpu.parallel.halo import (
    halo_exchange_2d as jax_halo,
    halo_exchange_2d_batch as jax_halo_batch,
)

from mpi4jax_tpu_torch.parallel.distributed import local_world
from mpi4jax_tpu_torch.parallel.halo import (
    halo_exchange_2d,
    halo_exchange_2d_batch,
)

torch.set_num_threads(1)

PERIODIC = [(False, False), (False, True), (True, False), (True, True)]
GRID = (2, 4)
NY_L, NX_L = 5, 4
N_BATCH = 3


def _tiles(width, seed):
    """A global array of 2x4 blocks, each (NY_L + 2w, NX_L + 2w)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (N_BATCH, GRID[0] * (NY_L + 2 * width), GRID[1] * (NX_L + 2 * width))
    ).astype(np.float32)


def _block(a, rank, width):
    iy, ix = divmod(rank, GRID[1])
    by, bx = NY_L + 2 * width, NX_L + 2 * width
    return a[..., iy * by:(iy + 1) * by, ix * bx:(ix + 1) * bx]


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda w: f"w{w}")
def exchanged(request, comm2d):
    """Inputs and the JAX results of every periodic combination, single
    (the first field) and batched (all three), for one width."""
    width = request.param
    a = _tiles(width, seed=width)

    def fn(x):
        out = []
        for per in PERIODIC:
            single, _ = jax_halo(x[0], comm2d, periodic=per, width=width)
            batch, _ = jax_halo_batch(list(x), comm2d, periodic=per,
                                      width=width)
            out.append((single, tuple(batch)))
        return out

    spec = jax.P(None, "y", "x")
    outs = jax.jit(jax.shard_map(
        fn, mesh=comm2d.mesh, in_specs=(spec,),
        out_specs=[(jax.P("y", "x"), (jax.P("y", "x"),) * N_BATCH)]
        * len(PERIODIC),
    ))(a)
    expected = {per: (np.asarray(s), np.stack([np.asarray(b) for b in bs]))
                for per, (s, bs) in zip(PERIODIC, outs)}
    return width, a, expected


def _port_exchange(width, a, per, batch):
    def body(comm):
        mine = torch.from_numpy(_block(a, comm.rank(), width).copy())
        if batch:
            fields = list(mine)
            outs, _ = halo_exchange_2d_batch(fields, comm, periodic=per,
                                             width=width)
            assert all(o is f for o, f in zip(outs, fields))  # in place
            return torch.stack(outs).numpy()
        field = mine[0].clone()
        out, _ = halo_exchange_2d(field, comm, periodic=per, width=width)
        assert out is field
        return out.numpy()

    return local_world(8, body, axes=(("y", "x"), GRID), timeout=20.0)


@pytest.mark.parametrize("batch", [False, True], ids=["single", "batch"])
@pytest.mark.parametrize("periodic", PERIODIC,
                         ids=lambda p: f"y{p[0]:d}x{p[1]:d}")
def test_halo_exchange_matches_jax(exchanged, periodic, batch):
    width, a, expected = exchanged
    want = expected[periodic][1 if batch else 0]
    got = _port_exchange(width, a, periodic, batch)
    for rank, block in enumerate(got):
        np.testing.assert_array_equal(block, _block(want, rank, width))
    if not periodic[0]:
        # the south edge's ghost rows are the input's own (but for the
        # corners, which the x exchange fills)
        south = _block(a if batch else a[0], 0, width)
        np.testing.assert_array_equal(got[0][..., :width, width:-width],
                                      south[..., :width, width:-width])
