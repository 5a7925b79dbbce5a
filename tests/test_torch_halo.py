"""Parity of the PyTorch port's 2-D halo exchange with the JAX package's
on a one-rank ("y", "x") grid: widths 1, 2 and 4, every combination of
periodic axes, single-field and batched.  The exchange only moves
values, so the two must agree bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.parallel.halo import (
    halo_exchange_2d as jax_halo,
    halo_exchange_2d_batch as jax_halo_batch,
)

from mpi4jax_tpu_torch.parallel.comm import MeshComm
from mpi4jax_tpu_torch.parallel.halo import (
    halo_exchange_2d,
    halo_exchange_2d_batch,
)

torch.set_num_threads(1)

PERIODIC = [(False, False), (False, True), (True, False), (True, True)]


def _jax_exchange(arrs, periodic, width, batch):
    mesh = jax.make_mesh(
        (1, 1), ("y", "x"), axis_types=(jax.sharding.AxisType.Auto,) * 2
    )
    comm = mj.MeshComm.from_mesh(mesh)

    def fn(*a):
        if batch:
            out, _ = jax_halo_batch(list(a), comm, periodic=periodic,
                                    width=width)
            return tuple(out)
        out, _ = jax_halo(a[0], comm, periodic=periodic, width=width)
        return (out,)

    spec = jax.P()
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * len(arrs),
                              out_specs=(spec,) * len(arrs), check_vma=False))
    return [np.asarray(o) for o in f(*arrs)]


def _block(seed, width, ny_l=6, nx_l=9):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (ny_l + 2 * width, nx_l + 2 * width)
    ).astype(np.float32)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("periodic", PERIODIC, ids=lambda p: f"y{p[0]:d}x{p[1]:d}")
def test_halo_exchange_matches_jax(width, periodic):
    a = _block(width, width)
    (expected,) = _jax_exchange([a], periodic, width, batch=False)
    t = torch.from_numpy(a.copy())
    out, _ = halo_exchange_2d(t, MeshComm(), periodic=periodic, width=width)
    assert out is t  # the ghost ring is written in place
    np.testing.assert_array_equal(out.numpy(), expected)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("periodic", [(False, True), (True, True)],
                         ids=["wall_y", "periodic_yx"])
def test_halo_exchange_batch_matches_jax(width, periodic):
    arrs = [_block(10 + i, width) for i in range(3)]
    expected = _jax_exchange(arrs, periodic, width, batch=True)
    outs, _ = halo_exchange_2d_batch(
        [torch.from_numpy(a.copy()) for a in arrs], MeshComm(),
        periodic=periodic, width=width,
    )
    for o, e in zip(outs, expected):
        np.testing.assert_array_equal(o.numpy(), e)
