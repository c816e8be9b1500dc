"""Neighbor-shift primitives with boundary conditions.

All dynamics fields use the *owned* layout: arrays are exactly (..., nx, ny).

* cell fields: value of element (i, j);
* node fields: value of CG node (i, j) — the i=nx / j=ny boundary nodes are
  not stored (for closed domains they are Dirichlet-zero; for periodic they
  wrap to index 0);
* x-edge fields: the face between elements (i-1, j) and (i, j) — the right
  domain-boundary face is implicit (zero flux when closed, wraps when
  periodic); y-edges analogous.

Uniform shapes mean uniform sharding over the device mesh; shifts become
``jnp.roll`` (a collective-permute under SPMD) or zero-filled
concatenations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _ring_perm(axis_name: str, direction: int):
    """Ring permutation along a mesh axis: send my slice to neighbor."""
    size = lax.axis_size(axis_name)
    return [(i, (i + direction) % size) for i in range(size)]


def shift_p(f, axis: int, periodic: bool, axis_name: str = None):
    """f[i+1] along ``axis``: the +1 neighbor; zero-filled when closed.

    Static slices + concatenate (not gather), which XLA fuses into the
    consuming elementwise pass.

    With ``axis_name`` (inside ``shard_map``): the array is a local block of
    a domain sharded along that mesh axis; the missing last slice comes from
    the +1 neighbor device via a halo ``ppermute`` (the rightmost
    device receives zeros when the global boundary is closed, or wraps when
    periodic).
    """
    if axis_name is None:
        if periodic:
            return jnp.roll(f, -1, axis=axis)
        moved = lax.slice_in_dim(f, 1, f.shape[axis], axis=axis)
        pad = jnp.zeros_like(lax.slice_in_dim(f, 0, 1, axis=axis))
        return lax.concatenate([moved, pad], dimension=axis)

    moved = lax.slice_in_dim(f, 1, f.shape[axis], axis=axis)
    # My first slice travels to my -1 neighbor == I receive my +1 neighbor's.
    edge = lax.slice_in_dim(f, 0, 1, axis=axis)
    recv = lax.ppermute(edge, axis_name, perm=_ring_perm(axis_name, -1))
    if not periodic:
        is_last = lax.axis_index(axis_name) == lax.axis_size(axis_name) - 1
        recv = jnp.where(is_last, jnp.zeros_like(recv), recv)
    return lax.concatenate([moved, recv], dimension=axis)


def shift_m(f, axis: int, periodic: bool, axis_name: str = None):
    """f[i-1] along ``axis``: the -1 neighbor; zero-filled when closed."""
    if axis_name is None:
        if periodic:
            return jnp.roll(f, 1, axis=axis)
        moved = lax.slice_in_dim(f, 0, f.shape[axis] - 1, axis=axis)
        pad = jnp.zeros_like(lax.slice_in_dim(f, 0, 1, axis=axis))
        return lax.concatenate([pad, moved], dimension=axis)

    moved = lax.slice_in_dim(f, 0, f.shape[axis] - 1, axis=axis)
    edge = lax.slice_in_dim(f, f.shape[axis] - 1, f.shape[axis], axis=axis)
    recv = lax.ppermute(edge, axis_name, perm=_ring_perm(axis_name, +1))
    if not periodic:
        is_first = lax.axis_index(axis_name) == 0
        recv = jnp.where(is_first, jnp.zeros_like(recv), recv)
    return lax.concatenate([recv, moved], dimension=axis)


def halo_widen(f, h: int, axis: int, periodic: bool, axis_name: str = None):
    """Extend ``f`` by h-wide neighbor strips on BOTH sides along ``axis``.

    Inside shard_map this is ONE ppermute pair per axis instead of one per
    subcycle — the temporally-blocked ("ghost zone") halo exchange: with
    h-wide halos the mEVP stencil can run h subcycles locally before the
    invalidation ring reaches the interior. Outside shard_map (or at
    closed global edges) the strips are zeros = the wall condition;
    periodic axes wrap.

    Corners: widen axis 0 first, then axis 1 on the result — the second
    exchange carries the first's strips, filling corners exactly.
    """
    lo_strip = lax.slice_in_dim(f, 0, h, axis=axis)
    hi_strip = lax.slice_in_dim(f, f.shape[axis] - h, f.shape[axis], axis=axis)
    if axis_name is None:
        if periodic:
            lo, hi = hi_strip, lo_strip
        else:
            lo, hi = jnp.zeros_like(hi_strip), jnp.zeros_like(lo_strip)
    else:
        # My leading strip goes to my -1 neighbor == I receive my +1
        # neighbor's leading strip on my right, and vice versa.
        hi = lax.ppermute(lo_strip, axis_name, perm=_ring_perm(axis_name, -1))
        lo = lax.ppermute(hi_strip, axis_name, perm=_ring_perm(axis_name, +1))
        if not periodic:
            is_last = lax.axis_index(axis_name) == lax.axis_size(axis_name) - 1
            hi = jnp.where(is_last, jnp.zeros_like(hi), hi)
            is_first = lax.axis_index(axis_name) == 0
            lo = jnp.where(is_first, jnp.zeros_like(lo), lo)
    return lax.concatenate([lo, f, hi], dimension=axis)


def is_global_edge(axis_name: str, side: str):
    """Whether this shard owns the global first/last block along the axis.

    Returns a traced bool inside shard_map, or a static True outside.
    """
    if axis_name is None:
        return True
    if side == "first":
        return lax.axis_index(axis_name) == 0
    return lax.axis_index(axis_name) == lax.axis_size(axis_name) - 1
