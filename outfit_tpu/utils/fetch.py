"""Single-buffer device->host result fetch.

A device-to-host transfer charges a per-transfer setup cost on top of
bandwidth.  A fused fit's result set is ~30 small arrays (~3.4 MB at 8192
trajectories), so fetching them individually pays that setup cost 30
times, while one packed buffer pays it once.  Whether this pays on the
GPU's PCIe link is ROADMAP C3.

``pack_for_fetch`` flattens a pytree of device arrays into ONE f64 device
buffer (a tiny jitted concat dispatched AFTER the main kernels — it never
changes the main kernels' compiled executables), plus host metadata.
``unpack_fetched`` restores the exact original arrays: every production
dtype (f64, f32, int32, bool) round-trips through f64 bit-exactly —
f32/f64 are exact by widening, int32/bool values are exact integers far
below 2**53.

Parity note: the reference fetches nothing (results live in host memory,
e.g. obs_dataset_api.rs:145-207); this module exists because device
results must cross a link, and the link charges per message.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["pack_for_fetch", "unpack_fetched"]


@jax.jit
def _pack_leaves(leaves):
    return jnp.concatenate([jnp.ravel(l).astype(jnp.float64) for l in leaves])


@jax.jit
def _pack_leaves_f32(leaves):
    return jnp.concatenate([jnp.ravel(l).astype(jnp.float32) for l in leaves])


def pack_for_fetch(tree, slim_mask=None):
    """Return ``(packed_device_buffers, spec)`` for a pytree of device
    arrays, or ``(None, spec)`` when the tree holds no elements (the
    caller should then fall back to a direct ``device_get``).

    ``slim_mask`` (optional) is a pytree matching ``tree`` whose leaves
    take three values: ``False`` — ride the exact f64 buffer; ``True`` —
    ride a second float32 buffer (HALF the link bytes at ~7 significant
    digits, for reporting-grade quantities like the covariance);
    ``None`` — SKIP the leaf entirely (not transferred;
    :func:`unpack_fetched` returns ``None`` in its place — the caller
    keeps the device array and fetches the rows it needs later, the
    deferred-fetch mode of ``fit_lsq_dispatch(minimal_fetch=True)``).
    On a bandwidth-bound link, byte slimming is a direct latency win."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    if slim_mask is None:
        slim = [False] * len(leaves)
    else:
        # tree_leaves drops None entries, so flatten with is_leaf to keep
        # the skip markers aligned with the data leaves
        slim = [
            None if s is None else bool(s)
            for s in jax.tree_util.tree_leaves(
                slim_mask, is_leaf=lambda x: x is None
            )
        ]
        if len(slim) != len(leaves):
            raise ValueError(
                f"slim_mask has {len(slim)} leaves, tree has {len(leaves)}"
            )
    meta = [
        (tuple(l.shape), np.dtype(l.dtype), s)
        for l, s in zip(leaves, slim)
    ]
    sent = [(s, m) for (s, m) in zip(leaves, slim) if m is not None]
    if not sent or sum(int(np.prod(l.shape)) for l, _ in sent) == 0:
        return None, (treedef, meta)
    full = [l for l, s in sent if not s]
    half = [l for l, s in sent if s]
    bufs = (
        _pack_leaves(full) if full else None,
        _pack_leaves_f32(half) if half else None,
    )
    return bufs, (treedef, meta)


def unpack_fetched(bufs, spec):
    """Inverse of :func:`pack_for_fetch`: split the fetched host buffer(s)
    back into the original pytree (exact shapes and dtypes; slim leaves
    carry float32-rounded values in their original dtype; skipped leaves
    come back as ``None``)."""
    treedef, meta = spec
    if not (isinstance(bufs, tuple) and len(bufs) == 2):
        bufs = (bufs, None)  # legacy single-buffer callers
    full = None if bufs[0] is None else np.asarray(bufs[0])
    half = None if bufs[1] is None else np.asarray(bufs[1])
    out = []
    off_f = off_h = 0
    for entry in meta:
        shape, dtype, slim = entry if len(entry) == 3 else (*entry, False)
        if slim is None:
            out.append(None)
            continue
        n = int(np.prod(shape))
        if slim:
            a = half[off_h : off_h + n].reshape(shape)
            off_h += n
        else:
            a = full[off_f : off_f + n].reshape(shape)
            off_f += n
        out.append(a if a.dtype == dtype else a.astype(dtype))
    # tree_unflatten only plugs values into the recorded structure, so the
    # None placeholders pass through untouched
    return jax.tree_util.tree_unflatten(treedef, out)
