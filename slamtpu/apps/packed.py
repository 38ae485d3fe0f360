"""Single-transfer wrappers for per-keyframe device steps.

Each eager op or small-array transfer is a host-device round trip; a
per-keyframe fusion step that ships ~30 factor arrays one at a time pays
that latency ~30 times (the reference runs fully host-side and has no such
boundary, cf. the reference run/pipeline_ligo_tc.cpp:578-587). ``PackedStep`` flattens
a pytree of host numpy arrays into ONE flat vector, runs a jitted function
on device (unpacking with static shapes inside the trace), and returns the
outputs as ONE flat vector unpacked back to numpy — one transfer each way
per keyframe regardless of how many leaves the step consumes.

The flat vector uses f64 under x64 (CPU tests) and f32 otherwise, so
test-path precision is preserved. Integer leaves must stay below 2^24 so
the f32 round-trip is exact; booleans round-trip as 0.0/1.0.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _leaf_dtype(dt: np.dtype):
    """Device dtype a leaf is restored to inside the trace."""
    if dt == np.bool_:
        return jnp.bool_
    if np.issubdtype(dt, np.integer):
        return jnp.int32
    return jax.dtypes.canonicalize_dtype(dt)


def _flat_dtype():
    return np.float64 if jax.config.jax_enable_x64 else np.float32


class PackedStep:
    """Wrap ``fn(args_pytree) -> out_pytree`` into a one-H2D/one-D2H call.

    The pytree structure, leaf shapes, and leaf dtypes must be identical on
    every call (they define the compiled program).
    """

    def __init__(self, fn):
        self._fn = fn
        self._in_spec = None
        self._out_spec = None
        self._jitted = None
        self._flat_np = None

    def _build(self, args_pytree):
        leaves, treedef = jax.tree.flatten(args_pytree)
        shapes = [np.shape(l) for l in leaves]
        dtypes = [np.asarray(l).dtype for l in leaves]
        sizes = [int(np.prod(s, dtype=np.int64)) if s else 1 for s in shapes]
        self._in_spec = (treedef, shapes, dtypes, sizes)
        self._flat_np = _flat_dtype()
        out_dt = jnp.dtype(self._flat_np)

        def run(flat):
            vals = []
            off = 0
            for shp, dt, n in zip(shapes, dtypes, sizes):
                v = flat[off : off + n].reshape(shp)
                ldt = _leaf_dtype(dt)
                if v.dtype != ldt:
                    v = v.astype(ldt)
                vals.append(v)
                off += n
            out = self._fn(jax.tree.unflatten(treedef, vals))
            out_leaves, out_treedef = jax.tree.flatten(out)
            # trace-time capture of the output layout (runs once per compile)
            self._out_spec = (
                out_treedef,
                [l.shape for l in out_leaves],
                [l.dtype for l in out_leaves],
            )
            return jnp.concatenate(
                [jnp.ravel(l).astype(out_dt) for l in out_leaves]
            )

        self._jitted = jax.jit(run)

    def _pack(self, args_pytree) -> np.ndarray:
        leaves = jax.tree.leaves(args_pytree)
        if not leaves:
            return np.zeros(0, self._flat_np)
        return np.concatenate(
            [np.asarray(l, self._flat_np).ravel() for l in leaves]
        )

    def __call__(self, args_pytree):
        if self._jitted is None:
            self._build(args_pytree)
        flat_out = np.asarray(self._jitted(self._pack(args_pytree)))
        treedef, shapes, dtypes = self._out_spec
        vals = []
        off = 0
        for shp, dt in zip(shapes, dtypes):
            n = int(np.prod(shp, dtype=np.int64)) if shp else 1
            v = flat_out[off : off + n].reshape(shp)
            if dt == jnp.bool_:
                v = v > 0.5
            elif jnp.issubdtype(dt, jnp.integer):
                v = np.asarray(np.rint(v), np.int32)
            off += n
            vals.append(v)
        return jax.tree.unflatten(treedef, vals)
