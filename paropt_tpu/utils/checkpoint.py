"""Sharded checkpoint/resume via Orbax/TensorStore.

The reference writes binary parallel checkpoints of the full primal-dual
state with MPI-IO collective writes (`writeSolutionFile`/`readSolutionFile`,
`ParOptInteriorPoint.cpp:883-1110`).  The JAX-native equivalent is an Orbax
checkpoint of the state pytree: sharded arrays are written/restored in
parallel by TensorStore, and restore places each leaf back on its mesh with
the sharding of the provided template.

A capability upgrade over the reference: the quasi-Newton ring buffers and
all solver scalars are checkpointed too (the reference restarts the Hessian
approximation on resume, SURVEY.md §5.4).
"""

from __future__ import annotations

import os
from typing import Any

import jax

__all__ = ["save_state", "restore_state"]


def _checkpointer():
    import orbax.checkpoint as ocp
    return ocp.PyTreeCheckpointer()


def save_state(path: str, state: Any) -> None:
    """Write a state pytree (e.g. FusedState or IPVars) to ``path``."""
    path = os.path.abspath(path)
    ckpt = _checkpointer()
    ckpt.save(path, state, force=True)


def restore_state(path: str, template: Any) -> Any:
    """Restore a state pytree; each leaf takes the dtype/sharding of the
    corresponding leaf in ``template``."""
    import orbax.checkpoint as ocp
    path = os.path.abspath(path)
    ckpt = _checkpointer()

    def as_restore_args(leaf):
        leaf = jax.numpy.asarray(leaf)
        sharding = getattr(leaf, "sharding", None)
        return ocp.ArrayRestoreArgs(dtype=leaf.dtype, sharding=sharding,
                                    global_shape=leaf.shape)

    restore_args = jax.tree_util.tree_map(as_restore_args, template)
    return ckpt.restore(path, item=template, restore_args=restore_args)
