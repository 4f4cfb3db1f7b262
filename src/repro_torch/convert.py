"""Carry an experiment's state between the reference (``repro``) and the
port, so both packages compute the same thing from the same point.

The reference's state arrives as numpy leaves (``jax.tree.map(np.asarray,
state)`` of its ``ExperimentState``); this module imports neither JAX nor
the reference.  Parameter leaves change layout on the way (HWIO -> OIHW
convolutions, [in, out] -> [out, in] dense weights, per each adapter's
``jax_leaves``) and are flattened in the port's leaf order; the stale
stores change the same way, one [N, P] row per client.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import stale
from repro_torch.core.engine import ExperimentState, RoundEngine


def _perm(change: Optional[str], lead: int, to_port: bool) -> List[int]:
    head = list(range(lead))
    if change is None:
        return []
    if change == "transpose":
        return head + [lead + 1, lead]
    if change == "hwio_to_oihw":
        # HWIO -> OIHW and its inverse OIHW -> HWIO
        return head + ([lead + 3, lead + 2, lead, lead + 1] if to_port
                       else [lead + 2, lead + 3, lead + 1, lead])
    raise ValueError(f"unknown layout change {change!r}")


def _get(tree: Any, path: Tuple[str, ...]) -> np.ndarray:
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _flatten_from_jax(tree: Any, engine: RoundEngine, g: int,
                      lead: int) -> torch.Tensor:
    """A reference parameter tree with ``lead`` leading axes -> the port's
    flat [*lead_dims, P] tensor of group g."""
    adapter = engine.tasks[engine.groups[g][0]].model
    layout = engine.layouts[g]
    parts = []
    for name in layout.names:
        path, change = adapter.jax_leaves[name]
        arr = _get(tree, path)
        perm = _perm(change, lead, to_port=True)
        if perm:
            arr = arr.transpose(perm)
        if arr.shape[lead:] != layout.shapes[name]:
            raise ValueError(f"leaf {name}: shape {arr.shape[lead:]} after "
                             f"conversion, expected {layout.shapes[name]}")
        parts.append(arr.reshape(arr.shape[:lead] + (-1,)))
    flat = np.concatenate(parts, axis=-1).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(flat)).to(engine.device)


def _tree_to_jax(flat: torch.Tensor, engine: RoundEngine, g: int
                 ) -> Dict[str, Any]:
    """The port's flat [*lead, P] tensor of group g -> a reference-layout
    nested dict of numpy leaves [*lead, ...]."""
    adapter = engine.tasks[engine.groups[g][0]].model
    layout = engine.layouts[g]
    lead = flat.dim() - 1
    out: Dict[str, Any] = {}
    for name, view in layout.views(flat.detach().cpu()).items():
        path, change = adapter.jax_leaves[name]
        arr = view.numpy()
        perm = _perm(change, lead, to_port=False)
        _set(out, path, np.ascontiguousarray(arr.transpose(perm) if perm
                                             else arr))
    return out


def state_from_jax(np_tree: Any, engine: RoundEngine) -> ExperimentState:
    """The reference's ``ExperimentState`` (numpy leaves) -> the port's,
    on ``engine``'s device: params, method state (``h``, ``h_valid``,
    ``beta``), ``key``, ``round`` and ``losses_ns``.  The two engines must
    group their tasks alike."""
    dev = engine.device
    want = [g for g, _ in engine.task_gs]
    if np_tree.task_group is not None and \
            list(np.asarray(np_tree.task_group)) != want:
        raise ValueError(f"task groups differ: reference "
                         f"{list(np.asarray(np_tree.task_group))}, port "
                         f"{want}")
    to_dev = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    params, mstate = [], []
    for g in range(engine.n_groups):
        params.append(_flatten_from_jax(np_tree.params[g], engine, g, lead=1))
        ms = np_tree.method_state[g]
        new: Dict[str, Any] = {}
        if "h" in ms:
            new["h"] = _flatten_from_jax(ms["h"], engine, g, lead=2)
            new["h_valid"] = to_dev(ms["h_valid"])
        if "beta" in ms:
            new["beta"] = stale.BetaState(*(to_dev(f) for f in ms["beta"]))
        mstate.append(new)
    key = torch.tensor(np.asarray(np_tree.key).astype(np.int64), device=dev)
    return ExperimentState(
        params=tuple(params), method_state=tuple(mstate), key=key,
        round=int(np.asarray(np_tree.round)),
        losses_ns=to_dev(np_tree.losses_ns),
        client_mask=engine.world.client_mask,
        task_group=torch.as_tensor(want, dtype=torch.int32, device=dev),
        task_slot=torch.as_tensor([j for _, j in engine.task_gs],
                                  dtype=torch.int32, device=dev))


def params_to_numpy(state: ExperimentState, engine: RoundEngine
                    ) -> List[Dict[str, Any]]:
    """Per-task parameter trees in the reference's layout (numpy)."""
    out = []
    for g, j in engine.task_gs:
        out.append(_tree_to_jax(state.params[g][j], engine, g))
    return out


def method_state_to_numpy(state: ExperimentState, engine: RoundEngine
                          ) -> List[Dict[str, Any]]:
    """Per-task method state in the reference's layout (numpy): the store
    ``h`` as a parameter tree with a leading [N] axis, ``h_valid`` and the
    ``beta`` estimator."""
    out = []
    for g, j in engine.task_gs:
        ms = state.method_state[g]
        task: Dict[str, Any] = {}
        if "h" in ms:
            task["h"] = _tree_to_jax(ms["h"][j], engine, g)
            task["h_valid"] = ms["h_valid"][j].cpu().numpy()
        if "beta" in ms:
            task["beta"] = stale.BetaState(
                *(f[j].cpu().numpy() for f in ms["beta"]))
        out.append(task)
    return out
