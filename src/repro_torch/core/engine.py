"""The MMFL round engine on one device, the port of ``repro.core.engine``.

Everything a round touches — per-task params, per-task method state (stale
stores, StaleVRE beta estimators), the PRNG key, the round counter and the
cached sampler ``losses_ns`` — lives in one ``ExperimentState``, and a
round is one call:

    state', metrics = engine.round_step(state)

The round runs the paper's steps: a per-client loss probe, the LVR
water-filling probabilities, the per-processor assignment draw, cohort
local SGD (``torch.func`` per-client gradients), the unbiased coefficients,
the method's aggregation, and the Sec. 3.3 monitors.  Every draw is the
reference's threefry draw (``repro_torch.prng``), keyed by index, so the
engine follows the JAX engine's trajectory from the same state.

Layout.  Tasks group by compile signature (``task_signature``) exactly as
in the reference, and the state keeps the reference's per-group stacking:
``params[g]`` is a [T_g, P_g] tensor of flat parameters and
``method_state[g]`` a dict of [T_g, ...] leaves.  ``FlatLayout`` gives the
parameter-shaped views.  A stale store is ``method_state[g]["h"][j]``, one
contiguous [N, P] tensor that the ``stale_agg_refresh`` kernel refreshes IN
PLACE: ``round_step`` consumes its input state (rebind the result), as the
reference's donated dispatches do.  Inside a group the tasks run in a
Python loop.

Device.  The engine runs on the card unless the caller asks for the CPU:
``RoundEngine(..., device="cuda")`` is the default and raises without a
GPU.  Kernels follow the tensors: on the card the wrappers launch the
Hopper kernels, on the CPU they run their plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import convergence, methods, sampling
from repro_torch.core.stale import FlatLayout

# samples per client the stats-phase loss probe reads: min(cap, PROBE_TAKE)
PROBE_TAKE = 64

# the method-state key of the stale store, refreshed in place by the kernel
STORE_KEY = "h"


def resolve_device(device: Any) -> torch.device:
    """The engine's device.  A CUDA device needs a GPU: without one this
    raises instead of running on the CPU — pass ``device="cpu"`` for that."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' (the default) needs a CUDA GPU and none is "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass
class ModelAdapter:
    """Functional model interface: ``init(key) -> {leaf: tensor}``,
    ``loss_fn(params, batch)``, ``accuracy(params, batch)``.
    ``jax_leaves`` maps each leaf to its path and layout change in the
    reference's parameter tree (``repro_torch.convert``)."""
    init: Callable[[torch.Tensor], Dict[str, torch.Tensor]]
    loss_fn: Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]],
                      torch.Tensor]
    accuracy: Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]],
                       torch.Tensor]
    jax_leaves: Dict[str, Tuple[Tuple[str, ...], Optional[str]]] = \
        dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Task:
    """One FL model + its federated data.

    data: {"x": [N, cap, ...], "y": [N, cap, ...], "count": [N]} per-client
    padded arrays; test: {"x": [T, ...], "y": [T]} server-held eval set
    (numpy arrays or tensors)."""
    name: str
    model: ModelAdapter
    data: Dict[str, Any]
    test: Dict[str, Any]


@dataclasses.dataclass
class ServerConfig:
    method: str = "lvr"
    active_rate: float = 0.1          # m = active_rate * V
    local_epochs: int = 5             # E: minibatch SGD STEPS per round
    batch_size: int = 16
    lr: float = 0.05
    lr_decay: float = 1.0             # eta_tau = lr * decay^tau
    eta_cap: Optional[float] = None   # footnote-3 per-client cap sum_s p <= eta
    seed: int = 0


class ExperimentState(NamedTuple):
    """The complete state of an MMFL experiment.

    ``params``/``method_state`` are per-GROUP tuples (``group_tasks``):
    params[g] is [T_g, P_g], method_state[g] a dict of [T_g, ...] leaves
    (the stale store ``h`` is [T_g, N, P_g]).  ``task_group``/``task_slot``
    map task s to its (group, slot).  ``losses_ns`` caches the [N, S] loss
    reports the sampler saw; ``client_mask`` marks real clients (all 1 in
    this port's unpadded worlds)."""
    params: Tuple[torch.Tensor, ...]
    method_state: Tuple[Dict[str, Any], ...]
    key: torch.Tensor          # [2] threefry key
    round: int
    losses_ns: torch.Tensor    # [N, S]
    client_mask: torch.Tensor  # [N]
    task_group: torch.Tensor   # [S]
    task_slot: torch.Tensor    # [S]


# ---------------------------------------------------------------------------
# compile-signature task grouping
# ---------------------------------------------------------------------------

_PRIMITIVE = (int, float, bool, str, bytes, type(None))


def fn_signature(f: Callable) -> Tuple:
    """Identity of a model function for grouping: the code object plus the
    closure's primitive cell values (non-primitive cells by identity)."""
    code = getattr(f, "__code__", None)
    if code is None:
        return ("obj", id(f))
    cells: Tuple = ()
    if getattr(f, "__closure__", None):
        cells = tuple(
            c.cell_contents if isinstance(c.cell_contents, _PRIMITIVE)
            else ("id", id(c.cell_contents))
            for c in f.__closure__)
    return ("code", code, cells)


def _shape_signature(tree: Dict[str, Any]) -> Tuple:
    return tuple(sorted((k, tuple(np.shape(v)), str(np.asarray(v).dtype)
                         if not isinstance(v, torch.Tensor) else str(v.dtype))
                        for k, v in tree.items()))


def task_signature(t: Task) -> Tuple:
    """Tasks with equal signatures share a group: same model code
    (loss/accuracy/init) and identical data/test shapes."""
    return (fn_signature(t.model.loss_fn), fn_signature(t.model.accuracy),
            fn_signature(t.model.init),
            _shape_signature(t.data), _shape_signature(t.test))


def group_tasks(tasks: Sequence[Task]) -> List[List[int]]:
    """Partition task indices into equal-signature groups, first-occurrence
    ordered (slot j of group g is the j-th task of that signature)."""
    sig_to_g: Dict[Tuple, int] = {}
    groups: List[List[int]] = []
    for i, t in enumerate(tasks):
        sig = task_signature(t)
        g = sig_to_g.get(sig)
        if g is None:
            g = len(groups)
            sig_to_g[sig] = g
            groups.append([])
        groups[g].append(i)
    return groups


class World(NamedTuple):
    """Everything world-dependent one round reads, on the engine's device.
    ``data``/``test`` are per-group stacks ([T_g, N, cap, ...])."""
    data: Tuple[Dict[str, torch.Tensor], ...]
    test: Tuple[Dict[str, torch.Tensor], ...]
    B: torch.Tensor            # [N] float32 budgets
    avail: torch.Tensor        # [N, S] bool
    d: torch.Tensor            # [N, S] dataset fractions
    client_mask: torch.Tensor  # [N] float32 (all 1: unpadded worlds)
    proc_client: torch.Tensor  # [V] processor -> client


def build_world_arrays(tasks: Sequence[Task], B: Any, avail: Any,
                       device: torch.device) -> World:
    """Host-side construction of an (unpadded) ``World``: ``d`` and the
    processor map are computed with numpy, as in the reference."""
    B_np = np.asarray(B, np.float32)
    avail_np = np.asarray(avail, bool)
    N = B_np.shape[0]
    counts = np.stack([np.asarray(t.data["count"], np.float32)
                       for t in tasks], axis=1)
    counts = np.where(avail_np, counts, 0.0)
    denom = np.maximum(counts.sum(axis=0, keepdims=True), 1.0)
    d = (counts / denom).astype(np.float32)
    proc_client = np.repeat(np.arange(N, dtype=np.int64),
                            B_np.astype(np.int64))
    groups = group_tasks(tasks)

    def stack(trees):
        return {k: torch.as_tensor(np.stack([np.asarray(t[k]) for t in trees]))
                .to(device) for k in trees[0]}

    return World(
        data=tuple(stack([tasks[i].data for i in grp]) for grp in groups),
        test=tuple(stack([tasks[i].test for i in grp]) for grp in groups),
        B=torch.as_tensor(B_np, device=device),
        avail=torch.as_tensor(avail_np, device=device),
        d=torch.as_tensor(d, device=device),
        client_mask=torch.ones((N,), dtype=torch.float32, device=device),
        proc_client=torch.as_tensor(proc_client, device=device))


def _slot(tree: Dict[str, Any], j: int) -> Dict[str, Any]:
    """Slot j of a group-stacked method-state dict (views)."""
    return {k: (type(v)(*(f[j] for f in v)) if isinstance(v, tuple)
                else v[j]) for k, v in tree.items()}


def _stack_states(per_task: Sequence[Dict[str, Any]],
                  live: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Stack per-task method states along a new group axis.  With ``live``
    (the group's state before the round) the stale store is taken from it
    as it is: the kernel refreshed that storage in place."""
    out = {}
    for k, v in per_task[0].items():
        if live is not None and k == STORE_KEY:
            out[k] = live[k]
        elif isinstance(v, tuple):
            out[k] = type(v)(*(torch.stack([st[k][i] for st in per_task])
                               for i in range(len(v))))
        else:
            out[k] = torch.stack([st[k] for st in per_task])
    return out


class RoundEngine:
    """The per-round transition for one (world, method) pair on one device.

    The engine owns the static world (task data, budgets, availability,
    the strategy); all mutable quantities live in the ``ExperimentState``
    it threads."""

    def __init__(self, tasks: Sequence[Task], B: np.ndarray,
                 avail: np.ndarray, cfg: ServerConfig,
                 device: Any = "cuda"):
        self.device = resolve_device(device)
        self.tasks = list(tasks)
        self.cfg = cfg
        self.S = len(tasks)
        self.N = int(np.asarray(B).shape[0])
        self.world = build_world_arrays(tasks, B, avail, self.device)
        self.B_int = np.asarray(B, np.int64)
        self._B_host = np.asarray(B, np.float32)
        self.V = int(self.B_int.sum())
        self.avail = self.world.avail
        # m rounded through the f32 product, as in the reference
        self.m = float(np.float32(cfg.active_rate) * np.float32(self.V))
        self.d = self.world.d
        self.proc_client = self.world.proc_client
        self.strategy = methods.make(cfg.method, cfg)
        self.cohort_size = self.strategy.cohort_size(self.N, self.m, self.S)
        self._d_v = self.d[self.proc_client]                  # [V, S]
        self._B_v = self.world.B[self.proc_client]            # [V]
        # processor slot k of client i is row start_i + k (proc_client is
        # sorted): the processor -> client sums run slot after slot, the
        # reference's scatter-add order
        starts = np.cumsum(self.B_int) - self.B_int
        self._proc_slots = [
            (torch.as_tensor(np.nonzero(self.B_int > k)[0],
                             device=self.device),
             torch.as_tensor(starts[self.B_int > k] + k, device=self.device))
            for k in range(int(self.B_int.max(initial=0)))]
        self.groups = group_tasks(self.tasks)
        self.n_groups = len(self.groups)
        self.task_gs: List[Tuple[int, int]] = [(-1, -1)] * self.S
        for g, grp in enumerate(self.groups):
            for j, s in enumerate(grp):
                self.task_gs[s] = (g, j)
        # leaf-offset table per group, from the shapes of an init on the
        # meta device (no values are drawn)
        self.layouts = [FlatLayout.of(
            self.tasks[grp[0]].model.init(prng.PRNGKey(0, "meta")))
            for grp in self.groups]
        self._local_all = [self._make_local_all(s) for s in range(self.S)]
        self._loss_all = [self._make_loss_all(s) for s in range(self.S)]
        self._stats_pure = [self.make_stats_fn(s) for s in range(self.S)]
        self._round_pure = [self.make_round_fn(s) for s in range(self.S)]

    # ------------------------------------------------------------------
    # per-task views of the grouped state
    # ------------------------------------------------------------------
    def layout(self, s: int) -> FlatLayout:
        return self.layouts[self.task_gs[s][0]]

    def task_params(self, state: ExperimentState, s: int
                    ) -> Dict[str, torch.Tensor]:
        """Task s's parameter dict (views into its flat params)."""
        g, j = self.task_gs[s]
        return self.layouts[g].views(state.params[g][j])

    def task_data(self, s: int) -> Dict[str, torch.Tensor]:
        g, j = self.task_gs[s]
        return {k: v[j] for k, v in self.world.data[g].items()}

    def task_test(self, s: int) -> Dict[str, torch.Tensor]:
        g, j = self.task_gs[s]
        return {k: v[j] for k, v in self.world.test[g].items()}

    # ------------------------------------------------------------------
    # per-task computations
    # ------------------------------------------------------------------
    def _make_local_all(self, s: int) -> Callable:
        loss_fn = self.tasks[s].model.loss_fn
        layout = self.layout(s)
        E, mb = self.cfg.local_epochs, self.cfg.batch_size

        def loss_xy(p, x, y):
            return loss_fn(p, {"x": x, "y": y})

        grad_fn = torch.func.vmap(torch.func.grad(loss_xy))

        def local_all(w: torch.Tensor, keys: torch.Tensor,
                      data: Dict[str, torch.Tensor], lr: torch.Tensor
                      ) -> torch.Tensor:
            """E minibatch SGD steps for each of the A clients of ``keys``
            [A, 2] from the flat params ``w`` [P]; returns their updates
            G = w0 - w_final as one [A, P] tensor."""
            A = keys.shape[0]
            step_keys = prng.split(keys, E)                      # [A, E, 2]
            count = data["count"].to(torch.int64).clamp_min(1)
            # every step's minibatch indices in one draw: [A, E, mb]
            batch_idx = prng.randint(step_keys, (mb,), 0,
                                     count[:, None, None]).long()
            rows = torch.arange(A, device=w.device)[:, None]
            p = w.expand(A, -1).clone()                          # [A, P]
            views = layout.views(p)
            for e in range(E):
                idx = batch_idx[:, e]
                g = grad_fn(views, data["x"][rows, idx], data["y"][rows, idx])
                # each leaf's gradient is freed once applied: at most one
                # step's [A, P] gradients are alive
                for n in layout.names:
                    views[n].sub_(lr * g.pop(n))
            return p.neg_().add_(w)           # w0 - w_final, in p's storage

        return local_all

    def _make_loss_all(self, s: int) -> Callable:
        loss_fn = self.tasks[s].model.loss_fn
        layout = self.layout(s)
        data = self.task_data(s)
        take = min(int(data["x"].shape[1]), PROBE_TAKE)
        # probe slice bound once: the first ``take`` samples of each client
        probe_x = data["x"][:, :take]
        probe_y = data["y"][:, :take]
        one = torch.func.vmap(lambda p, x, y: loss_fn(p, {"x": x, "y": y}),
                              in_dims=(None, 0, 0))

        def loss_all(w: torch.Tensor) -> torch.Tensor:
            """Per-client loss on the probe batch -> [N]."""
            return one(layout.views(w), probe_x, probe_y)

        return loss_all

    def make_stats_fn(self, s: int) -> Callable:
        """Sampler inputs for task s: the [N] probe losses, and for
        needs-all methods every client's fresh update G [N, P]."""
        strat, N = self.strategy, self.N
        loss_all, local_all = self._loss_all[s], self._local_all[s]
        data = self.task_data(s)

        def stats_fn(w, key, lr):
            losses = loss_all(w)
            if not strat.needs_all_updates:
                return losses, None
            keys = sampling.index_keys(key, N)
            return losses, local_all(w, keys, data, lr)

        return stats_fn

    def _to_clients(self, x_v: torch.Tensor) -> torch.Tensor:
        """Per-processor [V] -> per-client [N] sums, slot by slot."""
        out = torch.zeros((self.N,), dtype=x_v.dtype, device=x_v.device)
        for clients, rows in self._proc_slots:
            out[clients] = out[clients] + x_v[rows]
        return out

    def make_round_fn(self, s: int) -> Callable:
        """Task s's round after sampling: cohort gather + local training +
        the strategy's aggregation."""
        strat = self.strategy
        N, cohort = self.N, self.cohort_size
        d_col, d_v_col = self.d[:, s], self._d_v[:, s]
        B_v = self._B_v
        local_all = self._local_all[s]
        data = self.task_data(s)

        def round_fn(w, state, train_in, p_col, act_v, lr, round_idx):
            """``train_in`` is the task's key (cohort methods train here)
            or the precomputed all-client G (needs-all methods)."""
            coeffs_v = strat.coefficients(d_v_col, B_v, p_col, act_v)
            # l processors of client i on model s act as one update scaled
            # by l (Remark 1)
            coeff_client = self._to_clients(coeffs_v)
            act_client = (self._to_clients(act_v) > 0).to(torch.float32)
            if strat.needs_all_updates:
                idx = torch.arange(N, device=w.device)
                G, coeff, act = train_in, coeff_client, act_client
            else:
                # only the sampled clients train; the stable sort keeps the
                # reference's cohort order, slot-keyed draws its streams
                idx = torch.argsort(-act_client, stable=True)[:cohort]
                keys = sampling.index_keys(train_in, cohort)
                data_c = {k: v[idx] for k, v in data.items()}
                G = local_all(w, keys, data_c, lr)
                coeff, act = coeff_client[idx], act_client[idx]
            return strat.aggregate(w, state, G, coeff, act, idx, d_col=d_col,
                                   lr=lr, round_idx=round_idx)

        return round_fn

    def sampling_metrics(self, p: torch.Tensor, active: torch.Tensor,
                         losses_ns: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The Sec. 3.3 monitors ({H1, Zp, Zl, loss}, [S] each) from the
        sampling-phase arrays, one column per task; every [V]/[N] sum runs
        in index order (``convergence.ordered_sums``)."""
        B_v = self._B_v[:, None]
        coeffs_v = self.strategy.coefficients(self._d_v, B_v, p, active)
        mets = convergence.round_metrics(coeffs_v,
                                         losses_ns[self.proc_client],
                                         self._d_v, B_v)
        mets["loss"] = convergence.ordered_sums(self.d * losses_ns)
        return mets

    # ------------------------------------------------------------------
    # state constructors
    # ------------------------------------------------------------------
    def sampler_ctx(self) -> methods.SamplerContext:
        return methods.SamplerContext(d=self.d, B=self._B_host,
                                      avail=self.avail, m=self.m, V=self.V)

    def init_state(self, seed: Optional[int] = None,
                   key: Optional[torch.Tensor] = None) -> ExperimentState:
        """Fresh experiment state; keys split in the reference's order."""
        if key is None:
            key = prng.PRNGKey(self.cfg.seed if seed is None else seed,
                               self.device)
        params = []
        for t in self.tasks:
            key, k = prng.split(key, 2)
            params.append(t.model.init(k))
        return self.assemble_state(
            [self.layout(s).flatten(params[s]) for s in range(self.S)], key)

    def assemble_state(self, flat_params: Sequence[torch.Tensor],
                       key: torch.Tensor) -> ExperimentState:
        """Round-0 state from per-task flat params [P_s] and a key, with
        fresh method state (zero stores)."""
        dev = self.device
        params, mstate = [], []
        for g, grp in enumerate(self.groups):
            params.append(torch.stack([flat_params[s].to(dev, torch.float32)
                                       for s in grp]))
            mstate.append(_stack_states([
                self.strategy.init_state(self.layouts[g].P, self.N, dev)
                for _ in grp]))
        return ExperimentState(
            params=tuple(params), method_state=tuple(mstate),
            key=key.to(dev), round=0,
            losses_ns=torch.ones((self.N, self.S), dtype=torch.float32,
                                 device=dev),
            client_mask=self.world.client_mask,
            task_group=torch.as_tensor([g for g, _ in self.task_gs],
                                       dtype=torch.int32, device=dev),
            task_slot=torch.as_tensor([j for _, j in self.task_gs],
                                      dtype=torch.int32, device=dev))

    # ------------------------------------------------------------------
    # the round transition
    # ------------------------------------------------------------------
    @torch.no_grad()
    def round_step(self, state: ExperimentState
                   ) -> Tuple[ExperimentState, Dict[str, torch.Tensor]]:
        """state -> (state', metrics).  The input's stale stores are
        refreshed in place: rebind the result.

        Metrics: {H1, Zp, Zl, loss} [S]; ``beta`` [S, N] for the stale
        family; ``active`` [V, S], the round's participation draw."""
        cfg, S, dev = self.cfg, self.S, self.device
        strat = self.strategy
        f32 = np.float32
        lr = torch.tensor(f32(cfg.lr) * f32(cfg.lr_decay) ** f32(state.round),
                          dtype=torch.float32, device=dev)
        round_f = torch.tensor(float(state.round), dtype=torch.float32,
                               device=dev)
        keys = prng.split(state.key, 2 + S)
        new_key, k_sample, task_keys = keys[0], keys[1], keys[2:]

        # ---- 1) stats for the sampler ------------------------------------
        stats = [self._stats_pure[s](state.params[g][j], task_keys[s], lr)
                 for s, (g, j) in enumerate(self.task_gs)]
        losses_ns = torch.stack([st[0] for st in stats], dim=1)      # [N,S]

        # ---- 2) sampling ---------------------------------------------------
        ctx = self.sampler_ctx()
        p = strat.probabilities(ctx, losses_ns)                      # [V,S]
        active = strat.sample(k_sample, p)

        # ---- 3) Sec. 3.3 monitors ------------------------------------------
        metrics = self.sampling_metrics(p, active, losses_ns)

        # ---- 4) per-task round, task by task inside each group -------------
        new_params, new_mstate = [], []
        betas: Dict[int, torch.Tensor] = {}
        for g, grp in enumerate(self.groups):
            ws, sts = [], []
            for j, s in enumerate(grp):
                train_in = (stats[s][1] if strat.needs_all_updates
                            else task_keys[s])
                new_w, new_st, extras = self._round_pure[s](
                    state.params[g][j], _slot(state.method_state[g], j),
                    train_in, p[:, s], active[:, s], lr, round_f)
                ws.append(new_w)
                sts.append(new_st)
                if "beta" in extras:
                    betas[s] = extras["beta"]
            new_params.append(torch.stack(ws))
            new_mstate.append(_stack_states(sts, live=state.method_state[g])
                              if sts[0] else {})
        if betas:
            metrics["beta"] = torch.stack([betas[s] for s in range(S)])
        metrics["active"] = active
        new_state = state._replace(
            params=tuple(new_params), method_state=tuple(new_mstate),
            key=new_key, round=state.round + 1, losses_ns=losses_ns)
        return new_state, metrics

    def rollout(self, state: ExperimentState, n_rounds: int
                ) -> Tuple[ExperimentState, Dict[str, torch.Tensor]]:
        """``n_rounds`` rounds; metrics stacked along a leading round axis."""
        per_round = []
        for _ in range(int(n_rounds)):
            state, mets = self.round_step(state)
            per_round.append(mets)
        return state, {k: torch.stack([m[k] for m in per_round])
                       for k in per_round[0]}

    @torch.no_grad()
    def evaluate(self, state: ExperimentState) -> List[float]:
        """[S] test accuracies."""
        return [float(self.tasks[s].model.accuracy(
            self.task_params(state, s), self.task_test(s)))
            for s in range(self.S)]
