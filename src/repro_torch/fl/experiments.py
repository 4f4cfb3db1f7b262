"""Builders + the ``run_experiment`` entry point for the paper's §6.1
experiment settings on synthetic data, the port of
``repro.fl.experiments``.

``build_setting(n_models, ...)`` reproduces:
  * 120 clients; each client sees 30% of labels;
  * model-specific high/low data groups (10% / 90%);
  * availability: 90% of clients can train all S models, 10% only S-1;
  * budgets B_i: 25% |S_i|, 50% ceil(|S_i|/2), 25% 1;
  * 3-model setting: 3x Fashion-MNIST-like CNN tasks (and any S != 5:
    S image tasks).

``build_model_setting(archs, ...)`` builds the real-model world: one LM
task per registry arch (qwen3-like transformer, falcon-mamba) through the
full model stack and its kernels.

The worlds come from the port's own numpy generators, so for one seed they
are the reference's worlds, array for array.  Entry points run on the card
(``ExperimentSpec.device="cuda"``) unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import (PROBE_TAKE, ModelAdapter, RoundEngine,
                                     ServerConfig, Task)
from repro_torch.data import partition, synthetic
from repro_torch.models import cnn, transformer


def _cnn_adapter(n_classes: int, channels: int, in_ch: int = 1
                 ) -> ModelAdapter:
    return ModelAdapter(
        init=lambda key: cnn.init(key, n_classes, channels, in_ch),
        loss_fn=cnn.loss_fn,
        accuracy=cnn.accuracy,
        jax_leaves=cnn.JAX_LEAVES,
    )


def _image_task(rng, name: str, n_clients: int, n_classes: int = 10,
                channels: int = 8, n_per_class: int = 200) -> Task:
    x, y = synthetic.make_image_task(rng, n_classes=n_classes,
                                     n_per_class=n_per_class)
    n_test = max(64, len(y) // 10)
    test = {"x": x[:n_test], "y": y[:n_test]}
    part = partition.label_shard_partition(rng, x[n_test:], y[n_test:],
                                           n_clients)
    data = {k: v for k, v in part.items() if k != "high"}
    return Task(name=name, model=_cnn_adapter(n_classes, channels),
                data=data, test=test)


def align_task_caps(tasks: List[Task]) -> List[Task]:
    """Wrap-pad per-task sample capacities to the max among tasks that
    agree on every other data/test shape, so same-architecture tasks share
    a group.  Nothing reads rows beyond ``count`` and the probe takes
    min(cap, 64), so caps >= 64 train identically; caps under the probe
    boundary stay unaligned."""
    sig = lambda t: (
        tuple((k, v.shape[:1] + v.shape[2:], str(v.dtype))
              for k, v in sorted(t.data.items()) if k != "count"),
        tuple((k, tuple(v.shape), str(v.dtype))
              for k, v in sorted(t.test.items())))
    cap_to: Dict[Any, int] = {}
    for t in tasks:
        key = sig(t)
        cap_to[key] = max(cap_to.get(key, 0), int(t.data["x"].shape[1]))
    out = []
    for t in tasks:
        cap, target = int(t.data["x"].shape[1]), cap_to[sig(t)]
        if cap == target or cap < PROBE_TAKE:
            out.append(t)
            continue
        wrap = np.arange(target) % cap
        data = {k: (np.asarray(v)[:, wrap] if k in ("x", "y") else v)
                for k, v in t.data.items()}
        out.append(Task(name=t.name, model=t.model, data=data, test=t.test))
    return out


def build_setting(n_models: int = 3, n_clients: int = 120, seed: int = 0,
                  small: bool = False
                  ) -> Tuple[List[Task], np.ndarray, np.ndarray]:
    """Returns (tasks, B, avail).  ``small=True`` shrinks the world for
    CPU-speed tests while keeping its structure."""
    if n_models == 5:
        raise NotImplementedError(
            "the 5-model world (CIFAR-like CNN, EMNIST-like CNN and the "
            "Shakespeare LSTM) is not ported yet")
    rng = np.random.default_rng(seed)
    if small:
        n_clients = min(n_clients, 24)
    npc = 60 if small else 200
    name = "fmnist" if n_models == 3 else "task"
    tasks = [_image_task(rng, f"{name}-{i}", n_clients, n_per_class=npc)
             for i in range(n_models)]
    avail = partition.availability(rng, n_clients, n_models)
    B = partition.processor_budgets(rng, avail)
    return align_task_caps(tasks), B, avail


# ---------------------------------------------------------------------------
# micro setting: linear softmax tasks
# ---------------------------------------------------------------------------


def _linear_adapter(n_feat: int, n_classes: int) -> ModelAdapter:
    def init(key):
        k1, _ = prng.split(key, 2)
        return {"w": 0.01 * prng.normal(k1, (n_feat, n_classes)),
                "b": torch.zeros((n_classes,), dtype=torch.float32,
                                 device=key.device)}

    def loss_fn(p, batch):
        logits = batch["x"] @ p["w"] + p["b"]
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, 1, batch["y"].long()[:, None]).mean()

    def accuracy(p, batch):
        logits = batch["x"] @ p["w"] + p["b"]
        return (logits.argmax(-1) == batch["y"].long()).float().mean()

    return ModelAdapter(init=init, loss_fn=loss_fn, accuracy=accuracy,
                        jax_leaves={"w": (("w",), None), "b": (("b",), None)})


def build_linear_setting(n_models: int = 2, n_clients: int = 16,
                         n_feat: int = 16, n_classes: int = 4,
                         cap: int = 32, seed: int = 0
                         ) -> Tuple[List[Task], np.ndarray, np.ndarray]:
    """Tiny separable linear-softmax tasks with heterogeneous budgets."""
    rng = np.random.default_rng(seed)
    tasks: List[Task] = []
    for s in range(n_models):
        W = rng.normal(size=(n_feat, n_classes))
        x = rng.normal(size=(n_clients, cap, n_feat)).astype(np.float32)
        y = np.argmax(x @ W + 0.5 * rng.normal(
            size=(n_clients, cap, n_classes)), axis=-1)
        xt = rng.normal(size=(64, n_feat)).astype(np.float32)
        yt = np.argmax(xt @ W, axis=-1)
        tasks.append(Task(
            name=f"linear-{s}", model=_linear_adapter(n_feat, n_classes),
            data={"x": x, "y": y.astype(np.int32),
                  "count": np.full((n_clients,), cap, np.int32)},
            test={"x": xt, "y": yt.astype(np.int32)}))
    B = rng.integers(1, 4, n_clients)
    avail = np.ones((n_clients, n_models), bool)
    return tasks, B, avail


# ---------------------------------------------------------------------------
# real-model setting: registry archs through the full model stack + kernels
# ---------------------------------------------------------------------------


def _model_cfg(name: str) -> ArchConfig:
    """Test-scale dims for a registry arch: real structure (GQA heads /
    SSM recurrence, RoPE, the family's block wiring) at CPU-test sizes.
    ``.reduced()`` then a further shrink."""
    cfg = get_config(name).reduced()
    return dataclasses.replace(cfg, n_layers=2, d_model=64, d_ff=128,
                               vocab_size=128, n_heads=2, n_kv_heads=1,
                               head_dim=32, ssm_state=8)


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], torch.Tensor]:
    out: Dict[Tuple[str, ...], torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, v in flat.items():
        *head, last = name.split(".")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _arch_adapter(cfg: ArchConfig) -> ModelAdapter:
    """Loss/accuracy/init closures over the full model stack for one arch.

    Leaves are the reference's tree paths joined by dots
    (``blocks.attn.wq.w``), in its layouts ([in, out] dense weights,
    stacked blocks with their leading L axis), so ``jax_leaves`` changes
    no layout.  Call this ONCE per arch config and share the adapter
    across that arch's tasks: ``task_signature`` compares the closures by
    identity, so same-arch tasks share a group and distinct archs split."""

    def init(key):
        return {".".join(path): v for path, v in
                _flatten(transformer.init(key, cfg)).items()}

    def loss_fn(p, batch):
        return transformer.forward(_unflatten(p), cfg,
                                   {"tokens": batch["x"]})[0]

    def accuracy(p, batch):
        lg = transformer.logits(_unflatten(p), cfg, {"tokens": batch["x"]})
        tgt = batch["x"][:, 1:].long()
        return (lg[:, :-1].argmax(-1) == tgt).float().mean()

    paths = _flatten(transformer.init(prng.PRNGKey(0, "meta"), cfg))
    return ModelAdapter(init=init, loss_fn=loss_fn, accuracy=accuracy,
                        jax_leaves={".".join(p): (p, None) for p in paths})


def build_model_setting(archs: Sequence[str] = ("qwen3-0.6b", "qwen3-0.6b",
                                                "falcon-mamba-7b"),
                        n_clients: int = 8, cap: int = 8, seq_len: int = 16,
                        seed: int = 0,
                        cfgs: Optional[Dict[str, ArchConfig]] = None
                        ) -> Tuple[List[Task], np.ndarray, np.ndarray]:
    """Real-model task world: one LM task per entry of ``archs``, each
    running the registry architecture (at ``_model_cfg`` dims, or at the
    config ``cfgs`` gives for its name) with its own non-iid token shards.
    The default world is the mixed transformer+mamba case: two qwen3 tasks
    share one adapter (one group), the falcon-mamba task forms a second.

    Returns (tasks, B, avail) in the ``build_linear_setting`` contract."""
    rng = np.random.default_rng(seed)
    cfgs = dict(cfgs or {})
    adapters: Dict[str, ModelAdapter] = {}
    tasks: List[Task] = []
    for s, name in enumerate(archs):
        if name not in adapters:
            cfgs.setdefault(name, _model_cfg(name))
            adapters[name] = _arch_adapter(cfgs[name])
        x, test_x = synthetic.make_token_task(rng, cfgs[name].vocab_size,
                                              n_clients, cap, seq_len)
        # next-token targets live inside "x"; "y" is a schema placeholder
        tasks.append(Task(
            name=f"{name}-{s}", model=adapters[name],
            data={"x": x, "y": np.zeros((n_clients, cap), np.int32),
                  "count": np.full((n_clients,), cap, np.int32)},
            test={"x": test_x,
                  "y": np.zeros((test_x.shape[0],), np.int32)}))
    B = rng.integers(1, 4, n_clients)
    return tasks, B, np.ones((n_clients, len(archs)), bool)


# ---------------------------------------------------------------------------
# run_experiment: the engine's entry point
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExperimentSpec:
    """Declarative description of one MMFL experiment (one seed).

    ``eval_every`` rounds run between host evaluations; ``linear=True``
    swaps the CNN world for the linear micro-setting.  ``device`` is where
    the engine runs: the card unless the caller asks for ``"cpu"``."""
    method: str = "lvr"
    n_models: int = 3
    n_clients: int = 120
    rounds: int = 20
    seed: int = 0
    small: bool = False
    linear: bool = False
    data_seed: int = 0
    eval_every: int = 5
    server: Dict[str, Any] = dataclasses.field(default_factory=dict)
    device: str = "cuda"


def build_world(n_models: int, n_clients: int, data_seed: int = 0,
                small: bool = False, linear: bool = False
                ) -> Tuple[List[Task], np.ndarray, np.ndarray]:
    """The (tasks, B, avail) triple an ``ExperimentSpec`` names."""
    if linear:
        return build_linear_setting(n_models=n_models, n_clients=n_clients,
                                    seed=data_seed)
    return build_setting(n_models, n_clients=n_clients, seed=data_seed,
                         small=small)


def build_engine(spec: ExperimentSpec) -> RoundEngine:
    tasks, B, avail = build_world(spec.n_models, spec.n_clients,
                                  data_seed=spec.data_seed, small=spec.small,
                                  linear=spec.linear)
    cfg = ServerConfig(method=spec.method, seed=spec.seed, **spec.server)
    return RoundEngine(tasks, B, avail, cfg, device=spec.device)


def run_experiment(spec: ExperimentSpec) -> Dict[str, Any]:
    """Run one seed of an experiment.

    Returns {"metrics": {key: [rounds, ...] numpy}, "acc": [(round, [S
    accs])...], "final_acc": [S], "state": ExperimentState,
    "engine": RoundEngine}."""
    engine = build_engine(spec)
    state = engine.init_state(seed=spec.seed)
    ev = max(1, spec.eval_every or spec.rounds)
    chunks: List[Dict[str, np.ndarray]] = []
    acc_hist: List[Tuple[int, List[float]]] = []
    done = 0
    while done < spec.rounds:
        n = min(ev, spec.rounds - done)
        state, mets = engine.rollout(state, n)
        chunks.append({k: v.cpu().numpy() for k, v in mets.items()})
        done += n
        acc_hist.append((done, engine.evaluate(state)))
    metrics = {k: np.concatenate([c[k] for c in chunks], axis=0)
               for k in chunks[0]}
    return {"metrics": metrics, "acc": acc_hist,
            "final_acc": acc_hist[-1][1], "state": state, "engine": engine}
