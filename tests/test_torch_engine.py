"""The port's slices as a whole, on the CPU: the MMFL round of
``repro_torch`` against ``repro``'s from the same state.

Both engines start from one state (``repro_torch.convert.state_from_jax``)
and run 3 rounds (2 on the real-model world).  The participation draws
(``active``) must be EXACT; H1/Zp/Zl/loss, beta, params and the stale
stores agree at rtol 1e-4 / atol 1e-5 (f32 arithmetic in another order,
compounded over the rounds of local SGD; on the real-model world the
worst seen was 7.6e-6 absolute on Zl and 1.2e-7 on params and stores, the
reference running its CPU attention and associative scan, the port the
plain kernel versions).  The reference runs inside ``jax.threefry_partitionable(False)``
(scoped, never process-wide)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.engine import RoundEngine as JEngine
from repro.core.engine import ServerConfig as JConfig
from repro.fl import experiments as jexp
from repro_torch import convert
from repro_torch.core.engine import RoundEngine as TEngine
from repro_torch.core.engine import ServerConfig as TConfig
from repro_torch.fl import experiments as texp

RTOL, ATOL = 1e-4, 1e-5

LINEAR = ("build_linear_setting", {})
CNN_SMALL = ("build_setting", dict(n_models=2, n_clients=16, small=True))
# 2 x qwen3-like transformer + 1 x falcon-mamba at ``_model_cfg`` dims
MODEL = ("build_model_setting", {})


def _reference_active(engine, key_before, state_after, round_idx):
    """The reference round's participation draw, recomputed from its keys
    and the loss reports it left in the state."""
    keys = jax.random.split(key_before, 2 + engine.S)
    ctx = engine.sampler_ctx(jnp.asarray(round_idx, jnp.int32))
    p = (engine.strategy.probabilities(ctx, state_after.losses_ns, None)
         * engine.world.proc_mask[:, None])
    return np.asarray(engine.strategy.sample(keys[1], p, ctx,
                                             state_after.losses_ns))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _run_both(method, world, server, rounds=3):
    maker, kw = world
    with jax.threefry_partitionable(False):
        tasks, B, avail = getattr(jexp, maker)(**kw)
        jeng = JEngine(tasks, B, avail, JConfig(method=method, **server))
        jst = jeng.init_state()
        ttasks, tB, tavail = getattr(texp, maker)(**kw)
        teng = TEngine(ttasks, tB, tavail, TConfig(method=method, **server),
                       device="cpu")
        tst = convert.state_from_jax(jax.tree.map(np.asarray, jst), teng)
        for r in range(rounds):
            key_before = jnp.asarray(np.asarray(jst.key))
            jst, jm = jeng.round_step(jst)
            tst, tm = teng.round_step(tst)
            active = _reference_active(jeng, key_before, jst, r)
            assert np.array_equal(tm["active"].numpy(), active), \
                f"{method} round {r}: participation draws differ"
            for k, v in jm.items():
                _close(tm[k].numpy(), v, f"{method} round {r} {k}")
            for s in range(jeng.S):
                want = jax.tree.map(np.asarray, jeng.task_params(jst, s))
                got = convert.params_to_numpy(tst, teng)[s]
                jax.tree.map(lambda a, b: _close(a, b, f"{method} params"),
                             got, want)
        if teng.strategy.uses_stale_store:
            for s in range(jeng.S):
                want = jax.tree.map(np.asarray,
                                    jeng.task_method_state(jst, s))
                got = convert.method_state_to_numpy(tst, teng)[s]
                jax.tree.map(lambda a, b: _close(a, b, f"{method} store"),
                             got["h"], want["h"])
                assert np.array_equal(got["h_valid"], want["h_valid"])
    return jm, tm


@pytest.mark.parametrize("method", ["lvr", "random", "stalevre", "stalevr"])
def test_linear_world_three_rounds_match_reference(method):
    _run_both(method, LINEAR, {})


@pytest.mark.parametrize("method", ["stalevre", "stalevr"])
def test_cnn_world_three_rounds_match_reference(method):
    _run_both(method, CNN_SMALL, dict(local_epochs=2))


@pytest.mark.parametrize("method", ["lvr", "stalevre"])
def test_model_world_two_rounds_match_reference(method):
    """The real-model world (two signature groups: [qwen3, qwen3] and
    [falcon-mamba]) with the settings of the reference's fused-vs-loop
    test: local SGD through attention (K4) and the selective scan (K5)."""
    _run_both(method, MODEL, dict(local_epochs=1, batch_size=4,
                                  active_rate=0.5), rounds=2)


def test_worlds_match_reference():
    """The port's own numpy copies build the reference's worlds exactly."""
    for maker, kw in (LINEAR, CNN_SMALL, MODEL):
        jt, jB, ja = getattr(jexp, maker)(**kw)
        tt, tB, ta = getattr(texp, maker)(**kw)
        assert np.array_equal(jB, tB) and np.array_equal(ja, ta)
        for a, b in zip(jt, tt):
            assert a.name == b.name
            for part in ("data", "test"):
                for k in getattr(a, part):
                    assert np.array_equal(np.asarray(getattr(a, part)[k]),
                                          np.asarray(getattr(b, part)[k]))


def test_engine_static_world_matches_reference():
    tasks, B, avail = jexp.build_setting(n_models=3, n_clients=24, small=True)
    ttasks, tB, tavail = texp.build_setting(n_models=3, n_clients=24,
                                            small=True)
    for method in ("lvr", "stalevre"):
        jeng = JEngine(tasks, B, avail, JConfig(method=method))
        teng = TEngine(ttasks, tB, tavail, TConfig(method=method),
                       device="cpu")
        assert teng.groups == jeng.groups
        assert (teng.m, teng.V, teng.cohort_size) == (jeng.m, jeng.V,
                                                      jeng.cohort_size)
        assert np.array_equal(teng.d.numpy(), np.asarray(jeng.d))
        assert np.array_equal(teng.proc_client.numpy(),
                              np.asarray(jeng.proc_client))


def test_convert_round_trip_is_exact():
    """reference state -> port -> reference layout gives back the same
    params and stores, bit for bit (pure layout changes)."""
    with jax.threefry_partitionable(False):
        tasks, B, avail = jexp.build_setting(**CNN_SMALL[1])
        jeng = JEngine(tasks, B, avail, JConfig(method="stalevre",
                                                local_epochs=1))
        jst, _ = jeng.round_step(jeng.init_state())
    ttasks, tB, tavail = texp.build_setting(**CNN_SMALL[1])
    teng = TEngine(ttasks, tB, tavail, TConfig(method="stalevre"),
                   device="cpu")
    tst = convert.state_from_jax(jax.tree.map(np.asarray, jst), teng)
    assert tst.round == 1
    for s in range(jeng.S):
        want = jax.tree.map(np.asarray, jeng.task_params(jst, s))
        got = convert.params_to_numpy(tst, teng)[s]
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                     got, want)
        wms = jax.tree.map(np.asarray, jeng.task_method_state(jst, s))
        gms = convert.method_state_to_numpy(tst, teng)[s]
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                     gms["h"], wms["h"])
        for a, b in zip(gms["beta"], wms["beta"]):
            np.testing.assert_array_equal(a, b)


def test_cnn_init_matches_reference_bitwise():
    """The port draws the §6.1 CNN's init with the reference's threefry
    stream: identical values in the port's layouts."""
    from repro.models import cnn as jcnn
    from repro_torch import prng
    from repro_torch.models import cnn as tcnn
    with jax.threefry_partitionable(False):
        want = jax.tree.map(np.asarray,
                            jcnn.init(jax.random.PRNGKey(3), 10, 8))
    got = tcnn.init(prng.PRNGKey(3), 10, 8)
    for name, (path, _) in tcnn.JAX_LEAVES.items():
        ref = want[path[0]][path[1]]
        out = got[name].numpy()
        if out.ndim == 4:
            out = out.transpose(2, 3, 1, 0)
        elif out.ndim == 2:
            out = out.T
        assert np.array_equal(out, ref), name


def test_store_is_refreshed_in_place():
    """The stale store keeps its storage across rounds: the kernel (here
    its plain version) writes into the live [N, P] tensor."""
    ttasks, tB, tavail = texp.build_linear_setting()
    teng = TEngine(ttasks, tB, tavail, TConfig(method="stalevre"),
                   device="cpu")
    st = teng.init_state()
    ptr = st.method_state[0]["h"].data_ptr()
    for _ in range(2):
        st, _ = teng.round_step(st)
    assert st.method_state[0]["h"].data_ptr() == ptr
    assert st.method_state[0]["h"].abs().sum() > 0


def test_stalevr_store_is_refreshed_in_place():
    """The needs-all method (every client in the cohort) also refreshes the
    live store: same storage, and rows of inactive clients keep their
    values from before the round."""
    ttasks, tB, tavail = texp.build_linear_setting()
    teng = TEngine(ttasks, tB, tavail, TConfig(method="stalevr"),
                   device="cpu")
    st, _ = teng.round_step(teng.init_state())
    h = st.method_state[0]["h"]
    ptr, before = h.data_ptr(), h.clone()
    st, mets = teng.round_step(st)
    h = st.method_state[0]["h"]
    assert h.data_ptr() == ptr
    # active is [V, S] over processors; a client trained task 0 if any of
    # its processors did
    trained = np.zeros(teng.N, bool)
    trained[teng.proc_client.numpy()[mets["active"][:, 0].numpy() > 0]] = True
    idle = ~trained
    assert idle.any() and not idle.all()
    # the group's store is [tasks, N, P]; task 0's rows
    assert np.array_equal(h[0].numpy()[idle], before[0].numpy()[idle])


def test_run_experiment_seed_selects_the_run():
    """``ExperimentSpec.seed`` seeds the init and the draws: one seed
    repeats bit for bit, another gives another trajectory."""
    def run(seed):
        out = texp.run_experiment(texp.ExperimentSpec(
            method="lvr", linear=True, n_models=2, n_clients=16, rounds=2,
            eval_every=2, seed=seed, device="cpu"))
        return out["metrics"]
    a, b, c = run(0), run(0), run(1)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["loss"], c["loss"])


@pytest.mark.parametrize("maker,kw", [LINEAR, CNN_SMALL, MODEL],
                         ids=["linear", "cnn", "model"])
def test_layout_from_meta_init_equals_real_init(maker, kw):
    """The engine reads each group's leaf table from an init on the meta
    device (shapes, no draws): the same table as a real init's."""
    from repro_torch import prng
    from repro_torch.core.stale import FlatLayout
    tasks, B, avail = getattr(texp, maker)(**kw)
    eng = TEngine(tasks, B, avail, TConfig(), device="cpu")
    for g, grp in enumerate(eng.groups):
        real = tasks[grp[0]].model.init(prng.PRNGKey(0))
        want = FlatLayout.of(real)
        got = eng.layouts[g]
        assert (got.names, got.shapes, got.offsets, got.P) == \
            (want.names, want.shapes, want.offsets, want.P)
        assert all(v.device.type == "cpu" for v in real.values())
