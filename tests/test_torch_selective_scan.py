"""The port's ``selective_scan`` (K5) and ``ssm_scan`` on the CPU against
the reference's Pallas kernel in interpret mode, its sequential oracle and
the model's chunked scan.

On the CPU the wrappers run their plain versions (``ref.py``); the Hopper
kernel itself is held against those plain versions on the card by
``tests/test_torch_cuda.py``.  Tolerances:

  forward           rtol 1e-4, atol 1e-4 (the reference's kernel bound,
                    ``tests/test_kernels.py``: sequential vs chunked scans)
  gradients         rtol 1e-4, atol 1e-4 (both backwards differentiate the
                    sequential recurrence, in two frameworks)
  vmap rule         rtol 1e-6, atol 1e-6 (the same f32 arithmetic on the
                    same rows, batched or one client at a time)

Inputs are drawn with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ops import ssm_scan_pallas
from repro.kernels.selective_scan.ref import selective_scan_ref as jscan_ref
from repro.kernels.selective_scan.selective_scan import \
    selective_scan as jscan
from repro.models import mamba as jmamba
from repro_torch.kernels import launch_counts
from repro_torch.kernels.selective_scan import ops as tops
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.selective_scan.selective_scan import \
    selective_scan as tscan
from repro_torch.models import mamba as tmamba

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(Bsz, S, di, N, seed):
    """(u, dt, B, C, A, D) as numpy f32, the reference test's recipe."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    u, B, C = f(Bsz, S, di), f(Bsz, S, N), f(Bsz, S, N)
    dt = np.logaddexp(f(Bsz, S, di) - 1, 0).astype(np.float32)  # softplus
    A = (-np.exp(f(di, N))).astype(np.float32)
    return u, dt, B, C, A, f(di)


@pytest.mark.parametrize("Bsz,S,di,N", [(1, 32, 64, 8), (2, 48, 128, 16),
                                        (1, 17, 96, 4), (1, 16, 33, 8)])
def test_selective_scan_vs_pallas_interpret(Bsz, S, di, N):
    u, dt, B, C, A, D = _inputs(Bsz, S, di, N, seed=S + di)
    got = tscan(*(torch.tensor(a) for a in (u, dt, B, C, A, D))).numpy()
    jargs = [jnp.asarray(a) for a in (u, dt, B, C, A, D)]
    np.testing.assert_allclose(
        got, np.asarray(jscan(*jargs, block_d=32, chunk=16, interpret=True)),
        **TOL)
    np.testing.assert_allclose(got, np.asarray(jscan_ref(*jargs)), **TOL)


def test_ssm_scan_matches_the_chunked_scans():
    """``ssm_scan`` (wrapper order: A third) == the reference model's
    chunked associative scan and the port's own chunked ``_ssm_scan``,
    whose final state also matches the reference's."""
    u, dt, B, C, A, D = _inputs(2, 40, 64, 8, seed=5)
    targs = [torch.tensor(a) for a in (u, dt, A, B, C, D)]
    y = tops.ssm_scan(*targs).numpy()
    jy, jh = jmamba._ssm_scan(*(jnp.asarray(a) for a in (u, dt, A, B, C, D)))
    np.testing.assert_allclose(y, np.asarray(jy), **TOL)
    ty, th = tmamba._ssm_scan(*targs)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(ty.numpy(), y, **TOL)


def test_ssm_scan_grad_vs_pallas_interpret():
    """The vjp of ``ssm_scan`` with one cotangent against ``jax.vjp``
    through the reference's ``ssm_scan_pallas`` (interpret mode), for all
    six operands; and the Function's backward IS autograd through the
    plain recurrence."""
    u, dt, B, C, A, D = _inputs(1, 32, 64, 8, seed=10)
    ct = np.random.default_rng(11).normal(size=u.shape).astype(np.float32)
    targs = [torch.tensor(a) for a in (u, dt, A, B, C, D)]
    _, vjp_t = torch.func.vjp(tops.ssm_scan, *targs)
    _, vjp_j = jax.vjp(lambda *a: ssm_scan_pallas(*a, interpret=True),
                       *(jnp.asarray(a) for a in (u, dt, A, B, C, D)))
    got = vjp_t(torch.tensor(ct))
    for a, b in zip(got, vjp_j(jnp.asarray(ct))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    _, vjp_r = torch.func.vjp(
        lambda u_, dt_, A_, B_, C_, D_: selective_scan_ref(u_, dt_, B_, C_,
                                                           A_, D_), *targs)
    for a, b in zip(got, vjp_r(torch.tensor(ct))):
        assert torch.equal(a, b)


def test_vmap_grad_with_per_client_A_and_D(monkeypatch):
    """``vmap(grad(loss))`` over a cohort whose clients each have their own
    A and D == the per-client loop; the forward reaches the kernel wrapper
    ONCE, with the clients folded into the batch axis and A, D carried as
    its group axis."""
    n, Bsz, S, di, N = 3, 2, 20, 24, 8
    per = [_inputs(Bsz, S, di, N, seed=40 + i) for i in range(n)]
    u, dt, B, C, A, D = (torch.tensor(np.stack([p[j] for p in per]))
                         for j in range(6))

    def loss(A_, D_, u_, dt_, B_, C_):
        return torch.sin(tops.ssm_scan(u_, dt_, A_, B_, C_, D_)).sum()

    calls = []
    real = tops.selective_scan

    def spy(u_, dt_, B_, C_, A_, D_):
        calls.append((tuple(u_.shape), tuple(A_.shape), tuple(D_.shape)))
        return real(u_, dt_, B_, C_, A_, D_)

    monkeypatch.setattr(tops, "selective_scan", spy)
    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(
        A, D, u, dt, B, C)
    assert calls == [((n * Bsz, S, di), (n, di, N), (n, di))]
    for i in range(n):
        want = torch.func.grad(loss, argnums=(0, 1, 2))(
            A[i], D[i], u[i], dt[i], B[i], C[i])
        for a, b in zip(grads, want):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)
    # shared (unbatched) A and D reach the wrapper once, uncopied (G = 1)
    calls.clear()
    y = torch.func.vmap(lambda u_: tops.ssm_scan(u_, dt[0], A[0], B[0],
                                                 C[0], D[0]))(u)
    assert calls == [((n * Bsz, S, di), (di, N), (di,))]
    for i in range(n):
        np.testing.assert_allclose(
            y[i].numpy(), tops.ssm_scan(u[i], dt[0], A[0], B[0], C[0],
                                        D[0]).numpy(), rtol=1e-6, atol=1e-6)


def test_grouped_A_and_D_read_by_row_blocks():
    """A [G, di, N] and D [G, di]: batch row b reads group b // (Bsz // G)
    — the same as one call per group."""
    G, per, S, di, N = 2, 3, 12, 16, 4
    groups = [_inputs(per, S, di, N, seed=70 + g) for g in range(G)]
    cat = lambda j: torch.tensor(np.concatenate([g[j] for g in groups]))
    stack = lambda j: torch.tensor(np.stack([g[j] for g in groups]))
    y = tscan(cat(0), cat(1), cat(2), cat(3), stack(4), stack(5))
    for g in range(G):
        want = tscan(*(torch.tensor(a) for a in groups[g]))
        assert torch.equal(y[g * per:(g + 1) * per], want)


def test_cpu_wrapper_takes_plain_version_and_checks_shapes():
    before = dict(launch_counts)
    u, dt, B, C, A, D = (torch.tensor(a) for a in _inputs(2, 8, 16, 4, 1))
    tscan(u, dt, B, C, A, D)
    assert dict(launch_counts) == before
    with pytest.raises(ValueError):
        tscan(u, dt, B, C, A[:, :3], D)
    with pytest.raises(ValueError):      # 3 groups do not divide 2 rows
        tscan(u, dt, B, C, A.expand(3, *A.shape), D.expand(3, *D.shape))
