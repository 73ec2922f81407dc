"""The gradient of the Mamba2 chunk scan, the port against JAX.

* ``ref.ssd_scan_bwd_ref`` against ``jax.vjp`` of JAX's
  ``repro.kernels.ref.ssd_scan_ref``, with and without ``init``, on zero
  and non-zero decays.  Tolerance: ``g_states`` and ``g_init`` within
  rtol 1e-6 and atol 1e-6 x their largest magnitude (XLA on the CPU
  contracts the adjoint's multiply-add into an FMA, which rounds once
  where the port rounds twice, so the reverse carry parts in the last
  bits); ``g_decay`` within ``ref.ssd_scan_bwd_decay_tol`` (its (P, N)
  sums are taken in another order).
* ``torch.autograd.gradcheck`` of ``ops.SSDScan`` in float64.
* ``ops.ssd_scan``'s outputs are the same with and without a gradient.
* Gradients flow through ``ssd_chunked`` into every input, as in JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import ssm as tssm

SHAPES = [(2, 5, 3, 4, 6), (1, 8, 2, 16, 16), (3, 1, 2, 3, 5)]
DECAYS = {"zero": (0.0, 0.0), "uniform": (0.0, 1.0), "long_memory": (0.95, 1.0)}


def _inputs(seed, shape, decay, with_init):
    rng = np.random.default_rng(seed)
    b, c, h, p, n = shape
    lo, hi = DECAYS[decay]
    states = rng.standard_normal(shape).astype(np.float32)
    dec = (lo + (hi - lo) * rng.random((b, c, h))).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_init else None
    g_prev = rng.standard_normal(shape).astype(np.float32)
    g_final = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return states, dec, init, g_prev, g_final


def _close(got, want, label):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale, err_msg=label)


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_vjp(shape, decay, with_init):
    states, dec, init, g_prev, g_final = _inputs(len(shape) + shape[1], shape, decay, with_init)
    args = (jnp.asarray(states), jnp.asarray(dec)) + ((jnp.asarray(init),) if with_init else ())
    (prev, final), vjp = jax.vjp(lambda *a: jref.ssd_scan_ref(*a), *args)
    want = vjp((jnp.asarray(g_prev), jnp.asarray(g_final)))

    t_prev, _ = tref.ssd_scan_ref(torch.from_numpy(states), torch.from_numpy(dec),
                                  None if init is None else torch.from_numpy(init))
    np.testing.assert_allclose(t_prev.numpy(), np.asarray(prev), rtol=1e-6, atol=1e-6)
    g_states, g_decay, g_init = tref.ssd_scan_bwd_ref(
        torch.from_numpy(g_prev), torch.from_numpy(g_final), t_prev, torch.from_numpy(dec),
        with_init)
    _close(g_states.numpy(), np.asarray(want[0]), "g_states")
    tol = tref.ssd_scan_bwd_decay_tol(g_states, t_prev).numpy()
    err = np.abs(g_decay.numpy() - np.asarray(want[1]))
    assert (err <= tol).all(), (err.max(), tol.min())
    if with_init:
        _close(g_init.numpy(), np.asarray(want[2]), "g_init")
    else:
        assert g_init is None


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_scan_gradcheck_float64(with_init):
    rng = np.random.default_rng(3)
    states = torch.from_numpy(rng.standard_normal((2, 4, 3, 2, 3))).requires_grad_(True)
    dec = torch.from_numpy(rng.random((2, 4, 3))).requires_grad_(True)
    if with_init:
        init = torch.from_numpy(rng.standard_normal((2, 3, 2, 3))).requires_grad_(True)
        assert torch.autograd.gradcheck(ops.ssd_scan, (states, dec, init))
    else:
        assert torch.autograd.gradcheck(lambda s, d: ops.ssd_scan(s, d), (states, dec))


def test_ssd_scan_outputs_do_not_depend_on_grad_mode():
    states, dec, init, _, _ = _inputs(5, (2, 6, 3, 4, 5), "uniform", True)
    args = [torch.from_numpy(a) for a in (states, dec, init)]
    plain = ops.ssd_scan(*args)
    live = [a.clone().requires_grad_(True) for a in args]
    graded = ops.ssd_scan(*live)
    assert graded[0].grad_fn is not None
    for g, w in zip(graded, plain):
        assert torch.equal(g.detach(), w)
    with torch.no_grad():
        assert ops.ssd_scan(*live)[0].grad_fn is None


def test_ssd_scan_without_init_gives_no_init_gradient():
    states, dec, _, g_prev, g_final = _inputs(6, (2, 3, 2, 2, 2), "uniform", False)
    s = torch.from_numpy(states).requires_grad_(True)
    d = torch.from_numpy(dec).requires_grad_(True)
    prev, final = ops.SSDScan.apply(s, d, None)
    (prev * torch.from_numpy(g_prev)).sum().backward(retain_graph=True)
    want = tref.ssd_scan_bwd_ref(torch.from_numpy(g_prev), torch.zeros_like(final), prev.detach(),
                                 d.detach(), False)
    assert want[2] is None
    assert torch.equal(s.grad, want[0]) and torch.equal(d.grad, want[1])
    del g_final


def test_every_ssd_scan_launch_name_is_counted():
    assert {"ssd_scan", "ssd_scan_bwd"} <= set(ops.LAUNCHES)
    assert ops.SOURCE["ssd_scan_bwd"] == "ssd_scan"


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_gradients_match_jax(with_init):
    """The chunked SSD of the float32 smoke shapes (S = 40: a ragged chunk)
    and the gradient of a random projection of its outputs with respect to
    every input, against ``jax.vjp`` of JAX's ``ssd_chunked``."""
    rng = np.random.default_rng(7)
    b, s, h, p, n, q = 2, 40, 4, 8, 16, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (0.05 + 0.5 * rng.random((b, s, h))).astype(np.float32)
    a = -(0.5 + rng.random(h)).astype(np.float32)
    bb = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_init else None
    gy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    gf = rng.standard_normal((b, h, p, n)).astype(np.float32)
    inputs = [x, dt, a, bb, cc] + ([init] if with_init else [])

    def jfn(*args):
        return jssm.ssd_chunked(*args[:5], q, args[5] if with_init else None)

    _, vjp = jax.vjp(jfn, *[jnp.asarray(v) for v in inputs])
    want = vjp((jnp.asarray(gy), jnp.asarray(gf)))
    live = [torch.from_numpy(v).requires_grad_(True) for v in inputs]
    y, final = tssm.ssd_chunked(*live[:5], q, live[5] if with_init else None)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum() + (final * torch.from_numpy(gf)).sum(),
                              live)
    for name, g, w in zip(("x", "dt", "a", "b", "c", "init"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
