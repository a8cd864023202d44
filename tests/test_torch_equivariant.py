"""The port's Cartesian-irrep building blocks (``models/equivariant.py``)
against the reference's (``repro.models.equivariant``), on the same
inputs drawn with numpy from a seed: every function's outputs, and the
first and second derivatives of the edge basis and the radial basis,
also at r = 0 (the padding edges of a molecule batch point at node 0, so
their edge vector is zero).

Tolerance: 1e-5 of each output's largest |value| for the functions (f32,
the same arithmetic in another order), 1e-4 of each derivative's largest
|value| (the rule of tests/test_torch_gnn.py); at r = 0 the derivatives
reach 1e6 (1 / eps) and 1e12, and are held to the same share of their
own scale."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import equivariant as jeq  # noqa: E402
from repro_torch.models import equivariant as eq  # noqa: E402

OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def close(got, want, share=OUT_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= share * max(np.abs(want).max(), 1e-30)


def irreps(E=40, C=6, seed=0):
    """(s, V, T, rvec) for E edges of C channels, two zero edge vectors."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(E, C)).astype(np.float32)
    V = rng.normal(size=(E, C, 3)).astype(np.float32)
    T = rng.normal(size=(E, C, 3, 3)).astype(np.float32)
    rvec = (rng.normal(size=(E, 3)) * 2).astype(np.float32)
    rvec[:2] = 0.0
    return s, V, T, rvec


def both(fn_name, *args):
    """The port's and the reference's ``fn_name`` on the same arrays."""
    got = getattr(eq, fn_name)(*(torch.as_tensor(a) for a in args))
    want = getattr(jeq, fn_name)(*(jnp.asarray(a) for a in args))
    return got, want


def test_n_paths():
    assert eq.N_PATHS == jeq.N_PATHS == 3


def test_traceless_sym_matches_and_is_traceless_symmetric():
    M = np.random.default_rng(1).normal(size=(7, 5, 3, 3)).astype(np.float32)
    got, want = both("traceless_sym", M)
    close(got.numpy(), want)
    trace = got.diagonal(dim1=-2, dim2=-1).sum(-1)
    assert float(trace.abs().max()) <= 1e-6 * np.abs(M).max()
    assert float((got - got.transpose(-1, -2)).abs().max()) == 0.0


def test_edge_basis_matches_also_at_r_zero():
    *_, rvec = irreps()
    (d, rhat, Y2), (jd, jrhat, jY2) = both("edge_basis", rvec)
    for g, w in ((d, jd), (rhat, jrhat), (Y2, jY2)):
        close(g.numpy(), w)
    assert float(rhat[:2].abs().max()) == 0.0
    assert float(d[:2].min()) == pytest.approx(1e-6)


@pytest.mark.parametrize("n_rbf,cutoff", [(4, 5.0), (8, 5.0), (8, 3.0)])
def test_bessel_rbf_matches(n_rbf, cutoff):
    d = np.concatenate([[1e-6, 1e-9, 0.0], np.linspace(0.05, 6.0, 40)]
                       ).astype(np.float32)
    got, want = both("bessel_rbf", d, n_rbf, cutoff)
    close(got.numpy(), want)


@pytest.mark.parametrize("fn", ["tp_to_scalar", "tp_to_vector",
                                "tp_to_tensor"])
def test_tensor_product_paths_match(fn):
    s, V, T, rvec = irreps()
    _, rhat, Y2 = jeq.edge_basis(jnp.asarray(rvec))
    got, want = both(fn, s, V, T, np.array(rhat), np.array(Y2))
    assert got.shape[-1] == eq.N_PATHS
    close(got.numpy(), want)


def test_gated_nonlin_matches():
    s, V, T, _ = irreps()
    gates = np.random.default_rng(2).normal(size=(s.shape[0], 2 * s.shape[1])
                                            ).astype(np.float32)
    got, want = both("gated_nonlin", s, V, T, gates)
    for g, w in zip(got, want):
        close(g.numpy(), w)


def test_correlation_products_match():
    s, V, T, _ = irreps()
    got, want = both("correlation_products", s, V, T)
    for g, w in zip(got, want):
        close(g.numpy(), w)


def _radial(rvec, lib, n_rbf=8, cutoff=5.0):
    """A scalar of the edge basis and the radial basis: every output
    weighted by fixed numbers, so that its gradient reaches each."""
    m = lib
    d, rhat, Y2 = m.edge_basis(rvec)
    rbf = m.bessel_rbf(d, n_rbf, cutoff)
    w = np.random.default_rng(3)
    wr = w.normal(size=(rvec.shape[0], n_rbf)).astype(np.float32)
    wh = w.normal(size=(rvec.shape[0], 3)).astype(np.float32)
    wy = w.normal(size=(rvec.shape[0], 3, 3)).astype(np.float32)
    if m is eq:
        wr, wh, wy = (torch.as_tensor(a) for a in (wr, wh, wy))
    return (rbf * wr).sum() + (rhat * wh).sum() + (Y2 * wy).sum()


def test_edge_and_radial_basis_derivatives_match_at_r_zero():
    """First derivatives (d/drvec) and a Hessian-vector product (the second
    derivative the force loss takes) of the edge and radial bases: finite
    at the zero edges, and the reference's everywhere."""
    *_, rvec = irreps()
    v = np.random.default_rng(4).normal(size=rvec.shape).astype(np.float32)
    jf = lambda r: _radial(r, jeq)                              # noqa: E731
    jg = jax.jit(jax.grad(jf))(jnp.asarray(rvec))
    jhv = jax.jit(lambda r, u: jax.jvp(jax.grad(jf), (r,), (u,))[1])(
        jnp.asarray(rvec), jnp.asarray(v))
    r = torch.as_tensor(rvec).requires_grad_(True)
    (g,) = torch.autograd.grad(_radial(r, eq), r, create_graph=True)
    (hv,) = torch.autograd.grad(g, r, grad_outputs=torch.as_tensor(v))
    for got, want in ((g, jg), (hv, jhv)):
        got = got.detach().numpy()
        assert np.isfinite(got).all()
        close(got, want, share=GRAD_TOL)
        # at r = 0 alone, against their own scale
        close(got[:2], np.asarray(want)[:2], share=GRAD_TOL)
    assert np.abs(np.asarray(jhv)[:2]).max() > 1e6     # the r = 0 rows count


def test_gated_nonlin_and_products_are_twice_differentiable():
    """The nonlinearity and the correlation products under a second
    derivative: a Hessian-vector product of a weighted sum of their
    outputs in s, against jax's."""
    s, V, T, _ = irreps(E=10, C=4)
    rng = np.random.default_rng(5)
    gates = rng.normal(size=(10, 8)).astype(np.float32)
    v = rng.normal(size=s.shape).astype(np.float32)

    def f(lib, s, V, T, gates):
        a, b, c = lib.gated_nonlin(s, V, T, gates)
        p, q, r = lib.correlation_products(a, b, c)
        return (p ** 2).sum() + (q ** 2).sum() + (r ** 2).sum()

    args = (jnp.asarray(V), jnp.asarray(T), jnp.asarray(gates))
    jhv = jax.jit(lambda x, u: jax.jvp(jax.grad(
        lambda y: f(jeq, y, *args)), (x,), (u,))[1])(jnp.asarray(s),
                                                     jnp.asarray(v))
    x = torch.as_tensor(s).requires_grad_(True)
    targs = tuple(torch.as_tensor(np.array(a)) for a in args)
    (g,) = torch.autograd.grad(f(eq, x, *targs), x, create_graph=True)
    (hv,) = torch.autograd.grad(g, x, grad_outputs=torch.as_tensor(v))
    close(hv.numpy(), jhv, share=GRAD_TOL)
