"""Banked factorizations (``ops/kernels.py``): the equilibrated Cholesky,
sigma deltas and SPD solve against LAPACK / f64 NumPy, in f64 and at the
f32 bounds ``chip_smoke.py`` holds the card to, and the one size-based
choice between the unrolled and the batched factorization."""

import jax
import jax.extend as jex
import jax.numpy as jnp
import numpy as np
import pytest

from slam_uwv_kalman_filters_tpu.ops import kernels

RNG = np.random.default_rng(31)


def random_spd_batch(nb, n, cond_spread=True):
    out = np.zeros((nb, n, n))
    for i in range(nb):
        a = RNG.normal(size=(n, n))
        out[i] = a @ a.T + n * np.eye(n)
        if cond_spread and i % 3 == 0:
            # wide eigenvalue spread like the real PoseUKF covariance
            d = np.diag(10.0 ** RNG.uniform(-6, 1, n))
            out[i] = d @ out[i] @ d
    return jnp.asarray(out)


def raw_unit_covs(nb, n, seed):
    """Correlated covariances with variances spread over 1e-11..1e1 — the
    raw-unit range of the 53-DOF PoseUKF state (damping parameters to
    velocity), condition ~1e12."""
    rng = np.random.default_rng(seed)
    out = np.zeros((nb, n, n))
    for i in range(nb):
        w = rng.normal(size=(n, n))
        corr = 0.7 * np.eye(n) + 0.3 * (w @ w.T) / n
        s = 1.0 / np.sqrt(np.diag(corr))
        corr = corr * s[:, None] * s[None, :]
        d = np.sqrt(10.0 ** rng.uniform(-11, 1, n))
        out[i] = d[:, None] * corr * d[None, :]
    return out


def f64_deltas(covs):
    """Independent NumPy f64 ukfom deltas: 0, then ±columns of chol(P)."""
    covs = np.asarray(covs, np.float64)
    nb, n = covs.shape[0], covs.shape[-1]
    out = np.zeros((nb, 2 * n + 1, n))
    for b in range(nb):
        L = np.linalg.cholesky(covs[b])
        out[b, 1::2] = L.T
        out[b, 2::2] = -L.T
    return out


def f32_deltas(cov):
    return np.asarray(kernels.sigma_deltas_banked(jnp.asarray(cov, jnp.float32)))


def primitives(jaxpr) -> set:
    """Names of every primitive in ``jaxpr`` and its sub-jaxprs."""
    out = set()
    for eqn in jaxpr.eqns:
        out.add(eqn.primitive.name)
        for param in eqn.params.values():
            for sub in param if isinstance(param, (list, tuple)) else [param]:
                if isinstance(sub, jex.core.ClosedJaxpr):
                    out |= primitives(sub.jaxpr)
                elif isinstance(sub, jex.core.Jaxpr):
                    out |= primitives(sub)
    return out


def test_cholesky_banked_matches_lapack_53():
    covs = random_spd_batch(8, 53)
    out = kernels.cholesky_banked(covs)
    ref = np.linalg.cholesky(np.asarray(covs))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-10, atol=1e-10)
    # strictly lower triangular zeros
    assert np.allclose(np.triu(np.asarray(out)[0], 1), 0.0)


def test_cholesky_banked_pads_nonmultiple_batch():
    """Odd bank sizes factor like any other, in f64 and in f32."""
    covs = random_spd_batch(5, 53)
    out = kernels.cholesky_banked(covs)
    assert out.shape == (5, 53, 53)
    np.testing.assert_allclose(np.asarray(out), np.linalg.cholesky(np.asarray(covs)), atol=1e-10)
    raw = raw_unit_covs(5, 53, seed=1)
    got = f32_deltas(raw)
    assert got.shape == (5, 107, 53)
    scale = np.sqrt(np.diagonal(raw, axis1=1, axis2=2))[:, None, :]
    np.testing.assert_array_less(np.abs(got - f64_deltas(raw)) / scale, 1e-4)


def test_cholesky_banked_small_sizes_unrolled():
    for n in [2, 4, 6]:
        covs = random_spd_batch(3, n, cond_spread=False)
        out = kernels.cholesky_banked(covs)
        np.testing.assert_allclose(
            np.asarray(out), np.linalg.cholesky(np.asarray(covs)), atol=1e-10
        )


def test_sigma_deltas_under_vmap_match_banked_call():
    """The per-instance filter code reaches the deltas one matrix at a time
    under ``vmap``: a vmapped, a nested-vmapped and an unbatched call give
    the deltas of the banked call."""
    covs = random_spd_batch(6, 12)
    ref = f64_deltas(covs)
    np.testing.assert_allclose(np.asarray(kernels.sigma_deltas_banked(covs)), ref, atol=1e-10)
    out = jax.vmap(kernels.sigma_deltas_banked)(covs)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-10)
    nested = jax.vmap(jax.vmap(kernels.sigma_deltas_banked))(covs.reshape(2, 3, 12, 12))
    np.testing.assert_allclose(np.asarray(nested).reshape(6, 25, 12), ref, atol=1e-10)
    one = kernels.sigma_deltas_banked(covs[0])
    np.testing.assert_allclose(np.asarray(one), ref[0], atol=1e-10)


def test_ukf_predict_unchanged_by_kernel_path():
    """Filter results are exact with the banked sigma deltas."""
    from typing import NamedTuple

    from slam_uwv_kalman_filters_tpu.ops import manifolds as mf
    from slam_uwv_kalman_filters_tpu.ops import ukf

    class S(NamedTuple):
        x: jax.Array

    man = mf.make_manifold(mf.Field("x", "vec", 12))
    P = random_spd_batch(1, 12, cond_spread=False)[0]
    Q = 0.01 * jnp.eye(12)
    mu = S(x=jnp.zeros(12))
    A = jnp.asarray(RNG.normal(size=(12, 12)))
    mu2, P2 = ukf.predict(man, mu, P, lambda s: S(x=A @ s.x), Q)
    np.testing.assert_allclose(np.asarray(P2), np.asarray(A @ P @ A.T + Q), atol=1e-8)


def test_sigma_deltas_banked_matches_composition():
    """The dispatched path must equal chol + ±interleave."""
    covs = random_spd_batch(6, 53)
    fused = kernels.sigma_deltas_banked(covs)
    L = np.linalg.cholesky(np.asarray(covs))
    assert fused.shape == (6, 107, 53)
    np.testing.assert_allclose(np.asarray(fused)[:, 0], 0.0, atol=0)
    for j in range(53):
        np.testing.assert_allclose(np.asarray(fused)[:, 2 * j + 1], L[:, :, j], rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(fused)[:, 2 * j + 2], -L[:, :, j], rtol=1e-9, atol=1e-9)
    # covariance-consistency identity: ½ Σ δδᵀ == P
    d = np.asarray(fused)
    recon = 0.5 * np.einsum("bkn,bkm->bnm", d, d)
    np.testing.assert_allclose(recon, np.asarray(covs), rtol=1e-7, atol=1e-8)


def test_solve_spd_banked_matches_numpy():
    """Equilibrated cho_factor/cho_solve vs LAPACK, including
    ill-conditioned inputs, and under vmap."""
    for nb in (5, 8):
        spd = random_spd_batch(nb, 53)
        rhs = jnp.asarray(RNG.normal(size=(nb, 53, 7)))
        out = kernels.solve_spd_banked(spd, rhs)
        ref = np.linalg.solve(np.asarray(spd), np.asarray(rhs))
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-8, atol=1e-8)
    out2 = jax.jit(jax.vmap(lambda a, b: kernels.solve_spd_banked(a[None], b[None])[0]))(spd, rhs)
    np.testing.assert_allclose(np.asarray(out2), ref, rtol=1e-6, atol=1e-7)


def test_banked_ops_skip_pallas_for_f64():
    """f64 banks run the same plain XLA path as f32 ones, with no Pallas
    call anywhere, and the f64 results are exact."""
    spd12 = jnp.zeros((2, 12, 12), jnp.float64)
    assert "pallas_call" not in primitives(jax.make_jaxpr(kernels.sigma_deltas_banked)(spd12).jaxpr)
    rng = np.random.default_rng(7)
    a = rng.normal(size=(130, 12, 12))
    spd = jnp.asarray(a @ np.transpose(a, (0, 2, 1)) + 10 * np.eye(12))
    assert spd.dtype == jnp.float64

    L = kernels.cholesky_banked(spd)
    np.testing.assert_allclose(
        np.asarray(L @ np.transpose(L, (0, 2, 1))), np.asarray(spd), rtol=1e-9, atol=1e-9
    )
    deltas = kernels.sigma_deltas_banked(spd)
    assert deltas.shape == (130, 25, 12)
    rhs = jnp.asarray(rng.normal(size=(130, 12, 2)))
    x = kernels.solve_spd_banked(spd, rhs)
    np.testing.assert_allclose(np.asarray(spd @ x), np.asarray(rhs), atol=1e-8)


# --- f32 sigma deltas against f64 NumPy ------------------------------------


@pytest.mark.parametrize(
    "n,nb",
    [(53, 1), (53, 5), (53, 7), (59, 3), (59, 5), (9, 3), (64, 2)],
)
def test_sigma_deltas_f32_matches_f64_numpy(n, nb):
    """f32 deltas equal the f64 NumPy deltas to f32 accuracy, for the
    PoseUKF (53), its marker augmentation (59), the smallest batched size
    (9) and a 64-wide state, on odd and even banks."""
    covs = raw_unit_covs(nb, n, seed=n + nb)
    got = f32_deltas(covs)
    assert got.shape == (nb, 2 * n + 1, n)
    ref = f64_deltas(covs)
    scale = np.sqrt(np.diagonal(covs, axis1=1, axis2=2))[:, None, :]
    np.testing.assert_array_less(np.abs(got - ref) / scale, 1e-4)
    np.testing.assert_array_equal(got[:, 0], 0.0)


@pytest.mark.parametrize("n", [53, 59])
def test_sigma_deltas_f32_ill_conditioned_raw_units(n):
    """Raw-unit covariances (variances 1e-11..1e1, condition ~1e12): L·Lᵀ
    from the f32 deltas reproduces the correlation matrix to 1e-5, and the
    deltas are within 1e-4 of the f64 deltas, relative to √(Pᵢᵢ·Pⱼⱼ) and
    √Pᵢᵢ — the bounds of ``chip_smoke.check_deltas``, which is the check
    used here."""
    import chip_smoke

    covs = raw_unit_covs(4, n, seed=100 + n)
    got = f32_deltas(covs)
    recon, derr = chip_smoke.check_deltas(got, covs, f"n={n}")
    assert recon < 1e-5 and derr < 1e-4
    # the check is tight enough to catch a 1e-3 relative error in the factor
    bad = got.copy()
    bad[:, 1::2] *= 1.0 + 1e-3
    with pytest.raises(AssertionError):
        chip_smoke.check_deltas(bad, covs, "perturbed")


# --- the size-based choice ----------------------------------------------------


@pytest.mark.parametrize(
    "n,dtype,batched",
    [
        (1, jnp.float32, False),
        (3, jnp.float64, False),
        (kernels.UNROLL_LIMIT, jnp.float32, False),
        (kernels.UNROLL_LIMIT + 1, jnp.float32, True),
        (12, jnp.float64, True),
        (53, jnp.float32, True),
        (59, jnp.float32, True),
        (65, jnp.float64, True),
    ],
)
def test_factorization_choice_depends_only_on_size(n, dtype, batched):
    """n ≤ ``UNROLL_LIMIT`` takes the unrolled scalar Cholesky (no
    ``cholesky`` primitive), larger n the batched ``jnp.linalg.cholesky``;
    the dtype changes nothing and no Pallas call is ever traced."""
    cov = jnp.zeros((3, n, n), dtype)
    for fn in (kernels.cholesky_banked, kernels.sigma_deltas_banked):
        prims = primitives(jax.make_jaxpr(fn)(cov).jaxpr)
        assert ("cholesky" in prims) == batched
        assert "pallas_call" not in prims


def test_cpu_dispatch_never_reaches_kernel_or_interpreter(monkeypatch):
    """On the CPU a whole f32 PoseUKF bank step takes the plain path: with
    every Pallas call made to fail, the banked deltas and a bank predict +
    update still run (so no interpret-mode fallback can be reached)."""
    from jax.experimental import pallas as pl

    from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn
    from slam_uwv_kalman_filters_tpu.parallel import bank as bankmod
    from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

    def forbidden(*a, **k):
        raise AssertionError("a Pallas kernel was reached on the CPU")

    monkeypatch.setattr(pl, "pallas_call", forbidden)
    jax.clear_caches()
    try:
        covs = raw_unit_covs(3, 53, seed=2)
        got = f32_deltas(covs)
        scale = np.sqrt(np.diagonal(covs, axis1=1, axis2=2))[:, None, :]
        np.testing.assert_array_less(np.abs(got - f64_deltas(covs)) / scale, 1e-4)
        f32 = jnp.float32
        state, params = pukf.init_from_pose(
            jnp.zeros(3, f32), jnp.eye(3, dtype=f32) * 0.01, jnp.array([1.0, 0, 0, 0], f32),
            jnp.eye(3, dtype=f32) * 1e-4, default_pose_ukf_config(),
            dyn.default_uwv_parameters(dtype=f32), dtype=f32,
        )

        def step(bs):
            bs = pukf.predict_bank(bs, params, 0.01)
            z = jnp.broadcast_to(jnp.array([0.3, 0.0, 0.0], f32), (2, 3))
            return pukf.update_velocity_bank(bs, params, z, jnp.eye(3, dtype=f32) * 1e-3)[0]

        out = jax.jit(step)(bankmod.replicate(state, 2))
        assert bool(jnp.isfinite(out.cov).all())
    finally:
        monkeypatch.undo()
        jax.clear_caches()


def test_sigma_deltas_lower_for_cuda_to_xla_library_calls():
    """For a CUDA target the deltas lower to XLA's own ops plus one batched
    cuSOLVER ``potrf`` that declares its bank axis partitionable — so a
    sharded bank splits across cards under plain ``jit`` — and to no
    hand-written kernel."""
    x = jax.ShapeDtypeStruct((256, 53, 53), jnp.float32)
    text = jax.jit(kernels.sigma_deltas_banked).trace(x).lower(lowering_platforms=("cuda",)).as_text()
    calls = [line for line in text.splitlines() if "stablehlo.custom_call" in line]
    assert len(calls) == 1 and "@cusolver_potrf_ffi" in calls[0], calls
    assert 'num_batch_dims = "1"' in calls[0]
    assert "triton" not in text and "mosaic" not in text
