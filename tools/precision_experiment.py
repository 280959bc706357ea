"""Extended-precision experiment: double-single (compensated) arithmetic on
the covariance reconstruct — SURVEY.md §7 hard-part 1, VERDICT r3 item 7.

The deployment path is f32. This experiment measures whether double-single
(Dekker TwoProd + Neumaier TwoSum, all in f32 ops — the classic
error-free-transformation construction) applied to the unscented covariance
reconstruct ½ΣDDᵀ would narrow the f32↔f64 gap, WITHOUT guessing:

1. **isolated reconstruct error**: with identical f32 sigma deviations D,
   compute ½ΣDDᵀ (a) in plain f32, (b) in double-single f32, and (c) in f64
   (ground truth). Error(a) vs error(b) is exactly the precision
   double-single buys on this phase.
2. **relevance**: compare that reconstruct error to the TOTAL single-step
   f32↔f64 covariance gap (process model + manifold mean + Cholesky + the
   reconstruct). If the reconstruct contributes a small fraction, no
   reconstruct-precision scheme can close the gap.

Run:  python tools/precision_experiment.py   (the f64 half runs on the CPU)
Results are recorded in docs/TUNING.md ("Extended precision").
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from slam_uwv_kalman_filters_tpu.utils.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()


# ---------------------------------------------------------------------------
# Error-free transformations in f32 (no FMA assumed — Dekker splitting).
# ---------------------------------------------------------------------------

_SPLIT = 4097.0  # 2^12 + 1 for f32 (24-bit significand)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a):
    c = a * _SPLIT
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def ds_outer_accumulate(D):
    """½ΣᵢDᵢDᵢᵀ over the sigma axis in double-single f32: the running sum is
    kept as (hi, compensation) with TwoProd product errors folded into the
    compensation stream. D: (..., nsig, n)."""
    nsig = D.shape[-2]
    s = jnp.zeros((*D.shape[:-2], D.shape[-1], D.shape[-1]), D.dtype)
    c = jnp.zeros_like(s)

    def body(i, carry):
        s, c = carry
        d = jax.lax.dynamic_index_in_dim(D, i, axis=-2, keepdims=False)
        p, pe = _two_prod(d[..., :, None], d[..., None, :])
        s, se = _two_sum(s, p)
        return s, c + (se + pe)

    s, c = jax.lax.fori_loop(0, nsig, body, (s, c))
    return 0.5 * (s + c)


def plain_outer_accumulate(D):
    """½ΣᵢDᵢDᵢᵀ in plain f32 (elementwise FMA chain over the sigma axis)."""
    nsig = D.shape[-2]
    s = jnp.zeros((*D.shape[:-2], D.shape[-1], D.shape[-1]), D.dtype)

    def body(i, s):
        d = jax.lax.dynamic_index_in_dim(D, i, axis=-2, keepdims=False)
        return s + d[..., :, None] * d[..., None, :]

    return 0.5 * jax.lax.fori_loop(0, nsig, body, s)


def main():
    backend = jax.default_backend()
    print(f"backend={backend}")
    from slam_uwv_kalman_filters_tpu.models import pose_ukf as pukf
    from slam_uwv_kalman_filters_tpu.ops import dynamics as dyn, ukf as ukfops
    from slam_uwv_kalman_filters_tpu.utils.config import default_pose_ukf_config

    # ---- realistic f32 deviations: one predict on the mission filter ------
    cfg = default_pose_ukf_config()
    state32, params32 = pukf.init_from_pose(
        imu_in_nwu_pos=jnp.zeros(3, jnp.float32),
        imu_in_nwu_pos_cov=jnp.eye(3, dtype=jnp.float32) * 0.01,
        imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0], jnp.float32),
        imu_in_nwu_rot_cov=jnp.eye(3, dtype=jnp.float32) * 1e-4,
        config=cfg,
        model_parameters=dyn.default_uwv_parameters(dtype=jnp.float32),
        imu_delta_t=0.01,
        dtype=jnp.float32,
    )
    state32 = pukf.integrate_rotation_rate(state32, jnp.array([0.0, 0.0, 0.01], jnp.float32))

    deltas = ukfops.sigma_point_deltas(state32.cov)  # (107, 53) f32
    X = jax.vmap(lambda d: pukf.POSE_MANIFOLD.boxplus(state32.mu, d))(deltas)
    Y = jax.vmap(lambda chi: pukf._process_model(chi, state32.rotation_rate, params32, 0.01))(X)
    mu_y = pukf.POSE_MANIFOLD.mean(Y, max_iters=64, tol=1e-6)
    D32 = jax.vmap(lambda y: pukf.POSE_MANIFOLD.boxminus(y, mu_y))(Y).astype(jnp.float32)
    D32 = np.asarray(jax.device_get(D32))  # (107, 53) — the SHARED input

    # ---- 1. isolated reconstruct error (f64 on host as ground truth) ------
    ref = 0.5 * (D32.astype(np.float64).T @ D32.astype(np.float64))
    plain = np.asarray(jax.device_get(plain_outer_accumulate(jnp.asarray(D32))))
    ds = np.asarray(jax.device_get(ds_outer_accumulate(jnp.asarray(D32))))
    scale = np.abs(ref).max()
    err_plain = np.abs(plain - ref).max()
    err_ds = np.abs(ds - ref).max()
    print(f"reconstruct |err| vs f64 (abs, cov scale {scale:.3e}):")
    print(f"  plain f32:       {err_plain:.3e}  ({err_plain/scale:.2e} rel)")
    print(f"  double-single:   {err_ds:.3e}  ({err_ds/scale:.2e} rel, "
          f"{err_plain/max(err_ds, 1e-30):.0f}x smaller)")

    # ---- 2. relevance: total single-step f32 vs f64 covariance gap --------
    # (f64 runs on the CPU)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        jax.config.update("jax_enable_x64", True)
        state64, params64 = pukf.init_from_pose(
            imu_in_nwu_pos=jnp.zeros(3, jnp.float64),
            imu_in_nwu_pos_cov=jnp.eye(3, dtype=jnp.float64) * 0.01,
            imu_in_nwu_rot=jnp.array([1.0, 0, 0, 0], jnp.float64),
            imu_in_nwu_rot_cov=jnp.eye(3, dtype=jnp.float64) * 1e-4,
            config=cfg,
            model_parameters=dyn.default_uwv_parameters(dtype=jnp.float64),
            imu_delta_t=0.01,
            dtype=jnp.float64,
        )
        state64 = pukf.integrate_rotation_rate(state64, jnp.array([0.0, 0.0, 0.01], jnp.float64))
        cov64 = np.asarray(jax.device_get(pukf.predict(state64, params64, 0.01).cov))
        with jax.default_device(cpu):
            cov32_step = np.asarray(
                jax.device_get(pukf.predict(state32, params32, 0.01).cov)
            )
    total_gap = np.abs(cov32_step.astype(np.float64) - cov64).max()
    print(f"total single-step f32 vs f64 covariance gap: {total_gap:.3e} "
          f"(reconstruct share: plain {err_plain/total_gap:.1%}, "
          f"double-single would leave {err_ds/total_gap:.2%})")


if __name__ == "__main__":
    main()
