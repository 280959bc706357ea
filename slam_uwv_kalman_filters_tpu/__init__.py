"""slam_uwv_kalman_filters_tpu — underwater state estimation as banked JAX programs.

A brand-new JAX/XLA/Pallas/pjit framework with the capabilities of the C++
``uwv_kalman_filters`` library (reference at ``/root/reference``): manifold
unscented Kalman filters for AUVs — PoseUKF, VelocityUKF, BottomUKF,
IndirectPoseUKF — rebuilt as pure functions over pytrees and scaled as vmapped
filter banks sharded over a device mesh.

Layout (SURVEY.md §7):
  ops/       manifold algebra, UKF core, vehicle dynamics, geodesy, kernels
  models/    the four concrete filters (state, process/measurement models, API)
  parallel/  filter-bank vmap layer, mesh sharding, checkpointing
  utils/     config schema, validation, metrics, delayed-state buffer
"""

__version__ = "0.1.0"
