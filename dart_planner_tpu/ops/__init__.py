"""Numerical operators: SO(3)/SE(3) math, quadrotor dynamics, MPC costs,
and the fused Pallas kernels (Triton route) for the hot paths."""
