"""Constant-velocity Kalman filter over a 3-D position.

Counterpart of `sqrtlm_slam_tpu/utils/kalman.py` (the reference declares a
6-state filter, KalmanFilter.h): state [pos(3), vel(3)], a position
measurement, white-acceleration process noise. Pure functions of tensors;
the state keeps the dtype and device of the first position.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class KFState(NamedTuple):
    x: torch.Tensor  # (6,) [pos(3), vel(3)]
    P: torch.Tensor  # (6, 6) covariance


def init(pos: torch.Tensor, pos_var: float = 1.0, vel_var: float = 1.0) -> KFState:
    x = torch.cat([pos, torch.zeros(3, dtype=pos.dtype, device=pos.device)])
    P = torch.diag(torch.tensor([pos_var] * 3 + [vel_var] * 3, dtype=pos.dtype,
                                device=pos.device))
    return KFState(x=x, P=P)


def predict(s: KFState, dt: float, accel_var: float = 1.0) -> KFState:
    eye = torch.eye(3, dtype=s.x.dtype, device=s.x.device)
    F = torch.eye(6, dtype=s.x.dtype, device=s.x.device)
    F[:3, 3:] = dt * eye
    # Discrete white-acceleration process noise.
    q11, q12, q22 = 0.25 * dt**4, 0.5 * dt**3, dt**2
    Q = torch.cat([torch.cat([q11 * eye, q12 * eye], 1),
                   torch.cat([q12 * eye, q22 * eye], 1)], 0) * accel_var
    return KFState(x=F @ s.x, P=F @ s.P @ F.T + Q)


def update(s: KFState, z: torch.Tensor, meas_var: float = 0.01) -> KFState:
    """Position measurement z (3,)."""
    H = torch.zeros(3, 6, dtype=s.x.dtype, device=s.x.device)
    H[:, :3] = torch.eye(3, dtype=s.x.dtype, device=s.x.device)
    S = H @ s.P @ H.T + meas_var * torch.eye(3, dtype=s.x.dtype, device=s.x.device)
    K = s.P @ H.T @ torch.linalg.inv(S)
    x = s.x + K @ (z - H @ s.x)
    P = (torch.eye(6, dtype=s.x.dtype, device=s.x.device) - K @ H) @ s.P
    return KFState(x=x, P=P)


def step(s: KFState, z: torch.Tensor, dt: float, accel_var=1.0, meas_var=0.01) -> KFState:
    return update(predict(s, dt, accel_var), z, meas_var)
