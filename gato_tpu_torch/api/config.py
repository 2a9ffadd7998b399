"""Solver presets and start configurations.

A numpy copy of the constants in gato_tpu/api/config.py (which cannot be
imported without jax): the reference's python/bsqp/config.py knobs.
"""

import numpy as np

STANDARD_BATCH_SIZES = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024]
EXPERIMENT_BATCH_SIZES = [1, 4, 8, 16, 32, 64, 128]

FIG8_DEFAULT_PARAMS = {
    "A_x": 0.4,
    "A_z": 0.4,
    "offset": [0.0, 0.5, 0.6],
    "period": 6,
    "cycles": 5,
    "theta": np.pi / 4,
}

INDY7_START_CONFIGS = {
    "zero": np.zeros(6),
    "home": np.zeros(6),
    "ready": np.array(
        [-1.096711, -0.09903229, 0.83125766, -0.10907673, 0.49704404, 0.01499449]
    ),
}

IIWA14_START_CONFIGS = {
    "zero": np.zeros(7),
    "home": np.zeros(7),
    # elbow-bent, EE at (0.556, 0, 0.335): the benchmark/demo start. The
    # vertical zero pose is singular (gravity torques vanish, the task
    # Jacobian loses rank) — warm-started solves there leave several lanes'
    # PCG legitimately divergent, so it measures NaN-scrubbed degenerate
    # work instead of real MPC steps.
    "bent": np.array([0.0, 0.7, 0.0, -1.6, 0.0, 1.0, 0.0]),
}

# config.py:35-50
DEFAULT_SOLVER_PARAMS = {
    "max_sqp_iters": 1,
    "kkt_tol": 0.001,
    "max_pcg_iters": 200,
    "pcg_tol": 1e-4,
    "solve_ratio": 1.0,
    "mu": 10.0,
    "q_cost": 2.0,
    "qd_cost": 1e-2,
    "u_cost": 2e-6,
    "N_cost": 50.0,
    "q_lim_cost": 0.01,
    "vel_lim_cost": 0.0,
    "ctrl_lim_cost": 0.0,
    "rho": 0.01,
}

PENDULUM_DEFAULT_PARAMS = {
    "mass": 15.0,
    "length": 0.3,
    "damping": 0.4,
    "initial_angle": np.array([0.3, 0.0, 0.0]),
}

# config.py:52-94: the pick-and-place presets (examples/pickplace.py)
PICKPLACE_SOLVER_PARAMS = {
    "max_sqp_iters": 5,
    "kkt_tol": 0.0,
    "max_pcg_iters": 100,
    "pcg_tol": 1e-6,
    "solve_ratio": 1.0,
    "mu": 10.0,
    "q_cost": 5.0,
    "qd_cost": 1e-2,
    "u_cost": 5e-7,
    "N_cost": 50.0,
    "q_lim_cost": 0.0,
    "vel_lim_cost": 0.0,
    "ctrl_lim_cost": 0.0,
    "rho": 0.001,
}

PICKPLACE_MPC_DEFAULTS = {
    "goal_timeout": 5.0,
    "goal_threshold": 0.05,
    "velocity_threshold": 1.0,
}

PICKPLACE_DEFAULT_GOALS = [
    np.array([0.5, -0.1865, 0.5]),
    np.array([0.5, 0.5, 0.2]),
    np.array([0.3, 0.3, 0.8]),
    np.array([0.6, -0.5, 0.2]),
    np.array([0.0, -0.5, 0.8]),
]
