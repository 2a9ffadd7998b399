"""The port's user-facing API: the BSQP facade, the MPC controller and their
task utilities (gato_tpu/api's counterpart)."""

from . import config  # noqa: F401
from .common import figure8, initialize_warm_start, rk4_step  # noqa: F401
from .experiment_runner import ExperimentRunner, run_standard_benchmark  # noqa: F401
from .force_estimator import ForceEstimator  # noqa: F401
from .interface import BSQP  # noqa: F401
from .mpc import MPC_GATO, add_pendulum  # noqa: F401
from .rollout import (closed_loop_rollout, closed_loop_rollout_estimator,  # noqa: F401
                      closed_loop_rollout_goals)
