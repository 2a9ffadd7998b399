"""Minimal standalone batched BSQP solve: examples/bsqp_example.py on the
port (the reference's examples/bsqp.cu analogue).

B=16, N=16, indy7, one solve of 5 SQP iterations through the BSQP facade
from a fixed initial state toward a goal 10 cm, -5 cm, 5 cm from its EE;
prints the first trajectory entries and the solve's statistics. On the
card the solve runs the whole-iteration kernel (bsqp_iter), one launch an
SQP iteration.

    python -m gato_tpu_torch.examples.bsqp_example [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..api.interface import BSQP

B, N = 16, 16
Q0 = np.array([-1.0967, -0.099, 0.8313, -0.1091, 0.497, 0.015])


def make_solver(device="cuda"):
    """The example's facade: the JAX example's settings, on `device`."""
    return BSQP(plant_type="indy7", batch_size=B, N=N, dt=0.01,
                max_sqp_iters=5, max_pcg_iters=100, pcg_tol=1e-5,
                q_cost=2.0, qd_cost=1e-2, u_cost=2e-6, N_cost=50.0,
                q_lim_cost=0.01, rho=0.01, device=device)


def inputs(solver):
    """(xcur, ref, XU) numpy, float32: the state at rest at Q0 tiled over the
    batch, the goal's reference over every knot, the warm start holding
    that state with zero controls."""
    x0 = np.concatenate([Q0, np.zeros(6)]).astype(np.float32)
    ee0 = solver.ee_pos(Q0.astype(np.float32))
    goal = ee0 + np.array([0.1, -0.05, 0.05])
    ref = np.tile(np.concatenate([goal, np.zeros(3)]), (B, N)).astype(np.float32)
    XU = np.tile(
        np.concatenate([np.tile(np.concatenate([x0, np.zeros(6, np.float32)]),
                                N - 1), x0]), (B, 1))
    xcur = np.tile(x0, (B, 1))
    return xcur, ref, XU


def main(device="cuda"):
    """One solve; prints what the JAX example prints and returns it:
    dict(solve_time_us, first_knot_state, first_control, sqp_iters, steps,
    initial_merit, final_merit), and XU, the solved flat trajectories."""
    solver = make_solver(device)
    xcur, ref, XU = inputs(solver)

    XU_out, t_us = solver.solve(xcur, ref, XU)
    print(f"solve time: {t_us} us")
    print("first knot state:", XU_out[0, :12])
    print("first control   :", XU_out[0, 12:18])
    stats = solver.get_stats()
    steps = stats["step_size"][:, 0] if stats["step_size"].size else []
    print("sqp iters:", stats["sqp_iters"][:4], "steps:", steps)
    print("initial merit:", stats["initial_merit"][0],
          "final merit:", stats["final_merit"][0])
    return dict(solve_time_us=t_us, first_knot_state=XU_out[0, :12],
                first_control=XU_out[0, 12:18], sqp_iters=stats["sqp_iters"][:4],
                steps=steps, initial_merit=stats["initial_merit"][0],
                final_merit=stats["final_merit"][0], XU=XU_out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default), or cpu: the plain PyTorch route")
    main(ap.parse_args().device)
