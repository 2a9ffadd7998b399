"""Derivative-free 6D external-wrench estimator over the hypothesis batch.

A numpy copy of gato_tpu/api/force_estimator.py (which cannot be imported
without jax); the same seed gives the same hypothesis batches. Re-design
of the reference's examples/force_estimator.py: lane 0 = smoothed estimate,
lane 1 = zero, lane 2 = estimate + momentum, lanes 3.. = Fibonacci-sphere
exploration points at an adaptive radius under a per-update random rotation.
The update blends the winning lane with momentum and adapts the radius from
win statistics and error history.
"""

from __future__ import annotations

import numpy as np


class ForceEstimator:
    def __init__(self, batch_size, initial_radius=10.0, min_radius=1.0,
                 max_radius=100.0, smoothing_factor=0.3, seed=None):
        if batch_size <= 3:
            raise ValueError("batch size must exceed the 3 exploitation lanes")
        self.batch_size = batch_size
        self.dim = 6
        self.radius = float(initial_radius)
        self.min_radius = float(min_radius)
        self.max_radius = float(max_radius)
        self.radius_increase_factor = 1.05
        self.radius_decrease_factor = 0.95
        self.smoothing_factor = float(smoothing_factor)

        self.estimate = np.zeros(6, np.float32)
        self.momentum = np.zeros(6, np.float32)
        self.smoothed_estimate = np.zeros(6, np.float32)
        self.confidence = 0.0
        self.error_history: list[float] = []
        self._rng = np.random.default_rng(seed)
        self.sphere_dirs = self._fibonacci_sphere(batch_size - 3)
        self.current_rotation = np.eye(3, dtype=np.float32)

    @staticmethod
    def _fibonacci_sphere(n):
        if n == 0:
            return np.zeros((0, 3), np.float32)
        pts = np.zeros((n, 3), np.float32)
        golden = (1 + np.sqrt(5)) / 2
        for i in range(n):
            y = 1 - 2 * i / (n - 1) if n > 1 else 0.0
            r = np.sqrt(max(0.0, 1 - y * y))
            th = 2 * np.pi * i / golden
            pts[i] = [r * np.cos(th), y, r * np.sin(th)]
        return pts

    def _random_rotation(self):
        u1, u2, u3 = self._rng.random(3)
        a, b = np.sqrt(1 - u1), np.sqrt(u1)
        x, y = a * np.sin(2 * np.pi * u2), a * np.cos(2 * np.pi * u2)
        z, w = b * np.sin(2 * np.pi * u3), b * np.cos(2 * np.pi * u3)
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ],
            dtype=np.float32,
        )

    def generate_batch(self):
        batch = np.zeros((self.batch_size, 6), np.float32)
        batch[0] = self.smoothed_estimate
        batch[1] = 0.0
        batch[2] = self.smoothed_estimate + 0.5 * self.momentum
        base = 0.7 * self.smoothed_estimate[:3] + 0.3 * self.estimate[:3]
        for i in range(3, self.batch_size):
            d = self.current_rotation @ self.sphere_dirs[i - 3]
            batch[i, :3] = base + self.radius * d
            batch[i, 3:] = self.smoothed_estimate[3:]
        return batch

    def update(self, best_idx, prediction_errors, alpha=0.5, beta=0.8):
        self.error_history.append(float(np.min(prediction_errors)))
        best_force = self.generate_batch()[best_idx]

        delta = best_force - self.estimate
        self.momentum = beta * self.momentum + (1 - beta) * delta
        raw = alpha * best_force + (1 - alpha) * self.estimate
        self.estimate = 0.8 * self.estimate + 0.2 * (raw + 0.5 * self.momentum)
        self.smoothed_estimate = (
            (1 - self.smoothing_factor) * self.smoothed_estimate
            + self.smoothing_factor * self.estimate
        )

        if best_idx < 3:
            self.radius *= self.radius_decrease_factor
            self.confidence = min(1.0, self.confidence + 0.05)
        else:
            self.radius *= self.radius_increase_factor
            self.confidence = max(0.0, self.confidence - 0.1)
        self.radius = float(np.clip(self.radius, self.min_radius, self.max_radius))

        if len(self.error_history) > 5:
            recent = self.error_history[-5:]
            if np.std(recent) < 0.01:
                self.radius *= 0.9
            elif recent[-1] > 1.5 * np.mean(recent[:-1]):
                self.radius *= 1.3
                self.confidence *= 0.5
            self.radius = float(np.clip(self.radius, self.min_radius, self.max_radius))

        self.current_rotation = self._random_rotation()

    def reset(self):
        self.estimate[:] = 0
        self.momentum[:] = 0
        self.smoothed_estimate[:] = 0
        self.radius = 10.0
        self.confidence = 0.0
        self.error_history = []
        self.current_rotation = np.eye(3, dtype=np.float32)

    def get_stats(self):
        return {
            "current_estimate": self.estimate.copy(),
            "smoothed_estimate": self.smoothed_estimate.copy(),
            "momentum": self.momentum.copy(),
            "radius": self.radius,
            "confidence": self.confidence,
            "recent_error": self.error_history[-1] if self.error_history else np.inf,
        }
