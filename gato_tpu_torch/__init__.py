"""gato_tpu_torch: the PyTorch + CUDA port of gato_tpu for one NVIDIA H100.

The JAX package `gato_tpu` is the reference this port is tested against;
this package imports torch and numpy and never jax.
"""

from .robots.model import RobotModel, load_robot

__all__ = ["RobotModel", "load_robot"]
