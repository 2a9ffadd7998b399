"""Timing, profiling, CSV trajectory IO, debug invariants and plots (port
of gato_tpu/utils/)."""
