"""Several solver programs in one process (port of gato_tpu/parallel/):
the mixed-plant fleet. The batch sharding over devices is not ported yet
(ROADMAP Queue 1)."""
