"""Several solves in one process, and one batch split over processes
(port of gato_tpu/parallel/): the mixed-plant fleet (fleet.py), the batch
sharded over ranks with torch.distributed (sharding.py) and its weak-scaling
benchmark (scaling_bench.py)."""
