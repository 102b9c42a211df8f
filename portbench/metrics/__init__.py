"""The readers of the per-layer metrics, one file each, named as the metric
(``<metric>.py``); each has ``read(ctx)``, which returns the value or
``None`` where the run holds nothing to read."""
