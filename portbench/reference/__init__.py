"""The plain references of the configurations, one file each, named as the
configuration (``<config>.py``), with their shared float64 helpers in
:mod:`.dsp`."""
