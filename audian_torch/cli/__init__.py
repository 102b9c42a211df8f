"""Command-line tools of the port: ``audian-songdetector``
(:mod:`.songdetector`)."""
