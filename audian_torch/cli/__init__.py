"""Command-line tools of the port: ``audian`` (:mod:`.audian`),
``audian-songdetector`` (:mod:`.songdetector`) and ``audian-compress``
(:mod:`.compress`)."""
