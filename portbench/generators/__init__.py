"""The generators of the traffic kinds, one file each, named by the
``generator`` key of a traffic file (``traffic/<traffic>.json``); each has
``run(r)``."""
