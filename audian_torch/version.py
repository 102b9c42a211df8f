"""Version and user cache directory of audian_torch.

The counterpart of ``audian_tpu/version.py``.  The cache holds the
overview (fulltrace) artifacts and their index
(:mod:`audian_torch.cache.fulltrace`) under the port's own application
name, so the two packages never share an index file.  ``platformdirs``
is used when it is installed; without it the cache is
``$XDG_CACHE_HOME/audian-torch``, or ``~/.cache/audian-torch``.
"""

import os
from pathlib import Path

from . import __version__

__year__ = "2026"

APPNAME = "audian-torch"


class _CacheDirs:
    """The ``user_cache_path`` of ``platformdirs.PlatformDirs`` for the
    port's application name, resolved when it is read."""

    @property
    def user_cache_path(self):
        try:
            import platformdirs
        except ImportError:
            base = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
            return Path(base) / APPNAME
        return platformdirs.PlatformDirs(
            appname=APPNAME, appauthor="audian", version=None
        ).user_cache_path


#: platform directories of the port (only the user cache is used)
audian_dirs = _CacheDirs()

__all__ = ["APPNAME", "__version__", "__year__", "audian_dirs"]
