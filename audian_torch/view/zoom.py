"""Zoom history and rectangle selection state (Qt-free).

The state core of the reference's ``SelectViewBox``
(`src/audian/selectviewbox.py:12-131`): a back/forward stack of view
rectangles, plus the rect-drag selection handshake that feeds the region
verbs (zoom/play/analyze/save).  GUI frontends own the mouse handling and
call into this.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Rect", "ZoomHistory", "SelectionModel"]


@dataclasses.dataclass(frozen=True)
class Rect:
    """View rectangle in data coordinates."""

    x0: float
    y0: float
    x1: float
    y1: float

    def left(self):
        return min(self.x0, self.x1)

    def right(self):
        return max(self.x0, self.x1)

    def bottom(self):
        return min(self.y0, self.y1)

    def top(self):
        return max(self.y0, self.y1)

    def normalized(self):
        return Rect(self.left(), self.bottom(), self.right(), self.top())


class ZoomHistory:
    """Back/forward stack of view rects
    (`selectviewbox.py:107-131` semantics: adding truncates the forward
    branch; back/forward move the pointer and return the rect)."""

    def __init__(self):
        self.history = []
        self.pointer = -1

    def init(self, rect):
        self.history = []
        self.pointer = -1
        self.add(rect)

    def add(self, rect):
        self.pointer += 1
        self.history = self.history[: self.pointer] + [rect]

    def current(self):
        if 0 <= self.pointer < len(self.history):
            return self.history[self.pointer]
        return None

    def back(self, n=1):
        """Move back; None when empty OR already at the oldest entry
        (pyqtgraph's scaleHistory no-ops at the boundary — returning the
        same rect would make every extra keypress re-apply it)."""
        if not self.history:
            return None  # clamping -1 to 0 would desync the pointer
        new = max(self.pointer - n, 0)
        if new == self.pointer:
            return None
        self.pointer = new
        return self.current()

    def forward(self, n=1):
        if not self.history:
            return None
        new = min(self.pointer + n, len(self.history) - 1)
        if new == self.pointer:
            return None
        self.pointer = new
        return self.current()

    def home(self):
        return self.back(len(self.history))


class SelectionModel:
    """Rect-drag selection emitting to a callback
    (``sigSelectedRegion(channel, view, rect)``,
    `selectviewbox.py:46-52`)."""

    def __init__(self, channel, view=None, on_selected=None):
        self.channel = channel
        self.view = view
        self.on_selected = on_selected
        self.active = False
        self.anchor = None
        self.rect = None

    def begin(self, x, y):
        self.active = True
        self.anchor = (x, y)
        self.rect = Rect(x, y, x, y)

    def drag(self, x, y):
        if self.active:
            self.rect = Rect(self.anchor[0], self.anchor[1], x, y)
        return self.rect

    def finish(self, x, y):
        if not self.active:
            return None
        rect = Rect(self.anchor[0], self.anchor[1], x, y).normalized()
        self.active = False
        self.rect = rect
        if self.on_selected is not None:
            self.on_selected(self.channel, self.view, rect)
        return rect

    def cancel(self):
        self.active = False
        self.rect = None
