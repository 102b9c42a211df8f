"""Channel visibility and selection as a value object.

The reference keeps its channel state machine inline in the controller
(`src/audian/databrowser.py:1317-1512`): a window of *shown* channels, a
subset of *selected* ones, and one *current* (focused) channel, with
keyboard verbs that walk and scroll the window.  Here that state machine
is factored into :class:`ChannelFocus`, a plain value object with pure
methods, so the controller verbs become one-liners and the invariants
are testable without a browser.

Invariants (established by :meth:`normalize`):

- shown is never empty (falls back to channel 0);
- every selected channel that matters is shown — if the intersection is
  empty, the selection resets to all shown channels;
- the current channel is always in that intersection (moved to the next
  member at or after it, else the last member).
"""

from __future__ import annotations

from numbers import Integral

__all__ = ["ChannelFocus"]


def _merge(channels, extra):
    """Sorted union of a channel list with extra channels."""
    return sorted(set(channels) | set(extra))


class ChannelFocus:
    """Shown/selected/current channel state over ``total`` channels."""

    def __init__(self, total, shown, selected, current):
        self.total = total
        self.shown = list(shown)
        self.selected = list(selected)
        self.current = current

    # -- building blocks -----------------------------------------------------------

    def _in_range(self, channel):
        return 0 <= channel < self.total

    def show(self, channels):
        """Add channels to the shown window, keeping it sorted."""
        if isinstance(channels, Integral):
            channels = [int(channels)]
        self.shown = _merge(self.shown, channels)

    def select(self, channels):
        """Add channels to the selection, keeping it sorted."""
        if isinstance(channels, Integral):
            channels = [int(channels)]
        self.selected = _merge(self.selected, channels)

    def shown_selection(self):
        """The shown ∩ selected channels in ascending order."""
        return sorted(set(self.shown) & set(self.selected))

    def _scroll(self, direction, partial):
        """Slide the shown window one page towards ``direction``.

        ``partial`` pages by one less than the window size (keeping one
        channel of overlap) when the window shows more than one channel.
        Returns how many channels actually entered.
        """
        count = len(self.shown)
        if partial and count > 1:
            count -= 1
        if direction > 0:
            edge = self.shown[-1]
            count = min(count, self.total - 1 - edge)
            if count <= 0:
                return 0
            fresh = range(edge + 1, edge + 1 + count)
            self.shown = _merge(self.shown, fresh)[count:]
        else:
            edge = self.shown[0]
            count = min(count, edge)
            if count <= 0:
                return 0
            fresh = range(edge - count, edge)
            self.shown = _merge(self.shown, fresh)[:-count]
        return count

    # -- focus movement -------------------------------------------------------------

    def step(self, direction):
        """Move the focus one shown channel over, scrolling the window at
        its edge; the selection collapses onto the focus.  Returns True
        when the caller must re-normalize (the reference re-dispatches
        `set_channels` exactly on the edge branch)."""
        pos = self.shown.index(self.current)
        inside = 0 <= pos + direction < len(self.shown)
        if inside:
            self.current = self.shown[pos + direction]
            self.selected = [self.current]
            return False
        if self._scroll(direction, partial=True):
            self.current += direction
        self.selected = [self.current]
        return True

    def extend(self, direction):
        """Grow the selection one channel in ``direction`` from its
        extreme shown member, scrolling the window at its edge.  Returns
        True when the caller must re-normalize."""
        anchor = self.shown_selection()
        if anchor:
            self.current = anchor[-1] if direction > 0 else anchor[0]
        pos = self.shown.index(self.current)
        if 0 <= pos + direction < len(self.shown):
            self.current = self.shown[pos + direction]
            self.select(self.current)
            return False
        self._scroll(direction, partial=False)
        if self._in_range(self.current + direction):
            self.current += direction
            self.select(self.current)
        return True

    # -- selection verbs --------------------------------------------------------------

    def select_all(self):
        """Two-stage select-all: the shown channels first, everything on
        the second press."""
        if self.selected == self.shown:
            self.selected = list(range(self.total))
        else:
            self.selected = list(self.shown)

    def keep_selection(self, channels):
        """Restrict the selection to the given channels, ignoring ones
        not shown; no-op when nothing remains."""
        picked = [c for c in channels if c in self.shown]
        if picked:
            self.selected = sorted(picked)

    # -- visibility verbs --------------------------------------------------------------

    def reveal(self, channel):
        self.show(channel)
        self.select(channel)

    def conceal(self, channel):
        """Hide a channel.  Hiding the last shown channel falls through
        to its successor (wrapping); a selection emptied by the hide
        re-seeds from the nearest shown channel below."""
        if channel not in self.shown:
            return
        self.shown = [c for c in self.shown if c != channel]
        if not self.shown:
            successor = channel + 1 if channel + 1 < self.total else 0
            self.shown = [successor]
            self.select(successor)
        if channel in self.selected:
            self.selected = [c for c in self.selected if c != channel]
            if not self.selected:
                below = [c for c in self.shown if c < channel]
                if below:
                    self.current = below[-1]
                self.selected = [self.current]

    # -- normalization ------------------------------------------------------------------

    def normalize(self):
        """Re-establish the class invariants (see module docstring)."""
        self.shown = [c for c in self.shown if self._in_range(c)] or [0]
        self.selected = [c for c in self.selected if self._in_range(c)]
        if not self.selected:
            self.selected = list(self.shown)
        focusable = self.shown_selection()
        if not focusable:
            self.selected = list(self.shown)
            focusable = sorted(self.shown)
        if self.current not in focusable:
            ahead = [c for c in focusable if c >= self.current]
            self.current = ahead[0] if ahead else focusable[-1]
