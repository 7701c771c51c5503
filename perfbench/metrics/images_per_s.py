"""images_per_s: the rows of every completed call over the whole window
(host clock, closed loop, the window from its start to the end of its
last call)."""
NAME = "images_per_s"
UNIT = "images/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(view):
    if not view.calls or view.window_s <= 0:
        return None
    return sum(c.rec["rows"] for c in view.calls) / view.window_s
