"""feed_wait_share.featurize: the share of the DeviceFeed's wall time in
which its engine waited for an assembled chunk (`stall_decode_s` over
`wall_s`, the feed's own host waits over the window)."""
NAME = "feed_wait_share.featurize"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host to device"
MOVES = "images_per_s"


def read(view):
    feed = view.counters.get("feed", {})
    if not feed.get("wall_s"):
        return None
    return 100.0 * feed.get("stall_decode_s", 0.0) / feed["wall_s"]
