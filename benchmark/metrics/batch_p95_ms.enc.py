"""The 95th percentile of every encode_batch call's wall in the traced
window (nearest rank over all calls, not a median of chunks), ms."""
import math


def read(t):
    walls = sorted(t.walls)
    return 1e3 * walls[math.ceil(0.95 * len(walls)) - 1] if walls else None
