"""Point-in-time (as-of) search over segmented, time-sorted history."""
