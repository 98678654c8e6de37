"""Source systems."""
