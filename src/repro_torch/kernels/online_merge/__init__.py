"""Online-store write path: the resident Algorithm-2 merge."""
