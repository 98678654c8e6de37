"""Serving and training drivers and the step functions they run."""
