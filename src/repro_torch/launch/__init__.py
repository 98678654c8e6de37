"""Serving drivers and the step functions they run."""
