"""Optimizer and learning-rate schedules of the train path."""
