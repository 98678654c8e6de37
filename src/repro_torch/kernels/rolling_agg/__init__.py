"""Rolling-window aggregation for the DSL."""
