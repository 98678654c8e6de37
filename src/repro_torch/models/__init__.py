"""The LM stack that serves from the feature store (dense decoder-only subset)."""
