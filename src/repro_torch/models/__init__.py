"""The LM stack that serves from and trains on the feature store (dense decoder-only subset)."""
