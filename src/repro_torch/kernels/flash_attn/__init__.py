"""Causal GQA flash attention (forward) for the LM's full-sequence path."""
