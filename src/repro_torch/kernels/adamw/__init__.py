"""AdamW's fused update and the global norm's sum of squares."""
