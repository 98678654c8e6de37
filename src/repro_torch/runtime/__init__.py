"""Job supervision around the materializer."""
