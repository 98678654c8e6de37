"""Online-store GET: host routing helpers and the lookup kernel."""
