"""Feature-store core: stores, materialization, DSL, serving."""
