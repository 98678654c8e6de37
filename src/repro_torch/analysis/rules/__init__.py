"""Rule modules.  Importing this package registers every rule.

Each module owns one invariant and opens with the history that made it a
rule — the PR whose bug (or whose design contract) it locks in.  Seven are
the JAX package's rules with the port's scopes; ``device_pointer`` is the
port's counterpart of ``donation``.  Add a new rule by dropping a module
here, decorating its checker with ``@registry.rule(...)``, and importing it
below; ``tests/test_torch_analysis.py`` expects every rule to fire on a
positive fixture (the bug, reproduced) and stay silent on a negative one
(the fix).
"""

from . import (  # noqa: F401
    aliasing,
    determinism,
    device_pointer,
    formatting,
    gates,
    gauges,
    stats,
    wire_format,
)
