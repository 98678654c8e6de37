"""fslint for the port — ``python -m repro_torch.analysis``.

The port's copy of the JAX package's invariant checker (``repro.analysis``):
a stdlib-only static-analysis framework whose rules are this codebase's own
recurring bug classes, promoted into enforced invariants, here run over the
port's tree: publisher-buffer aliasing (PR 5), substring gauge-key matching
(PR 9), vacuous gates (PR 8), wall-clock/unseeded RNG on the
byte-replayable chaos surface (PR 7's determinism contract), wire-format
endianness/dispatch discipline, bare-dict stats returns (PR 9's typed-stats
refactor), a tokenize-based format probe, and ``device-pointer``, the
port's counterpart of the use-after-donate rule: a raw device address for a
kernel launch is taken of a named tensor, never of a temporary.

It imports neither torch nor jax, nor anything of the JAX package.  See
README.md in this directory for the rule catalog, suppression syntax, and
how to add a rule.
"""

from .engine import (  # noqa: F401
    FileContext,
    Finding,
    ProjectContext,
    RunResult,
    run,
)
from .registry import RULES, Rule, rule  # noqa: F401
