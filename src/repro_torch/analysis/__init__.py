"""Analysis over the port's recorded op graphs: the qlint rule engine
(twin of ``repro.analysis``).

* :mod:`.opgraph` -- the recorder (a ``TorchDispatchMode``) and the
  def-use ``Graph`` it builds, with one node per kernel entry point;
* :mod:`.rules` -- ``Rule`` / ``Violation`` / ``Trace`` and the default
  rule registry (graph walks only: no model code);
* :mod:`.traces` -- registry config -> recorded ``Trace`` builders, and
  the hot-path walk behind the autotune sweep (``shape_requests``);
* :mod:`.baseline` -- the committed known-violation ledger and its
  regression diff;
* ``python -m repro_torch.launch.qlint`` -- the sweep CLI.
"""
from .rules import (DEFAULT_RULES, RULES_BY_NAME, Rule, Trace,
                    Violation, lint, run_rules)
from .baseline import diff, improvements, load, save, to_ledger

__all__ = [
    "DEFAULT_RULES", "RULES_BY_NAME", "Rule", "Trace", "Violation", "lint",
    "run_rules", "diff", "improvements", "load", "save", "to_ledger",
]
