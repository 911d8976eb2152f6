"""repro-lint for the port: the reference's invariant checker
(``repro/analysis/lint``) over ``repro_torch``, with the rules that apply
to it (R002, R004's torch form, R005, R006).

Pure stdlib: the CLI (``python -m repro_torch.analysis.lint``) needs only
``PYTHONPATH=src`` and a checkout.
"""

from repro_torch.analysis.lint.core import (FILE_ALLOWLIST, RULES, Violation, lint_paths,
                                            lint_source)
from repro_torch.analysis.lint.rules import (BACKEND_REQUIRED_ATTRS, ENGINE_REQUIRED_ATTRS,
                                             SIM_CLOCK_SCOPES)

__all__ = [
    "RULES", "Violation", "lint_paths", "lint_source", "FILE_ALLOWLIST",
    "ENGINE_REQUIRED_ATTRS", "BACKEND_REQUIRED_ATTRS", "SIM_CLOCK_SCOPES",
]
