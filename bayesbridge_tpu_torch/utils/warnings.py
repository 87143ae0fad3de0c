"""One-line warning formatting and warning helpers.

Mirrors the reference's warning plumbing (reference:
bayesbridge/util/simplify_warnings.py:4-11 and
reg_coef_sampler/hamiltonian_monte_carlo/util.py:13), except that we do NOT
monkey-patch the global ``warnings.formatwarning`` on import; callers opt in
via :func:`simplify_warning_format`.
"""

import warnings


def _one_line_format(message, category, filename, lineno, line=None):
    return "{:s}:{:d}: {:s}: {:s}\n".format(
        filename, lineno, category.__name__, str(message)
    )


def simplify_warning_format():
    """Install a compact one-line warning format process-wide (opt-in)."""
    warnings.formatwarning = _one_line_format


def warn_message_only(message, category=UserWarning):
    warnings.warn(message, category, stacklevel=2)
