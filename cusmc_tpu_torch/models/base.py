"""State-space model protocol helpers.

Port of ``cusmc_tpu/models/base.py:31`` (``supports_packed``). The rest of
the protocol (``CustomSSM``, time hooks) is not ported yet.
"""

from __future__ import annotations


def supports_packed(model) -> bool:
    return (hasattr(model, "sample_initial_packed")
            and hasattr(model, "propagate_packed")
            and hasattr(model, "observation_logpdf_packed"))
