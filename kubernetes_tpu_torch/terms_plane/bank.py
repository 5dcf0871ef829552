"""Device-resident term bank: the TermStage slab's twin on the card.

The port of `kubernetes_tpu/terms_plane/bank.py`: a thin specialization of
the ingest plane's twin (ingest/bank.StageBank) — a full upload once and
after a slab rebuild, then the rows of fresh entries through one launch of
csrc/slab.cu's row scatter at the dispatch that needs them, in place (see
the StageBank docstring for why that is exact).
"""

from __future__ import annotations

from ..ingest.bank import StageBank


class TermBankDevice(StageBank):
    """Keeps a device copy of a TermStage slab patched from its dirty
    rows, sharing the slab's RLock."""

    NAME = "term_bank"
