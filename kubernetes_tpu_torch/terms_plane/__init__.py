"""Term-bank plane: each pod's topology terms interned once, at admission,
into a slab with a device-resident twin; a covered dispatch gathers the
batch's term table on the device from int32 index and owner vectors (the
port of `kubernetes_tpu/terms_plane`)."""

from .bank import TermBankDevice
from .gather import gather_terms, gather_terms_plain, term_problem
from .stage import MAX_CAPACITY, MIN_CAPACITY, TermEntry, TermStage

__all__ = ["TermBankDevice", "gather_terms", "gather_terms_plain", "term_problem", "MAX_CAPACITY", "MIN_CAPACITY",
           "TermEntry", "TermStage"]
