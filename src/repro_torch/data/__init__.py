"""The LM data pipeline (counterpart of the reference package's
``data``)."""

from .pipeline import (
    TokenStream,
    corpus_profile,
    make_lm_batches,
    synthetic_batch,
)

__all__ = ["TokenStream", "corpus_profile", "make_lm_batches",
           "synthetic_batch"]
