"""Checkpoints and fault tolerance on one card (counterpart of the single
card part of the reference package's ``distributed``; the sharded parts
are ROADMAP Queue 1 item 13)."""
