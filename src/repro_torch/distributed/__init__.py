"""Distribution on the card (counterpart of the reference package's
``distributed``): the row sharding of a distributed table over a
single-controller mesh of segments (``sharding``), checkpoints and fault
tolerance on one card.  The LM's distribution (the rest of
``sharding``, ``compression``, ``decode``, ``ep_a2a``, ``pipeline``, the
heartbeat monitor and the elastic mesh plan) is ROADMAP Queue 1 item
13b."""
