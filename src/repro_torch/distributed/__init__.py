"""Distribution on a single-controller mesh (counterpart of the reference
package's ``distributed``): the row sharding of a distributed table and
the LM's logical shardings (``sharding``), split-K decode attention
(``decode``), the all-to-all MoE (``ep_a2a``), the GPipe schedule
(``pipeline``), int8 gradient compression (``compression``), checkpoints
that restore onto another mesh (``checkpoint``), and fault tolerance
(``fault_tolerance``)."""
